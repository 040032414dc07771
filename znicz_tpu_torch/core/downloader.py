"""Downloader — fetch and unpack a dataset once.

Counterpart of ``znicz_tpu/core/downloader.py``: given a ``url`` and a
target ``directory``, the unit fetches the file once, unpacks a tar or
zip archive, and does nothing when the expected ``files`` are already
there (missing files and no ``url`` raise ``ValueError``).  Link it
from the start point, before the loader.
"""

import os
import shutil
import tarfile
import urllib.request
import zipfile

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit


class Downloader(Unit):
    """kwargs: ``url``, ``directory`` (default <cache>/datasets),
    ``files`` (iterable of paths relative to directory whose existence
    skips the download)."""

    def __init__(self, workflow, **kwargs):
        super(Downloader, self).__init__(workflow, **kwargs)
        self.url = kwargs.get("url")
        self.directory = kwargs.get("directory")
        self.files = tuple(kwargs.get("files", ()))

    def initialize(self, device=None, **kwargs):
        super(Downloader, self).initialize(device=device, **kwargs)
        if not self.directory:
            self.directory = os.path.join(root.common.dirs.cache,
                                          "datasets")

    @property
    def satisfied(self):
        return self.files and all(
            os.path.exists(os.path.join(self.directory, f))
            for f in self.files)

    def run(self):
        if self.satisfied:
            self.debug("all files present under %s", self.directory)
            return
        if not self.url:
            raise ValueError(
                "missing files under %s and no url to fetch them from: %s"
                % (self.directory, ", ".join(self.files)))
        os.makedirs(self.directory, exist_ok=True)
        name = os.path.basename(self.url.rstrip("/")) or "download"
        dest = os.path.join(self.directory, name)
        if not os.path.exists(dest):
            self.info("downloading %s -> %s", self.url, dest)
            with urllib.request.urlopen(self.url) as r, \
                    open(dest + ".part", "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(dest + ".part", dest)
        self._extract(dest)
        if self.files and not self.satisfied:
            missing = [f for f in self.files if not os.path.exists(
                os.path.join(self.directory, f))]
            raise RuntimeError("downloaded %s but still missing: %s"
                               % (self.url, ", ".join(missing)))

    def _extract(self, dest):
        if tarfile.is_tarfile(dest):
            self.info("extracting tar %s", dest)
            with tarfile.open(dest) as t:
                t.extractall(self.directory, filter="data")
        elif zipfile.is_zipfile(dest):
            self.info("extracting zip %s", dest)
            with zipfile.ZipFile(dest) as z:
                z.extractall(self.directory)
