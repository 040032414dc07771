"""ImageSaver — writes (misclassified) samples as images.

Counterpart of ``znicz_tpu/units/image_saver.py``.  With ``max_idx``
linked (a softmax workflow) only the misclassified samples of a
minibatch are written, as ``<label>_as_<prediction>.<index>``;
otherwise every sample, as ``<label>.<index>``; up to ``limit`` a
class (TEST, VALID, TRAIN, each in its own directory), the
directories emptied when a new epoch's samples start.
``StandardWorkflow.link_image_saver`` gates it on the decision's
``improved``.  PNG through PIL where it imports, else ``.npy``, as the
JAX unit does.  Reading ``max_idx`` (on the card) costs one copy from
the card a fire until the class's limit is reached.
"""

import os
import shutil

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit


class ImageSaver(Unit):
    """(reference image_saver.py:53-273)"""

    def __init__(self, workflow, **kwargs):
        super(ImageSaver, self).__init__(workflow, **kwargs)
        self.out_dirs = kwargs.get("out_dirs", [
            os.path.join(root.common.dirs.cache, "tmpimg/test"),
            os.path.join(root.common.dirs.cache, "tmpimg/validation"),
            os.path.join(root.common.dirs.cache, "tmpimg/train")])
        self.limit = kwargs.get("limit", 100)
        self.output = None
        self.target = None
        self.max_idx = None
        self._n_saved = [0, 0, 0]
        self._last_epoch = -1
        self.epoch_number = 0  # linked from the loader
        self.demand("input", "indices", "labels",
                    "minibatch_class", "minibatch_size")

    @staticmethod
    def as_image(inp):
        """Squeeze a sample into an (H, W[, 3]) float image or None
        (reference image_saver.py:97-113)."""
        inp = numpy.asarray(inp)
        if inp.ndim == 1:
            return None
        if inp.ndim == 2:
            return None if 1 in inp.shape else inp
        if inp.ndim == 3:
            if inp.shape[2] == 3:
                return inp
            if inp.shape[0] == 3:
                return inp.transpose(1, 2, 0)
            if inp.shape[2] == 4:
                return inp[:, :, :3]
            if inp.shape[2] == 1:
                return inp[:, :, 0]
        raise ValueError("cannot interpret sample of shape %s"
                         % (inp.shape,))

    def _indices_to_save(self):
        out = []
        for i in range(int(self.minibatch_size)):
            if self.max_idx is not None:
                if int(self.max_idx[i]) != int(self.labels[i]):
                    out.append(i)
            else:
                out.append(i)
        return out

    def _save_image(self, img, path):
        img = numpy.asarray(img, dtype=numpy.float64)
        lo, hi = img.min(), img.max()
        scaled = numpy.zeros_like(img) if hi == lo else \
            (img - lo) / (hi - lo)
        arr8 = (scaled * 255).astype(numpy.uint8)
        try:
            from PIL import Image
            Image.fromarray(arr8).save(path + ".png")
        except ImportError:
            numpy.save(path + ".npy", arr8)

    def reset(self):
        for d in self.out_dirs:
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
        self._n_saved = [0, 0, 0]

    def run(self):
        # new epoch (a new improvement, given the gate) -> fresh dump
        if int(self.epoch_number) != self._last_epoch:
            self.reset()
            self._last_epoch = int(self.epoch_number)
        klass = int(self.minibatch_class)
        if self._n_saved[klass] >= self.limit:
            return
        out_dir = self.out_dirs[klass]
        os.makedirs(out_dir, exist_ok=True)
        self.input.map_read()
        for i in self._indices_to_save():
            if self._n_saved[klass] >= self.limit:
                break
            img = self.as_image(self.input.mem[i])
            if img is None:
                continue
            label = int(self.labels[i])
            idx = int(self.indices[i])
            if self.max_idx is not None:
                pred = int(self.max_idx[i])
                name = "%d_as_%d.%d" % (label, pred, idx)
            else:
                name = "%d.%d" % (label, idx)
            self._save_image(img, os.path.join(out_dir, name))
            self._n_saved[klass] += 1
