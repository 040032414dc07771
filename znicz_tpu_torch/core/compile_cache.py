"""The compile cache: the kernels' libraries, built once for a fleet.

Counterpart of ``znicz_tpu/core/compile_cache.py``.  The JAX package
points XLA's persistent compilation cache at a directory, so that a
replica after the first loads its executables instead of compiling
them.  PyTorch compiles nothing per shape here; what a cold process
compiles is the port's kernel libraries, one ``nvcc`` a CUDA source
(:mod:`znicz_tpu_torch.ops.cuda_build`).  So the cache is the directory
those libraries are built into and loaded from: enabled, ``cuda_build``
uses :func:`active_dir` in place of ``build/znicz_tpu_torch/``, and a
library already there under its name (a hash of its source and flags)
is loaded, not built.  A "fresh compile" is an ``nvcc`` build:
:class:`watch` counts them from ``cuda_build.BUILT``.

Off by default (``root.common.compile_cache.enabled``); ``serve
--compile-cache [DIR]`` enables it, and a fleet's replicas get the same
flag, so the first builds and every later one loads.  Under an enabled
cache a server on the card builds (or loads) every kernel library
before it serves.
"""

import glob
import os

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root

_lock = locksmith.lock("compile_cache")
#: the active cache directory (None: the libraries live under
#: ``build/znicz_tpu_torch/``)
_dir = None


def configured_dir():
    """The directory config selects: ``root.common.compile_cache.dir``
    or ``<root.common.dirs.cache>/kernel_cache``."""
    explicit = root.common.compile_cache.get("dir", None)
    if explicit:
        return os.fspath(explicit)
    return os.path.join(root.common.dirs.cache, "kernel_cache")


def enabled():
    """True once :func:`enable` set a cache directory."""
    return _dir is not None


def active_dir():
    return _dir


def enable(cache_dir=None):
    """Build and load the kernel libraries in ``cache_dir`` (default:
    :func:`configured_dir`), made absolute and created.  Calling it again
    with another directory moves the cache.  Returns the directory."""
    global _dir
    with _lock:
        d = os.path.abspath(os.fspath(cache_dir) if cache_dir
                            else configured_dir())
        os.makedirs(d, exist_ok=True)
        _dir = d
    telemetry.record_event("compile_cache.enable", dir=d)
    return d


def disable():
    """Back to ``build/znicz_tpu_torch/`` (tests)."""
    global _dir
    with _lock:
        _dir = None


def maybe_enable():
    """Honour ``root.common.compile_cache.enabled``; returns the
    directory or None."""
    if root.common.compile_cache.get("enabled", False):
        return enable()
    return None


def _counter_values():
    from znicz_tpu_torch.ops import cuda_build
    return {"libraries_built": cuda_build.BUILT,
            "libraries_loaded": cuda_build.LOADED}


class watch(object):
    """The build counters at construction; :meth:`fresh_compiles` is the
    number of libraries ``nvcc`` built since (each a library the cache
    did not hold)."""

    def __init__(self):
        self._at = _counter_values()

    def delta(self):
        now = _counter_values()
        return {k: int(now[k] - self._at[k]) for k in now}

    def fresh_compiles(self):
        return self.delta()["libraries_built"]


def stats():
    """The cache's state, the ``compile_cache`` block of ``/statusz``
    and of the registry's stats: ``enabled``, ``dir``, the ``.so``
    libraries there (``entries``, ``bytes``) and this process's
    ``libraries_built`` / ``libraries_loaded``."""
    out = {"enabled": enabled(), "dir": _dir}
    if _dir and os.path.isdir(_dir):
        entries = [p for p in glob.glob(os.path.join(_dir, "*.so"))
                   if os.path.isfile(p)]
        out["entries"] = len(entries)
        out["bytes"] = sum(os.path.getsize(p) for p in entries)
    out.update(_counter_values())
    return out
