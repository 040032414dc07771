"""Mirrored host/device buffers.

Counterpart of ``znicz_tpu/core/memory.py`` (``Array`` :32): a host
numpy ``mem`` and a device tensor ``dev`` on an explicit
``torch.device``, with the reference's explicit, lazy crossings
``map_read`` / ``map_write`` / ``map_invalidate`` and ``set_dev`` for
a device "write".

States:
  HOST  — the host numpy copy is authoritative (device stale/absent)
  DEV   — the device tensor is authoritative (host stale/absent)
  SYNC  — both valid

While the profiler is armed, every upload, ``set_dev`` and ``reset``
accounts the device tensor's bytes in its memory ledger under the
Array's name (JAX :42-64, :135-153).

The helpers of JAX :25-31 and :225-269: :func:`roundup`, the host-view
reshapes :func:`reshape` and :func:`ravel`, :func:`interleave` (CHW to
HWC) and :class:`NumDiff`, the five-point numeric derivative of the
gradient checks.

The two sides never share memory.  A CUDA tensor's ``.cpu()`` is a
copy, but a CPU tensor's ``.numpy()`` and ``torch.from_numpy`` alias
their buffer, so on the CPU an in-place write to ``mem`` would
silently change ``dev`` (and the reverse) — an aliasing the card does
not have.  Every crossing therefore hands the other side a private
copy, on either device.
"""

import numpy
import torch

from znicz_tpu_torch.core import profiler
from znicz_tpu_torch.params import tree_map

HOST, DEV, SYNC = "host", "dev", "sync"


def roundup(n, m):
    """``n`` rounded up to a multiple of ``m``."""
    r = n % m
    return n if r == 0 else n + m - r


def _to_host(t):
    """A private host numpy copy of tensor ``t``."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


def _numpy_dtype(t):
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def host_fetch(tree):
    """Private host numpy copies of the tensors of a pytree, other
    leaves as they are.  The CUDA leaves cross in ONE device-to-host
    copy: their bytes are packed into one buffer on the card first, so
    a tree of accumulators and outputs costs one readback, not one a
    leaf."""
    leaves = []
    tree_map(lambda v: leaves.append(v) if isinstance(v, torch.Tensor)
             else None, tree)
    cuda = list({id(t): t for t in leaves
                 if t.device.type != "cpu"}.items())
    host = {}
    if cuda:
        packed = torch.cat([t.detach().contiguous().reshape(-1).view(
            torch.uint8) for _, t in cuda]).cpu().numpy()
        off = 0
        for key, t in cuda:
            n = t.numel() * t.element_size()
            host[key] = packed[off:off + n].view(_numpy_dtype(t)).reshape(
                tuple(t.shape)).copy()
            off += n

    def get(v):
        if not isinstance(v, torch.Tensor):
            return v
        return host[id(v)] if id(v) in host else _to_host(v)
    return tree_map(get, tree)


class Array(object):
    """A tensor mirrored between host numpy and a device tensor."""

    __slots__ = ("_host", "_dev", "_state", "name", "device", "_dev_nbytes")

    def __init__(self, data=None, name=None):
        self._host = None
        self._dev = None
        self._state = HOST
        self.name = name
        #: the ``torch.device`` an upload (:attr:`dev`) goes to
        self.device = None
        #: device bytes this Array has accounted in the profiler's
        #: memory ledger (0 while the profiler is off)
        self._dev_nbytes = 0
        if data is not None:
            self.mem = data

    def _ledger_swap(self, new_dev):
        """The device-memory ledger's hook, called only while the
        profiler is armed, at the three points ``_dev`` changes (upload,
        ``set_dev``, ``reset``)."""
        nbytes = 0 if new_dev is None else \
            new_dev.numel() * new_dev.element_size()
        profiler.ledger_swap(self.name, self._dev_nbytes, nbytes)
        self._dev_nbytes = nbytes

    def reset(self, arr=None):
        """Drop the current contents; optionally adopt a host array."""
        if self._dev is not None and profiler.enabled():
            self._ledger_swap(None)
        self._host = None if arr is None else numpy.asarray(arr)
        self._dev = None
        self._state = HOST
        return self

    @property
    def mem(self):
        """The host numpy array (pulled from the device if it is newer)."""
        self.map_read()
        return self._host

    @mem.setter
    def mem(self, value):
        if value is None:
            self.reset()
            return
        self._host = numpy.asarray(value)
        self._state = HOST

    # -- explicit mapping ---------------------------------------------------
    def map_read(self):
        if self._state == DEV:
            self._host = _to_host(self._dev)
            self._state = SYNC
        return self

    def map_write(self):
        """The host copy becomes authoritative (the device copy stale)."""
        self.map_read()
        if self._host is not None and not self._host.flags.writeable:
            self._host = numpy.array(self._host)
        self._state = HOST
        return self

    def map_invalidate(self):
        """The host will be overwritten wholesale; skip the download."""
        if self._host is None and self._dev is not None:
            self._host = numpy.empty(tuple(self._dev.shape),
                                     dtype=_numpy_dtype(self._dev))
        elif self._host is not None and not self._host.flags.writeable:
            self._host = numpy.empty_like(self._host)
        self._state = HOST
        return self

    # -- device side --------------------------------------------------------
    @property
    def dev(self):
        """The device tensor (uploaded to :attr:`device` if the host
        copy is newer), or None when the Array is empty."""
        if self._state == HOST:
            if self._host is None:
                return None
            if self.device is None:
                raise ValueError("Array %r has no device to upload to"
                                 % self.name)
            self._dev = torch.tensor(self._host, device=self.device)
            self._state = SYNC
            if profiler.enabled():
                self._ledger_swap(self._dev)
        return self._dev

    def set_dev(self, t):
        """Adopt tensor ``t`` as authoritative (a device 'write')."""
        if profiler.enabled():
            self._ledger_swap(t)
        self._dev = t
        self.device = t.device
        self._state = DEV
        return self

    @property
    def host_stale(self):
        """Whether only the device copy is current (reading ``mem``
        would copy from the device)."""
        return self._state == DEV

    # -- shape & views ------------------------------------------------------
    def __bool__(self):
        return self._host is not None or self._dev is not None

    @property
    def shape(self):
        if self._state == DEV:
            return tuple(self._dev.shape)
        if self._host is not None:
            return self._host.shape
        return None if self._dev is None else tuple(self._dev.shape)

    @property
    def size(self):
        """Number of elements (0 when empty)."""
        shape = self.shape
        n = 0 if shape is None else 1
        for d in shape or ():
            n *= int(d)
        return n

    @property
    def sample_size(self):
        """Elements of one sample (all axes but the first)."""
        return self.size // self.shape[0]

    @property
    def dtype(self):
        if self._state != DEV and self._host is not None:
            return self._host.dtype
        if self._dev is not None:
            return _numpy_dtype(self._dev)
        return None

    def __getitem__(self, idx):
        return self.mem[idx]

    def __repr__(self):
        return "<Array %s %s %s state=%s>" % (
            self.name or "", self.shape, self.dtype, self._state)


def reshape(arr, shape):
    """Reshape an Array's host copy in place; returns it."""
    arr.mem = arr.mem.reshape(shape)
    return arr.mem


def ravel(arr):
    """A flat view of an Array's host copy."""
    return arr.mem.reshape(-1)


def interleave(arr):
    """A CHW image (or an NCHW batch) as HWC (NHWC)."""
    if arr.ndim == 3:
        return numpy.transpose(arr, (1, 2, 0))
    if arr.ndim == 4:
        return numpy.transpose(arr, (0, 2, 3, 1))
    raise ValueError("interleave expects 3D/4D")


class NumDiff(object):
    """The five-point numeric derivative (float64 only): fill
    :attr:`errs` with the function at ``x + p * h`` for each ``p`` of
    :attr:`points`, then read :attr:`derivative`."""

    #: the perturbations, in units of :attr:`h`
    points = (2.0, 1.0, -1.0, -2.0)
    #: the stencil's coefficients, over ``divizor * h``
    coeffs = numpy.array([-1.0, 8.0, -8.0, 1.0], dtype=numpy.float64)
    divizor = 12.0
    h = 1.0e-4

    def __init__(self):
        self.errs = numpy.zeros(len(NumDiff.points), dtype=numpy.float64)

    @property
    def derivative(self):
        return (self.errs * NumDiff.coeffs).sum() / (
            NumDiff.divizor * NumDiff.h)
