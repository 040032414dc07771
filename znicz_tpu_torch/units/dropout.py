"""Dropout units.

Counterpart of ``znicz_tpu/units/dropout.py`` (``DropoutForward`` /
``DropoutBackward`` :36-121).  The forward multiplies by a mask of
``ceil(max(u - ratio, 0)) / (1 - ratio)`` with ``u`` uniform in
[0, 1) — Bernoulli(1 - ratio) scaled, the JAX package's formula —
drawn anew on each TRAIN minibatch; VALID / TEST minibatches and
``forward_mode`` pass through.  The backward multiplies err by the
same mask.  The JAX package draws ``u`` on the host from its prng
stream; here it comes from the unit's own ``torch.Generator`` on the
device, seeded with the CRC-32 of the unit's name (so two dropout
layers draw apart), so the masks differ from the JAX
package's and the tests hand both the same one.  The mask and the
generator's state ride snapshots, as the fused trainer's dropout
stream does, so a resumed run draws the masks the uninterrupted one
draws.  ``DropoutFixer`` (JAX :123) sets every dropout forward's
``forward_mode`` of a workflow at once.
"""

import zlib

import numpy
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.units.nn_units import Forward, GradientDescentBase


class Dropout(object):
    """The carrier of ``dropout_ratio``."""

    def init_ratio(self, kwargs):
        self.dropout_ratio = kwargs.get("dropout_ratio")

    @property
    def dropout_ratio(self):
        return self._dropout_ratio

    @dropout_ratio.setter
    def dropout_ratio(self, value):
        if value is not None and not 0 < value < 1:
            raise ValueError("dropout_ratio must be in (0, 1)")
        self._dropout_ratio = value


class DropoutForward(Dropout, Forward):
    """The masking forward."""

    MAPPING = {"dropout"}
    #: the mask and the generator state resume a run; no served forward
    #: reads them
    RESUME_ONLY = ("mask", "generator_state")

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.init_ratio(kwargs)
        self.mask = Array(name="mask")
        self.generator = None
        self.demand("minibatch_class")
        self.weights.reset()
        self.bias.reset()
        self.include_bias = False
        self.exports.extend(("mask", "generator_state"))

    def initialize(self, device=None, **kwargs):
        super(DropoutForward, self).initialize(device=device, **kwargs)
        if self.dropout_ratio is None:
            raise ValueError("dropout_ratio must be set")
        self.mask.reset(numpy.zeros(self.input.shape, self.input.dtype))
        self.mask.device = self.device
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(numpy.zeros(self.input.shape,
                                          self.input.dtype))
        self.generator = torch.Generator(device=self.device).manual_seed(
            zlib.crc32(self.name.encode()))

    @property
    def generator_state(self):
        return self.generator.get_state().numpy()

    @generator_state.setter
    def generator_state(self, value):
        self.generator.set_state(torch.from_numpy(numpy.array(
            value, dtype=numpy.uint8)))

    def calc_mask(self):
        """A new mask on the device from the unit's generator."""
        x = self.input.dev
        u = torch.rand(x.shape, generator=self.generator, dtype=x.dtype,
                       device=x.device)
        leave = 1.0 - self.dropout_ratio
        self.mask.set_dev(torch.ceil(torch.clamp(
            u - self.dropout_ratio, min=0)) / leave)

    @property
    def _active(self):
        return not self.forward_mode and int(self.minibatch_class) == TRAIN

    def run(self):
        if self._active:
            self.calc_mask()
            self.output.set_dev(self.input.dev * self.mask.dev)
        else:
            self.output.set_dev(self.input.dev)


class DropoutBackward(Dropout, GradientDescentBase):
    """err times the forward's mask on TRAIN minibatches."""

    MAPPING = {"dropout"}

    def __init__(self, workflow, **kwargs):
        super(DropoutBackward, self).__init__(workflow, **kwargs)
        self.init_ratio(kwargs)
        self.demand("mask", "minibatch_class")

    def run(self):
        err = self.err_output.dev
        if int(self.minibatch_class) == TRAIN:
            err = err * self.mask.dev
        self.err_input.set_dev(err)


class DropoutFixer(object):
    """Sets ``forward_mode`` on every :class:`DropoutForward` of a
    workflow (inference passes the input through)."""

    def __init__(self, workflow):
        self._workflow = workflow

    def fix(self, forward_mode=True):
        for unit in self._workflow.units:
            if isinstance(unit, DropoutForward):
                unit.forward_mode = forward_mode
