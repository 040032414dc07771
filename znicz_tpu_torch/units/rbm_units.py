"""Bernoulli RBM units — contrastive divergence from composable units.

Counterpart of ``znicz_tpu/units/rbm_units.py``: ``Binarization``
(:35, Bernoulli sampling in the reference's ``matlab_binornd`` draw
order), ``IterationCounter`` (:74), ``BatchWeights`` /
``BatchWeights2`` (:96, the batch-averaged v-h correlation and biases),
``GradientsCalculator`` (:136, data statistics less model statistics),
``WeightsUpdater`` (:171), ``MemCpy`` (:192), the
``All2AllSigmoid{H,V,WithForeignWeights}`` and
``Binarization{GradH,GradV,Eval}`` aliases, ``GradientRBM`` (:233, the
CD-k Gibbs chain as a sub-workflow) and ``EvaluatorRBM`` (:299, the
reconstruction MSE).

The uniforms of a Bernoulli draw come from the unit's host stream
(``rand``, a :class:`~znicz_tpu_torch.core.prng.RandomGenerator`), in
the reference's transposed order, so the port draws the JAX package's
numbers bit for bit; they are uploaded and compared with the
probabilities on the device in float64, as numpy promotes the
comparison.  The draw needs no device data: it costs an upload and no
readback.  The batch statistics, the gradients and the update run on
the device, where JAX runs them as host numpy.
"""

import numpy
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import (AcceleratedUnit,
                                                    AcceleratedWorkflow)
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.normalization import NoneNormalizer
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Repeater
from znicz_tpu_torch.units.all2all import All2AllSigmoid
from znicz_tpu_torch.units.evaluator import EvaluatorMSE


def _torch_dtype(np_dtype):
    return torch.from_numpy(numpy.zeros(0, np_dtype)).dtype


class Binarization(AcceleratedUnit):
    """``B(i, j) ~ Bernoulli(A(i, j))`` over the first ``batch_size``
    rows; the other rows are copied."""

    def __init__(self, workflow, **kwargs):
        super(Binarization, self).__init__(workflow, **kwargs)
        self.output = Array(name="output")
        self.rand = kwargs.get("rand", prng.get())
        self.demand("input", "batch_size")

    def matlab_binornd(self, n, p):
        """The number of successes in ``n`` Bernoulli trials of each
        probability of the 1-D or 2-D tensor ``p``: ``n`` uniforms an
        element from :attr:`rand`, a 2-D ``p`` drawn column by column
        (the reference's order)."""
        if p.dim() == 2:
            nrow, ncol = p.shape
            u = self._upload(self.rand.rand(n, nrow * ncol), p.device)
            u = u.reshape(n, ncol, nrow).transpose(1, 2)
        elif p.dim() == 1:
            u = self._upload(self.rand.rand(n, p.shape[0]), p.device)
        else:
            raise ValueError("Binarization input must be 1D or 2D")
        return (u < p.to(torch.float64)).sum(dim=0)

    @staticmethod
    def _upload(f, device):
        """The uniforms on ``device``: to the card through pinned memory
        and an asynchronous copy, which does not wait for the card."""
        u = torch.from_numpy(f)
        if device.type == "cuda":
            u = u.pin_memory().to(device, non_blocking=True)
        return u

    def initialize(self, device=None, **kwargs):
        super(Binarization, self).initialize(device=device, **kwargs)
        if not self.output or self.output.size != self.input.size:
            # flat (n_samples, sample_size) rows, whatever the loader's
            # sample shape
            self.output.reset(numpy.zeros(
                (self.input.shape[0], self.input.sample_size),
                dtype=self.input.dtype))
        self.output.device = self.device
        self._dtype = _torch_dtype(self.output.dtype)

    def run(self):
        inp = self.input.dev
        inp = inp.reshape(inp.shape[0], -1)
        bs = int(self.batch_size)
        out = inp.to(self._dtype, copy=True)
        out[:bs] = self.matlab_binornd(1, inp[:bs]).to(self._dtype)
        self.output.set_dev(out)


class IterationCounter(Unit):
    """Counts the runs; ``complete`` once past ``max_iterations``."""

    def __init__(self, workflow, **kwargs):
        super(IterationCounter, self).__init__(workflow, **kwargs)
        self.max_iterations = kwargs["max_iterations"]
        self.iteration = 0
        self.complete = Bool(False)

    def reset(self):
        self.iteration = 0
        self.complete <<= self.iteration > self.max_iterations

    def initialize(self, device=None, **kwargs):
        super(IterationCounter, self).initialize(device=device, **kwargs)
        self.complete <<= self.iteration > self.max_iterations

    def run(self):
        self.iteration += 1
        self.complete <<= self.iteration > self.max_iterations


class BatchWeights(AcceleratedUnit):
    """``weights_batch = v^T h / bs``, ``vbias_batch`` and
    ``hbias_batch`` the column means, over the first ``batch_size``
    rows."""

    def __init__(self, workflow, **kwargs):
        super(BatchWeights, self).__init__(workflow, **kwargs)
        self.vbias_batch = Array(name="vbias_batch")
        self.hbias_batch = Array(name="hbias_batch")
        self.weights_batch = Array(name="weights_batch")
        self.demand("v", "h", "batch_size")

    def initialize(self, device=None, **kwargs):
        super(BatchWeights, self).initialize(device=device, **kwargs)
        vsize = self.v.sample_size
        hsize = self.h.sample_size
        if not self.hbias_batch:
            self.hbias_batch.reset(numpy.zeros((1, hsize), self.h.dtype))
        if not self.vbias_batch:
            self.vbias_batch.reset(numpy.zeros((1, vsize), self.h.dtype))
        if not self.weights_batch:
            self.weights_batch.reset(numpy.zeros((vsize, hsize),
                                                 self.h.dtype))
        for arr in (self.vbias_batch, self.hbias_batch, self.weights_batch):
            arr.device = self.device

    def run(self):
        bs = int(self.batch_size)
        v = self.v.dev[:bs]
        h = self.h.dev[:bs]
        self.weights_batch.set_dev(v.T @ h / bs)
        self.vbias_batch.set_dev((v.sum(dim=0) / bs).reshape(1, -1))
        self.hbias_batch.set_dev((h.sum(dim=0) / bs).reshape(1, -1))


class BatchWeights2(BatchWeights):
    """The negative phase's statistics (a second class, as the
    reference's link aliasing wants)."""


class GradientsCalculator(AcceleratedUnit):
    """The CD gradient: data statistics less model statistics."""

    def __init__(self, workflow, **kwargs):
        super(GradientsCalculator, self).__init__(workflow, **kwargs)
        self.vbias_grad = Array(name="vbias_grad")
        self.hbias_grad = Array(name="hbias_grad")
        self.weights_grad = Array(name="weights_grad")
        self.demand("hbias1", "vbias1", "hbias0", "vbias0", "weights0",
                    "weights1")

    def initialize(self, device=None, **kwargs):
        super(GradientsCalculator, self).initialize(device=device, **kwargs)
        for grad, src in ((self.hbias_grad, self.hbias0),
                          (self.vbias_grad, self.vbias0),
                          (self.weights_grad, self.weights0)):
            if not grad:
                grad.reset(numpy.zeros(src.shape, src.dtype))
            grad.device = self.device

    def run(self):
        for grad, a, b in ((self.vbias_grad, self.vbias0, self.vbias1),
                           (self.hbias_grad, self.hbias0, self.hbias1),
                           (self.weights_grad, self.weights0,
                            self.weights1)):
            grad.set_dev(a.dev - b.dev)


class WeightsUpdater(Unit):
    """``w += lr * grad`` (the weights' gradient transposed), on the
    parameters' device."""

    def __init__(self, workflow, **kwargs):
        super(WeightsUpdater, self).__init__(workflow, **kwargs)
        self.learning_rate = kwargs["learning_rate"]
        self.demand("hbias_grad", "vbias_grad", "weights_grad",
                    "weights", "hbias", "vbias")

    def run(self):
        lr = self.learning_rate
        for param, grad in ((self.weights, self.weights_grad.dev.T),
                            (self.hbias, self.hbias_grad.dev),
                            (self.vbias, self.vbias_grad.dev)):
            w = param.dev
            param.set_dev(w + lr * grad.reshape(w.shape))


class MemCpy(AcceleratedUnit):
    """``output = copy(input)``."""

    def __init__(self, workflow, **kwargs):
        super(MemCpy, self).__init__(workflow, **kwargs)
        self.output = Array(name="output")
        self.demand("input")

    def initialize(self, device=None, **kwargs):
        super(MemCpy, self).initialize(device=device, **kwargs)
        if not self.output or self.output.shape != self.input.shape:
            self.output.reset(numpy.zeros_like(self.input.mem))
        self.output.device = self.device

    def run(self):
        self.output.set_dev(self.input.dev.clone())


class All2AllSigmoidH(All2AllSigmoid):
    """The hidden layer (an alias kept out of the layer registry)."""
    MAPPING = set()
    hide_from_registry = True


class All2AllSigmoidV(All2AllSigmoid):
    """The visible layer (an alias kept out of the layer registry)."""
    MAPPING = set()
    hide_from_registry = True


class BinarizationGradH(Binarization):
    pass


class BinarizationGradV(Binarization):
    pass


class GradientRBM(AcceleratedWorkflow):
    """CD-k Gibbs sampling built from units: from the hidden
    probabilities ``input``, k rounds of h -> binarize -> v -> binarize
    -> h; ``v1`` is the last binarized visible sample, ``h1`` (and
    ``output``) the last hidden probabilities."""

    def __init__(self, workflow, **kwargs):
        super(GradientRBM, self).__init__(workflow, **kwargs)
        self.stddev = kwargs["stddev"]
        self.batch_size = -1
        self.mem_cpy = MemCpy(self)
        self.mem_cpy.link_from(self.start_point)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.mem_cpy)
        self.decision = IterationCounter(self,
                                         max_iterations=kwargs["cd_k"])
        self.decision.link_from(self.repeater)
        self.bino_h = BinarizationGradH(
            self, rand=kwargs.get("rand_h", prng.get()))
        self.bino_h.link_attrs(self.mem_cpy, ("input", "output"))
        self.bino_h.link_from(self.decision)
        self.bino_h.gate_block = self.decision.complete
        self.make_v = All2AllSigmoidV(
            self, weights_stddev=self.stddev, weights_transposed=True,
            output_sample_shape=kwargs["v_size"])
        self.make_v.link_from(self.bino_h)
        self.make_v.link_attrs(self.bino_h, ("input", "output"))
        self.bino_v = BinarizationGradV(
            self, rand=kwargs.get("rand_v", prng.get()))
        self.bino_v.link_attrs(self.make_v, ("input", "output"))
        self.bino_v.link_from(self.make_v)
        self.make_h = All2AllSigmoidH(
            self, weights_stddev=self.stddev,
            output_sample_shape=kwargs["h_size"])
        self.make_h.link_attrs(self.bino_v, ("input", "output"))
        self.make_h.output = self.mem_cpy.output
        self.make_h.link_from(self.bino_v)
        self.repeater.link_from(self.make_h)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

        self.mem_cpy.link_attrs(self, "input")
        self.bino_h.link_attrs(self, "batch_size")
        self.bino_v.link_attrs(self, "batch_size")
        self.make_v.link_attrs(self, "weights")
        self.make_v.link_attrs(self, ("bias", "vbias"))
        self.make_h.link_attrs(self, "weights")
        self.make_h.link_attrs(self, ("bias", "hbias"))
        self.link_attrs(self.make_h, "output")
        self.link_attrs(self.bino_v, ("v1", "output"))
        self.link_attrs(self.make_h, ("h1", "output"))
        self.demand("input", "weights", "hbias", "vbias", "batch_size")

    def run(self):
        self.decision.reset()
        return super(GradientRBM, self).run()


class All2AllSigmoidWithForeignWeights(All2AllSigmoid):
    """The reconstruction layer on the RBM's weights (an alias kept out
    of the layer registry)."""
    MAPPING = set()
    hide_from_registry = True


class BinarizationEval(Binarization):
    pass


class EvaluatorRBM(AcceleratedWorkflow):
    """The reconstruction MSE: the hidden probabilities ``input``
    binarized, mapped back through the weights, against ``target``."""

    def __init__(self, workflow, **kwargs):
        super(EvaluatorRBM, self).__init__(workflow, **kwargs)
        self.binarization = BinarizationEval(
            self, rand=kwargs.get("rand", prng.get()))
        self.binarization.link_from(self.start_point)
        self.rec = All2AllSigmoidWithForeignWeights(
            self, output_sample_shape=kwargs["bias_shape"],
            weights_transposed=True)
        self.rec.link_from(self.binarization)
        self.rec.link_attrs(self.binarization, ("input", "output"))
        self.mse = EvaluatorMSE(self, root=False, mean=False)
        self.mse.link_from(self.rec)
        self.mse.link_attrs(self.rec, "output")
        self.mse.normalizer = NoneNormalizer()
        self.end_point.link_from(self.mse)

        self.binarization.link_attrs(self, "input", "batch_size")
        self.rec.link_attrs(self, "weights")
        self.mse.link_attrs(self, "target", "batch_size")
        self.link_attrs(self.rec, ("vbias", "bias"))
        self.demand("input", "weights", "target")

    @property
    def output(self):
        return self.vbias
