"""MnistRBM — unsupervised RBM pretraining on MNIST
(``python -m znicz_tpu_torch mnist_rbm``).

Counterpart of ``znicz_tpu/samples/mnist_rbm.py``: ``root.mnist_rbm``
(a 784 -> 1000 Bernoulli RBM trained by CD-1, minibatch 128, learning
rate 0.01, 100 epochs, over the synthetic MNIST set's 1,000 TRAIN
rows, scaled into [0, 1]) and :class:`MnistRBMWorkflow`::

    repeater -> loader -> Binarization (v0) -> All2AllSigmoidH (h0)
      -> GradientRBM (v1, h1) -> BatchWeights (v0, h0)
      -> BatchWeights2 (v1, h1) -> GradientsCalculator -> WeightsUpdater
      -> EvaluatorRBM -> TrivialDecision -> (back to repeater) / end_point

The binarizations draw from their own seeded streams (1337, 2217 and
3317, as the JAX sample's), the weights and the evaluator's draws from
prng stream 1.  :meth:`MnistRBMWorkflow.reconstruction_mse`, then
:func:`run_sample` and :func:`run`, the launcher contract.
"""

import numpy

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Repeater
from znicz_tpu_torch.loader.loader_mnist import MnistLoader
from znicz_tpu_torch.units import rbm_units
from znicz_tpu_torch.units.decision import TrivialDecision

root.mnist_rbm.update({
    "rbm": {"h_size": 1000, "stddev": 0.05, "cd_k": 1,
            "learning_rate": 0.01},
    "decision": {"max_epochs": 100},
    "snapshotter": {"prefix": "mnist_rbm"},
    "loader": {"minibatch_size": 128, "synthetic_train": 1000,
               "synthetic_valid": 0,
               # Bernoulli binarization needs pixel probabilities in [0,1]
               "normalization_type": "range_linear",
               "normalization_parameters": {"interval": (0, 1)}},
})


class MnistRBMWorkflow(AcceleratedWorkflow):
    """The RBM's CD-k training loop with the reconstruction
    evaluator."""

    def __init__(self, workflow=None, **kwargs):
        super(MnistRBMWorkflow, self).__init__(workflow, **kwargs)
        cfg = root.mnist_rbm
        rbm_cfg = dict(cfg.rbm.as_dict(), **(kwargs.get("rbm_config") or {}))
        h_size = rbm_cfg["h_size"]

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        loader_cfg = cfg.loader.as_dict()
        loader_cfg.update(kwargs.get("loader_config") or {})
        self.loader = MnistLoader(self, name="loader", **loader_cfg)
        self.loader.link_from(self.repeater)

        # v0: the input binarized (Bernoulli over intensities in [0, 1])
        self.binarize = rbm_units.Binarization(
            self, rand=prng.RandomGenerator().seed(1337))
        self.binarize.link_from(self.loader)
        self.binarize.link_attrs(self.loader,
                                 ("input", "minibatch_data"),
                                 ("batch_size", "minibatch_size"))

        # h0 = sigmoid(v0 W^T + hbias); the weights live here
        self.hidden = rbm_units.All2AllSigmoidH(
            self, output_sample_shape=h_size,
            weights_stddev=rbm_cfg["stddev"],
            bias_stddev=rbm_cfg["stddev"])
        self.hidden.link_from(self.binarize)
        self.hidden.link_attrs(self.binarize, ("input", "output"))

        v_size = 28 * 28
        self.vbias = Array(numpy.zeros((1, v_size)), name="vbias")

        # the CD-k Gibbs chain -> v1, h1
        self.grad_rbm = rbm_units.GradientRBM(
            self, stddev=rbm_cfg["stddev"], cd_k=rbm_cfg["cd_k"],
            v_size=v_size, h_size=h_size,
            rand_h=prng.RandomGenerator().seed(2217),
            rand_v=prng.RandomGenerator().seed(3317))
        self.grad_rbm.link_from(self.hidden)
        self.grad_rbm.link_attrs(self.hidden, ("input", "output"),
                                 "weights", ("hbias", "bias"))
        self.grad_rbm.link_attrs(self, "vbias")
        self.grad_rbm.link_attrs(self.loader,
                                 ("batch_size", "minibatch_size"))

        # the positive and negative phases' statistics
        self.bw0 = rbm_units.BatchWeights(self, name="stats0")
        self.bw0.link_from(self.grad_rbm)
        self.bw0.link_attrs(self.binarize, ("v", "output"))
        self.bw0.link_attrs(self.hidden, ("h", "output"))
        self.bw0.link_attrs(self.loader, ("batch_size", "minibatch_size"))
        self.bw1 = rbm_units.BatchWeights2(self, name="stats1")
        self.bw1.link_from(self.bw0)
        self.bw1.link_attrs(self.grad_rbm, ("v", "v1"), ("h", "h1"))
        self.bw1.link_attrs(self.loader, ("batch_size", "minibatch_size"))

        self.grads = rbm_units.GradientsCalculator(self)
        self.grads.link_from(self.bw1)
        self.grads.link_attrs(self.bw0, ("hbias0", "hbias_batch"),
                              ("vbias0", "vbias_batch"),
                              ("weights0", "weights_batch"))
        self.grads.link_attrs(self.bw1, ("hbias1", "hbias_batch"),
                              ("vbias1", "vbias_batch"),
                              ("weights1", "weights_batch"))

        self.updater = rbm_units.WeightsUpdater(
            self, learning_rate=rbm_cfg["learning_rate"])
        self.updater.link_from(self.grads)
        self.updater.link_attrs(self.grads, "hbias_grad", "vbias_grad",
                                "weights_grad")
        self.updater.link_attrs(self.hidden, "weights",
                                ("hbias", "bias"))
        self.updater.link_attrs(self, "vbias")

        # the updated model's reconstruction error on this minibatch
        self.evaluator = rbm_units.EvaluatorRBM(self, bias_shape=v_size)
        self.evaluator.link_from(self.updater)
        self.evaluator.link_attrs(self.hidden, ("input", "output"),
                                  "weights")
        self.evaluator.link_attrs(self.binarize, ("target", "output"))
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))

        self.decision = TrivialDecision(
            self, name="decision",
            max_epochs=kwargs.get("max_epochs", cfg.decision.max_epochs))
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "minibatch_size",
                                 "class_lengths", "epoch_ended",
                                 "epoch_number")

        self.repeater.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.loader.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    def reconstruction_mse(self):
        """The mean per-sample reconstruction MSE of the last minibatch
        (one readback)."""
        m = self.evaluator.mse.mse
        bs = int(self.loader.minibatch_size)
        return float(numpy.mean(m.mem[:bs]))


def run_sample(device=None, **kwargs):
    wf = MnistRBMWorkflow(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract."""
    load(MnistRBMWorkflow)
    main()
