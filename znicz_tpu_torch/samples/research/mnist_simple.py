"""MnistSimple — the tuned one-hidden-layer MNIST MLP
(``python -m znicz_tpu_torch research.mnist_simple``).

Counterpart of ``znicz_tpu/samples/research/mnist_simple.py``:
``root.mnist_simple`` (all2all_tanh 364 -> softmax 10, the
GA-tuned learning rate, weights decay and ``factor_ortho``, "linear"
normalization, minibatch 88; a published 1.48% validation error),
:class:`MnistSimpleWorkflow`, :func:`build`, :func:`run_sample` and
:func:`run`, the launcher contract.  The data is
:class:`~znicz_tpu_torch.loader.loader_mnist.MnistLoader`'s.
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_mnist  # noqa: F401 (registers it)

root.mnist_simple.update({
    "decision": {"fail_iterations": 300, "max_epochs": 1000},
    "snapshotter": {"prefix": "mnist_simple", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader_name": "mnist_loader",
    "loader": {"minibatch_size": 88, "normalization_type": "linear"},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 364, "weights_stddev": 0.05,
                "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.028557478339518444,
                "weights_decay": 0.00012315096341168246,
                "factor_ortho": 0.001}},
        {"name": "fc_softmax2", "type": "softmax",
         "->": {"output_sample_shape": 10, "weights_stddev": 0.05,
                "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.028557478339518444,
                "weights_decay": 0.00012315096341168246}}],
})


class MnistSimpleWorkflow(StandardWorkflow):
    """The MnistSimple workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`MnistSimpleWorkflow` from ``root.mnist_simple``, with
    the given config dicts merged over it."""
    cfg = root.mnist_simple
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    return MnistSimpleWorkflow(
        layers=layers if layers is not None else cfg.layers,
        loader_name=cfg.loader_name, loader_config=loader_cfg,
        decision_config=decision_cfg, snapshotter_config=snap_cfg,
        **kwargs)


def run_sample(device=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train."""
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch
    research.mnist_simple``)."""
    load(build)
    main()
