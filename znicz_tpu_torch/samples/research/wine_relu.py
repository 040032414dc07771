"""WineRelu — UCI Wine through the softplus "relu" layer
(``python -m znicz_tpu_torch research.wine_relu``).

Counterpart of ``znicz_tpu/samples/research/wine_relu.py``:
``root.wine_relu`` (all2all_relu 10 -> softmax 3, learning rate 0.03,
minibatch 10; a published 0.00% training error),
:class:`WineReluWorkflow`, :func:`build`, :func:`run_sample` and
:func:`run`, the launcher contract.  The data is
:class:`~znicz_tpu_torch.loader.loader_wine.WineLoader`'s.
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_wine  # noqa: F401 (registers it)

root.wine_relu.update({
    "decision": {"fail_iterations": 250, "max_epochs": 200},
    "snapshotter": {"prefix": "wine_relu", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader_name": "wine_loader",
    "loader": {"minibatch_size": 10},
    "layers": [
        {"name": "fc_relu1", "type": "all2all_relu",
         "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.03, "weights_decay": 0.0}},
        {"name": "fc_softmax2", "type": "softmax",
         "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.03, "weights_decay": 0.0}}],
})


class WineReluWorkflow(StandardWorkflow):
    """The WineRelu workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`WineReluWorkflow` from ``root.wine_relu``, with the
    given config dicts merged over it."""
    cfg = root.wine_relu
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    return WineReluWorkflow(
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
    research.wine_relu``)."""
    load(build)
    main()
