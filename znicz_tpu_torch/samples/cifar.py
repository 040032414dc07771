"""CIFAR-10 — the reference's three CIFAR-10 configurations, trained by
either graph (``python -m znicz_tpu_torch cifar [--fused ...]``).

Counterpart of ``znicz_tpu/samples/cifar.py``: ``root.cifar`` (the
caffe config, the reference's ``cifar_caffe_config.py``: conv 32 5x5
pad 2 -> max pool 3x3/2 -> strict relu -> LRN -> conv 32 5x5 -> relu ->
avg pool 3x3/2 -> LRN -> conv 64 5x5 -> relu -> avg pool 3x3/2 ->
softmax 10, gaussian fillings, momentum 0.9, the ``arbitrary_step``
schedule, ``internal_mean`` normalization, minibatch 100; a published
17.21% validation error), ``root.cifar_mlp`` (``cifar_config.py``:
all2all 486 -> sincos, twice, -> softmax; 45.80%) and
``root.cifar_nin`` (``cifar_nin_config.py``: 5x5 convs each followed
by 1x1 stages, a global average pool; 9.09%), :class:`CifarWorkflow`
with the learning-rate adjuster, :func:`build`, :func:`build_variant`,
:func:`run_sample` and :func:`run`, the launcher contract.  The data
is :class:`~znicz_tpu_torch.loader.loader_cifar.CifarLoader`'s.
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_cifar  # noqa: F401 (registers it)


root.cifar.update({
    "decision": {"fail_iterations": 250, "max_epochs": 1000000000},
    "lr_adjuster": {"do": True, "lr_policy_name": "arbitrary_step",
                    "bias_lr_policy_name": "arbitrary_step",
                    "lr_parameters": {
                        "lrs_with_lengths":
                            [(1, 60000), (0.1, 5000), (0.01, 100000000)]},
                    "bias_lr_parameters": {
                        "lrs_with_lengths":
                            [(1, 60000), (0.1, 5000), (0.01, 100000000)]}},
    "snapshotter": {"prefix": "cifar_caffe", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loss_function": "softmax",
    "loader_name": "cifar_loader",
    "loader": {"minibatch_size": 100,
               "normalization_type": "internal_mean",
               "shuffle_limit": 2000000000},
    "layers": [
        {"name": "conv1", "type": "conv",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.0001,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": {"learning_rate": 0.001, "learning_rate_bias": 0.002,
                "weights_decay": 0.0005, "weights_decay_bias": 0.0005,
                "factor_ortho": 0.001, "gradient_moment": 0.9,
                "gradient_moment_bias": 0.9}},
        {"name": "pool1", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "relu1", "type": "activation_str"},
        {"name": "norm1", "type": "norm",
         "alpha": 0.00005, "beta": 0.75, "n": 3, "k": 1},
        {"name": "conv2", "type": "conv",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": {"learning_rate": 0.001, "learning_rate_bias": 0.002,
                "weights_decay": 0.0005, "weights_decay_bias": 0.0005,
                "factor_ortho": 0.001, "gradient_moment": 0.9,
                "gradient_moment_bias": 0.9}},
        {"name": "relu2", "type": "activation_str"},
        {"name": "pool2", "type": "avg_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "norm2", "type": "norm",
         "alpha": 0.00005, "beta": 0.75, "n": 3, "k": 1},
        {"name": "conv3", "type": "conv",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": {"learning_rate": 0.001, "learning_rate_bias": 0.001,
                "weights_decay": 0.0005, "weights_decay_bias": 0.0005,
                "factor_ortho": 0.001, "gradient_moment": 0.9,
                "gradient_moment_bias": 0.9}},
        {"name": "relu3", "type": "activation_str"},
        {"name": "pool3", "type": "avg_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "fc_softmax4", "type": "softmax",
         "->": {"output_sample_shape": 10,
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": {"learning_rate": 0.001, "learning_rate_bias": 0.002,
                "weights_decay": 1.0, "weights_decay_bias": 0,
                "gradient_moment": 0.9, "gradient_moment_bias": 0.9}}],
})


class CifarWorkflow(StandardWorkflow):
    """The CIFAR-10 workflow: ``StandardWorkflow`` with the
    learning-rate adjuster of ``lr_adjuster_config`` (``root.cifar.
    lr_adjuster`` by default) when its ``do`` is true
    (``link_lr_schedule``)."""

    def __init__(self, workflow=None, **kwargs):
        # read by create_workflow(), which super().__init__ calls
        self.lr_adjuster_cfg = kwargs.pop("lr_adjuster_config", None)
        super(CifarWorkflow, self).__init__(workflow, **kwargs)

    def create_workflow(self):
        super(CifarWorkflow, self).create_workflow()
        self.link_lr_schedule(self.lr_adjuster_cfg
                              if self.lr_adjuster_cfg is not None
                              else root.cifar.lr_adjuster.as_dict())


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`CifarWorkflow` from ``root.cifar``, with the given
    config dicts merged over it; ``layers`` defaults to the caffe
    topology."""
    cfg = root.cifar
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return CifarWorkflow(
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
    """The launcher contract (``python -m znicz_tpu_torch cifar``)."""
    load(build)
    main()


# --optimize trains a whole GA generation as one batched computation a
# step by default: the generic Range-site mapping in
# __main__.run_genetics finds root.cifar itself, so this sample needs no
# population_evaluator of its own.


#: the MLP (the reference's cifar_config.py)
root.cifar_mlp.update({
    "layers": [
        {"name": "fc_linear1", "type": "all2all",
         "->": {"output_sample_shape": 486},
         "<-": {"learning_rate": 0.0005, "weights_decay": 0.0}},
        {"name": "sincos1", "type": "activation_sincos"},
        {"name": "fc_linear2", "type": "all2all",
         "->": {"output_sample_shape": 486},
         "<-": {"learning_rate": 0.0005, "weights_decay": 0.0}},
        {"name": "sincos2", "type": "activation_sincos"},
        {"name": "fc_softmax3", "type": "softmax",
         "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.0005, "weights_decay": 0.0}}],
})


def _nin_conv(name, n_kernels, k, padding=(0, 0, 0, 0), stddev=0.05):
    return {"name": name, "type": "conv",
            "->": {"n_kernels": n_kernels, "kx": k, "ky": k,
                   "padding": padding, "sliding": (1, 1),
                   "weights_filling": "gaussian",
                   "weights_stddev": stddev,
                   "bias_filling": "constant", "bias_stddev": 0},
            "<-": {"learning_rate": 0.01, "learning_rate_bias": 0.02,
                   "weights_decay": 0.0001, "weights_decay_bias": 0,
                   "gradient_moment": 0.9, "gradient_moment_bias": 0.9}}


#: Network-in-Network (the reference's cifar_nin_config.py)
root.cifar_nin.update({
    "layers": [
        _nin_conv("conv1", 192, 5, (2, 2, 2, 2)),
        {"name": "relu1", "type": "activation_str"},
        _nin_conv("conv2", 160, 1),
        {"name": "relu2", "type": "activation_str"},
        _nin_conv("conv3", 96, 1),
        {"name": "relu3", "type": "activation_str"},
        {"name": "pool3", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "drop3", "type": "dropout", "dropout_ratio": 0.5},
        _nin_conv("conv4", 192, 5, (2, 2, 2, 2)),
        {"name": "relu4", "type": "activation_str"},
        _nin_conv("conv5", 192, 1),
        {"name": "relu5", "type": "activation_str"},
        _nin_conv("conv6", 192, 1),
        {"name": "relu6", "type": "activation_str"},
        {"name": "pool6", "type": "avg_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "drop6", "type": "dropout", "dropout_ratio": 0.5},
        _nin_conv("conv7", 192, 3, (1, 1, 1, 1)),
        {"name": "relu7", "type": "activation_str"},
        _nin_conv("conv8", 192, 1),
        {"name": "relu8", "type": "activation_str"},
        _nin_conv("conv9", 10, 1),
        {"name": "relu9", "type": "activation_str"},
        {"name": "pool9", "type": "avg_pooling",
         "->": {"kx": 8, "ky": 8, "sliding": (1, 1)}},
        {"name": "fc_softmax10", "type": "softmax",
         "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.0001,
                "gradient_moment": 0.9}}],
})

VARIANT_LAYERS = {
    "caffe": None,            # the default root.cifar.layers
    "mlp": "cifar_mlp",
    "nin": "cifar_nin",
}


def build_variant(variant, **kwargs):
    """Build one of the three configs: ``caffe`` (17.21%), ``mlp``
    (45.80%) or ``nin`` (9.09%).  The schedule and the snapshot prefix
    belong to the caffe config: the others train without an adjuster
    and snapshot as ``cifar_<variant>``."""
    ns = VARIANT_LAYERS[variant]
    if ns is not None and "layers" not in kwargs:
        kwargs["layers"] = getattr(root, ns).layers
    if variant != "caffe":
        kwargs.setdefault("lr_adjuster_config", {"do": False})
        snap = dict(kwargs.get("snapshotter_config") or {})
        snap.setdefault("prefix", "cifar_" + variant)
        kwargs["snapshotter_config"] = snap
    return build(**kwargs)
