"""MNIST — the MLP and the LeNet-style conv sample, trained by the
unit-at-a-time graph (``python -m znicz_tpu_torch mnist``).

Counterpart of ``znicz_tpu/samples/mnist.py``: ``root.mnistr`` (the
MLP all2all_tanh 100 -> softmax 10, the loader at minibatch 60 with
"linear" normalization, the decision and the snapshotter),
``root.mnistr_conv`` (conv 64 5x5 -> max pool 2x2 -> conv 87 5x5 ->
max pool 2x2 -> all2all_relu 791 -> softmax 10) and
``root.mnistr_caffe`` (conv 20 -> pool -> conv 50 -> pool -> fc_relu
500 -> softmax), :class:`MnistWorkflow`, :func:`build`,
:func:`run_sample` and :func:`run`, the launcher contract.  As in the
JAX package, the CLI trains the MLP; a workflow file whose ``run``
calls ``load(mnist.build, layers=root.mnistr_conv.layers)`` trains
the conv topology.  The data is
:class:`~znicz_tpu_torch.loader.loader_mnist.MnistLoader`'s.
"""

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_mnist  # noqa: F401 (registers it)


root.mnistr.update({
    "decision": {"fail_iterations": 50, "max_epochs": 1000000000},
    "loss_function": "softmax",
    "loader_name": "mnist_loader",
    "snapshotter": {"prefix": "mnist", "interval": 1, "time_interval": 0,
                    "compression": ""},
    "loader": {"minibatch_size": 60, "normalization_type": "linear"},
    "layers": [
        {"name": "fc_tanh1",
         "type": "all2all_tanh",
         "->": {"output_sample_shape": 100,
                "weights_filling": "uniform", "weights_stddev": 0.05,
                "bias_filling": "uniform", "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.03, "weights_decay": 0.0,
                "learning_rate_bias": 0.03, "weights_decay_bias": 0.0,
                "gradient_moment": 0.0, "gradient_moment_bias": 0.0,
                "factor_ortho": 0.001}},
        {"name": "fc_softmax2",
         "type": "softmax",
         "->": {"output_sample_shape": 10,
                "weights_filling": "uniform", "weights_stddev": 0.05,
                "bias_filling": "uniform", "bias_stddev": 0.05},
         "<-": {"learning_rate": 0.03, "learning_rate_bias": 0.03,
                "weights_decay": 0.0, "weights_decay_bias": 0.0,
                "gradient_moment": 0.0, "gradient_moment_bias": 0.0}}],
})

#: the LeNet-style conv topology (the JAX sample's, from the reference's
#: mnist_conv_config.py)
root.mnistr_conv.update({
    "layers": [
        {"name": "conv1", "type": "conv",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5, "sliding": (1, 1),
                "weights_filling": "uniform",
                "weights_stddev": 0.0944569801138958,
                "bias_filling": "constant", "bias_stddev": 0.048000},
         "<-": {"learning_rate": 0.03, "learning_rate_bias": 0.358000,
                "gradient_moment": 0.36508255921752014,
                "gradient_moment_bias": 0.385000,
                "weights_decay": 0.0005,
                "weights_decay_bias": 0.1980997902551238,
                "factor_ortho": 0.001}},
        {"name": "pool1", "type": "max_pooling",
         "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}},
        {"name": "conv2", "type": "conv",
         "->": {"n_kernels": 87, "kx": 5, "ky": 5, "sliding": (1, 1),
                "weights_filling": "uniform", "weights_stddev": 0.067834,
                "bias_filling": "constant", "bias_stddev": 0.444372},
         "<-": {"learning_rate": 0.03, "learning_rate_bias": 0.381000,
                "gradient_moment": 0.115000, "gradient_moment_bias": 0.741000,
                "weights_decay": 0.0005, "weights_decay_bias": 0.039,
                "factor_ortho": 0.001}},
        {"name": "pool2", "type": "max_pooling",
         "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}},
        {"name": "fc_relu3", "type": "all2all_relu",
         "->": {"output_sample_shape": 791,
                "weights_filling": "uniform", "weights_stddev": 0.039858,
                "bias_filling": "constant", "bias_stddev": 1.000000},
         "<-": {"learning_rate": 0.03, "learning_rate_bias": 0.196000,
                "gradient_moment": 0.810000, "gradient_moment_bias": 0.619000,
                "weights_decay": 0.0005, "weights_decay_bias": 0.1162,
                "factor_ortho": 0.001}},
        {"name": "fc_softmax4", "type": "softmax",
         "->": {"output_sample_shape": 10,
                "weights_filling": "uniform", "weights_stddev": 0.024518,
                "bias_filling": "constant", "bias_stddev": 0.255735},
         "<-": {"learning_rate": 0.03, "learning_rate_bias": 0.488000,
                "gradient_moment": 0.133000, "gradient_moment_bias": 0.8422,
                "weights_decay": 0.0005, "weights_decay_bias": 0.476}}],
})

#: the LeNet-caffe variant (the reference's mnist_caffe_config.py)
_CAFFE_BWD = {"learning_rate": 0.01, "learning_rate_bias": 0.02,
              "weights_decay": 0.0005, "weights_decay_bias": 0,
              "gradient_moment": 0.9, "gradient_moment_bias": 0.9}
root.mnistr_caffe.update({
    "layers": [
        {"name": "conv1", "type": "conv",
         "->": {"n_kernels": 20, "kx": 5, "ky": 5, "sliding": (1, 1),
                "weights_filling": "uniform",
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CAFFE_BWD)},
        {"name": "pool1", "type": "max_pooling",
         "->": {"kx": 2, "ky": 2}},
        {"name": "conv2", "type": "conv",
         "->": {"n_kernels": 50, "kx": 5, "ky": 5, "sliding": (1, 1),
                "weights_filling": "uniform",
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CAFFE_BWD)},
        {"name": "pool2", "type": "max_pooling",
         "->": {"kx": 2, "ky": 2}},
        {"name": "fc_relu3", "type": "all2all_relu",
         "->": {"output_sample_shape": 500, "weights_filling": "uniform",
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CAFFE_BWD)},
        {"name": "fc_softmax4", "type": "softmax",
         "->": {"output_sample_shape": 10, "weights_filling": "uniform",
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CAFFE_BWD)}],
})


class MnistWorkflow(StandardWorkflow):
    """The digit-recognition workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`MnistWorkflow` from ``root.mnistr``, with the given
    config dicts merged over it; ``layers`` defaults to the MLP."""
    cfg = root.mnistr
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return MnistWorkflow(
        layers=layers if layers is not None else cfg.layers,
        loader_name=cfg.loader_name, loader_config=loader_cfg,
        decision_config=decision_cfg, snapshotter_config=snap_cfg,
        **kwargs)


def run_sample(device=None, conv=False, caffe=False, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train; ``conv`` / ``caffe`` pick those topologies."""
    if conv and caffe:
        raise ValueError("pick ONE of conv=True / caffe=True")
    if conv and "layers" not in kwargs:
        kwargs["layers"] = root.mnistr_conv.layers
    if caffe and "layers" not in kwargs:
        kwargs["layers"] = root.mnistr_caffe.layers
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch mnist``)."""
    load(build)
    main()


# --optimize trains a whole GA generation as one batched computation a
# step by default: the generic Range-site mapping in
# __main__.run_genetics finds root.mnistr itself, so this sample needs no
# population_evaluator of its own.
