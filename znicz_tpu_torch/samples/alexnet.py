"""AlexNet — the heaviest model of the zoo: served as a deployment
package made from a seed, and trained by the workflow CLI through the
unit-at-a-time graph (``python -m znicz_tpu_torch alexnet``: a forward
unit and a GD unit a layer, the four ``zero_filter`` units masking the
next layer's weights before each forward, TRAIN and VALID) or the fused
graph (``--fused``).

Counterpart of ``znicz_tpu/samples/research/alexnet.py``
(``make_layers`` :27, a copy): conv_str 96 11x11 s4 -> max_pool 3x3 s2
-> LRN -> ZeroFiller(grouping 2) -> conv_str 256 5x5 pad 2 -> pool ->
LRN -> ZeroFiller -> conv_str 384 3x3 pad 1 -> conv_str 384 ->
ZeroFiller -> conv_str 256 -> pool -> ZeroFiller -> fc 4096 -> str ->
dropout -> fc 4096 -> str -> dropout -> softmax 1000, on a 227x227x3
input: about 62 M float32 parameters.

:func:`init_package` builds the ``(manifest, arrays)`` pair that
``znicz_tpu.export.export_package`` writes for a freshly initialised
network: gaussian weights with each layer's stddev, constant biases,
and every ``zero_filter`` grouping mask folded into the next layer's
weights with the ZeroFiller formula ``mask = (k % g) != (c % g)``
(``znicz_tpu/units/zerofilling.py:58-65``), the mask kept beside them
as provenance.  Everything is drawn from a
:class:`~znicz_tpu_torch.core.prng.RandomGenerator` seeded with
``seed``, through the fill rules of :mod:`znicz_tpu_torch.ops.init`;
no weights are downloaded.

:func:`synthetic_images` makes the sample's training data: the
prototype-class images of ``SyntheticImagenetLoader.load_data``
(``znicz_tpu/samples/research/alexnet.py:109``) with the loader's
"linear" normalization.

The training workflow is the JAX sample's: ``SyntheticImagenetLoader``
(the same rows from the same ``RandomState(0x1337)`` recipe), the
``root.alexnet`` config, :class:`AlexNetWorkflow`, :func:`build` and
:func:`run`, the launcher contract, in either graph.  As in the JAX
sample, the config's ``lr_adjuster`` block is written but not linked
(``znicz_tpu/samples/research/alexnet.py:145-163``): every run trains
at the base rates.  The loader's label count (10) sets the softmax
head's width; every hidden width is the published one.
"""

import numpy

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.normalization import LinearNormalizer
from znicz_tpu_torch.export import PACKAGE_FORMAT, serving_manifest
from znicz_tpu_torch.loader.base import (FullBatchLoader, IFullBatchLoader,
                                         TEST, VALID, TRAIN)
from znicz_tpu_torch.ops.init import fill_array
from znicz_tpu_torch.ops.conv import output_spatial as conv_spatial
from znicz_tpu_torch.ops.pooling import output_spatial as pool_spatial
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.zerofilling import grouping_mask

BASE_LR = 0.01
WD = 0.0005
_CONV_BWD = {"learning_rate": BASE_LR, "learning_rate_bias": BASE_LR * 2,
             "weights_decay": WD, "weights_decay_bias": 0,
             "gradient_moment": 0.9, "gradient_moment_bias": 0.9}


def make_layers(n_classes=1000):
    """The AlexNet layer list (reference config:111-230)."""
    return [
        {"name": "conv_str1", "type": "conv_str",
         "->": {"n_kernels": 96, "kx": 11, "ky": 11,
                "padding": (0, 0, 0, 0), "sliding": (4, 4),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CONV_BWD, factor_ortho=0.001)},
        {"name": "max_pool1", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "norm1", "type": "norm",
         "n": 5, "alpha": 0.0001, "beta": 0.75},
        {"name": "grouping1", "type": "zero_filter", "grouping": 2},
        {"name": "conv_str2", "type": "conv_str",
         "->": {"n_kernels": 256, "kx": 5, "ky": 5,
                "padding": (2, 2, 2, 2), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 1},
         "<-": dict(_CONV_BWD)},
        {"name": "max_pool2", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "norm2", "type": "norm",
         "n": 5, "alpha": 0.0001, "beta": 0.75},
        {"name": "grouping2", "type": "zero_filter", "grouping": 2},
        {"name": "conv_str3", "type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                "padding": (1, 1, 1, 1), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CONV_BWD)},
        {"name": "conv_str4", "type": "conv_str",
         "->": {"n_kernels": 384, "kx": 3, "ky": 3,
                "padding": (1, 1, 1, 1), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 1},
         "<-": dict(_CONV_BWD)},
        {"name": "grouping3", "type": "zero_filter", "grouping": 2},
        {"name": "conv_str5", "type": "conv_str",
         "->": {"n_kernels": 256, "kx": 3, "ky": 3,
                "padding": (1, 1, 1, 1), "sliding": (1, 1),
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 1},
         "<-": dict(_CONV_BWD)},
        {"name": "max_pool5", "type": "max_pooling",
         "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"name": "grouping5", "type": "zero_filter", "grouping": 2},
        {"name": "fc6", "type": "all2all",
         "->": {"output_sample_shape": 4096,
                "weights_filling": "gaussian", "weights_stddev": 0.005,
                "bias_filling": "constant", "bias_stddev": 1},
         "<-": dict(_CONV_BWD)},
        {"name": "relu6", "type": "activation_str"},
        {"name": "drop6", "type": "dropout", "dropout_ratio": 0.5},
        {"name": "fc7", "type": "all2all",
         "->": {"output_sample_shape": 4096,
                "weights_filling": "gaussian", "weights_stddev": 0.005,
                "bias_filling": "constant", "bias_stddev": 1},
         "<-": dict(_CONV_BWD)},
        {"name": "relu7", "type": "activation_str"},
        {"name": "drop7", "type": "dropout", "dropout_ratio": 0.5},
        {"name": "fc_softmax8", "type": "softmax",
         "->": {"output_sample_shape": n_classes,
                "weights_filling": "gaussian", "weights_stddev": 0.01,
                "bias_filling": "constant", "bias_stddev": 0},
         "<-": dict(_CONV_BWD)}]


def _fill(rand, filling, shape, stddev):
    """A float32 array of ``shape`` filled by the fused path's rules."""
    arr = numpy.zeros(shape, numpy.float32)
    fill_array(rand, filling, arr, stddev)
    return arr


def prototype_images(n, seed=0x1337, n_classes=10, size=227):
    """``(data, labels)``: ``n`` prototype-class ``size`` x ``size`` x 3
    float32 images before normalization, and their labels
    ``i % n_classes`` (int32).

    As ``SyntheticImagenetLoader.load_data``
    (``znicz_tpu/samples/research/alexnet.py:109-128``): one uniform
    [0, 255) prototype per class, each image its class's prototype plus
    gaussian noise of deviation 25, all from ``RandomState(seed)`` in
    that order, so the first ``m`` images of any ``n >= m`` are the
    same."""
    r = numpy.random.RandomState(seed)
    protos = r.uniform(0, 255, (n_classes, size, size, 3))
    labels = (numpy.arange(n) % n_classes).astype(numpy.int32)
    data = numpy.empty((n, size, size, 3), numpy.float32)
    for i in range(n):
        data[i] = protos[labels[i]] + r.normal(0, 25, (size, size, 3))
    return data, labels


def synthetic_images(n, seed=0x1337, n_classes=10, size=227):
    """:func:`prototype_images` with the loader's "linear"
    normalization, a map of the whole set's [min, max] onto [-1, 1]
    (the loader fits it on its train slice, which is the whole set
    here)."""
    data, labels = prototype_images(n, seed, n_classes, size)
    norm = LinearNormalizer()
    norm.analyze(data)
    return norm.normalize(data), labels


def init_package(seed, n_classes=1000, size=227, layers=None):
    """``(manifest, arrays)`` of a freshly initialised AlexNet (or of
    ``layers``, a list in the same format) on a ``size`` x ``size`` x 3
    input, drawn from ``RandomGenerator().seed(seed)``."""
    layers = make_layers(n_classes) if layers is None else layers
    rand = prng.RandomGenerator().seed(seed)
    h, w, c = size, size, 3
    entries, arrays = [], {}
    grouping = None
    for i, layer in enumerate(layers):
        tpe, fwd = layer["type"], layer.get("->", {})
        if tpe == "zero_filter":
            grouping = int(layer.get("grouping", 2))
            continue
        entry = {"type": tpe, "name": layer["name"], "arrays": {},
                 "include_bias": False, "weights_transposed": False}
        weights = bias = None
        if tpe.startswith("conv"):
            k, ky, kx = fwd["n_kernels"], fwd["ky"], fwd["kx"]
            padding = list(fwd.get("padding", (0, 0, 0, 0)))
            sliding = list(fwd.get("sliding", (1, 1)))
            weights = (k, ky * kx * c)
            entry.update(n_kernels=k, ky=ky, kx=kx, padding=padding,
                         sliding=sliding)
            h, w = conv_spatial(h, w, ky, kx, padding, sliding)
            c = k
        elif tpe == "softmax" or tpe.startswith("all2all"):
            k = int(fwd["output_sample_shape"])
            weights = (k, h * w * c)
            h, w, c = 1, 1, k
        elif tpe in ("max_pooling", "avg_pooling"):
            ky, kx = fwd["ky"], fwd["kx"]
            sliding = list(fwd.get("sliding", (kx, ky)))
            entry.update(ky=ky, kx=kx, sliding=sliding)
            h, w = pool_spatial(h, w, ky, kx, sliding)
        elif tpe == "norm":
            entry.update(alpha=layer.get("alpha", 0.0001),
                         beta=layer.get("beta", 0.75), k=layer.get("k", 2),
                         n=layer.get("n", 5))
        if weights is not None:
            wts = _fill(rand, fwd["weights_filling"], weights,
                        fwd["weights_stddev"])
            bias = _fill(rand, fwd["bias_filling"], (weights[0],),
                         fwd["bias_stddev"])
            entry["include_bias"] = True
            if grouping is not None:
                mask = grouping_mask(weights, grouping)
                wts *= mask
                arrays["layer%d_zero_filter_mask.npy" % i] = mask
                entry["arrays"]["zero_filter_mask"] = \
                    "layer%d_zero_filter_mask.npy" % i
                entry["zero_filter_grouping"] = grouping
                grouping = None
            for attr, value in (("weights", wts), ("bias", bias)):
                fname = "layer%d_%s.npy" % (i, attr)
                arrays[fname] = value
                entry["arrays"][attr] = fname
        elif grouping is not None:
            raise ValueError("zero_filter precedes %r which has no "
                             "weights" % layer["name"])
        entries.append(entry)
    shape = [size, size, 3]
    manifest = {"format": PACKAGE_FORMAT, "workflow": "AlexNetWorkflow",
                "layers": entries, "input_sample_shape": shape,
                "serving": serving_manifest(shape)}
    return manifest, arrays


class SyntheticImagenetLoader(FullBatchLoader, IFullBatchLoader):
    """Prototype-class RGB images through the full-batch contract
    (``znicz_tpu/samples/research/alexnet.py:99-128``): the same rows
    as the JAX package's loader, laid out [VALID | TRAIN]."""

    MAPPING = "synthetic_imagenet_loader"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super(SyntheticImagenetLoader, self).__init__(workflow, **kwargs)
        self.n_classes = kwargs.get("n_classes", 10)
        self.n_train = kwargs.get("n_train", 40)
        self.n_valid = kwargs.get("n_valid", 20)
        self.size = kwargs.get("size", 227)

    def load_data(self):
        data, labels = prototype_images(self.n_train + self.n_valid,
                                        0x1337, self.n_classes, self.size)
        self.original_data.reset(data)
        del self._original_labels[:]
        self._original_labels.extend(int(v) for v in labels)
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = self.n_valid
        self.class_lengths[TRAIN] = self.n_train


#: the sample's config, the JAX sample's; its ``lr_adjuster`` block is
#: written as there, and as there no build links it
root.alexnet.update({
    "decision": {"fail_iterations": 10000, "max_epochs": 10000},
    "snapshotter": {"prefix": "alexnet", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loss_function": "softmax",
    "loader_name": "synthetic_imagenet_loader",
    "loader": {"minibatch_size": 4, "n_classes": 10},
    "lr_adjuster": {"do": True, "lr_policy_name": "arbitrary_step",
                    "bias_lr_policy_name": "arbitrary_step",
                    "lr_parameters": {
                        "lrs_with_lengths": [(1, 100000), (0.1, 100000),
                                             (0.01, 100000000)]},
                    "bias_lr_parameters": {
                        "lrs_with_lengths": [(1, 100000), (0.1, 100000),
                                             (0.01, 100000000)]}},
})


class AlexNetWorkflow(StandardWorkflow):
    """The AlexNet training workflow (``StandardWorkflow``), in either
    graph, with no learning-rate adjuster (the JAX sample's)."""


def build(layers=None, loader_config=None, decision_config=None, **kwargs):
    """An :class:`AlexNetWorkflow` from ``root.alexnet``, with the
    given config dicts merged over it (the JAX sample's ``build``)."""
    cfg = root.alexnet
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(kwargs.pop("snapshotter_config", None) or {})
    return AlexNetWorkflow(
        layers=layers if layers is not None
        else make_layers(loader_cfg.get("n_classes", 10)),
        loader_name=cfg.loader_name, loader_config=loader_cfg,
        decision_config=decision_cfg, snapshotter_config=snap_cfg,
        **kwargs)


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch alexnet``)."""
    load(build)
    main()
