"""Fused training — forward, softmax-CE gradient and per-layer update as
one step on the device.

Counterpart of ``znicz_tpu/parallel/fused.py``, single device: the
spec building (``layer_hyper``, ``build_specs`` :349-559, with the
autoencoders' ``DeconvSpec`` / ``DepoolSpec`` :279-314), the pure
functions (``init_params`` :570, ``init_opt_state`` :606, ``forward``
:622-803, ``_loss_and_stats`` :805, ``_loss_and_stats_mse`` :825,
``default_hypers`` :2272, ``_apply_weight_masks`` :2291,
``_train_step`` :2305, ``_train_step_mse`` :905, ``flops_per_image``
:981) and :class:`FusedNet` (:997-2258), with the softmax and the MSE
objectives; ``build_fc_specs`` (:560) and :class:`FusedMLP` (:2260)
are their fully-connected forms.

What maps to what:

* a jitted step becomes eager PyTorch: the forward on the ports of
  the JAX package's ops, the gradient from ``torch.autograd.grad`` of
  the mean softmax-CE loss, the update from
  :func:`znicz_tpu_torch.ops.gd_math.update`;
* a window's ``lax.scan`` becomes a Python loop of K steps over the
  device-resident dataset; the evaluator's stats fold into a
  device-resident accumulator, and nothing inside a window reads the
  device back (no ``.item()``, no ``.cpu()``, no ``bool()`` of a
  tensor): the caller reads the accumulator once per epoch;
* the ``jax.random`` key becomes a ``torch.Generator`` on the net's
  device, seeded with ``dropout_seed``; dropout keeps ``rand >= ratio``
  and scales by ``1 / (1 - ratio)`` as the JAX package does, from
  other random numbers (the two generators differ by design);
* max pooling under ``pool_impl="offsets"`` runs the hand-written
  forward and backward kernels on the card
  (:func:`znicz_tpu_torch.ops.pooling.max_pooling_train`);
* in an autoencoder stage a max pool tied to a depooling records its
  winners on the forward kernel (the JAX package forces that pool onto
  its gather, which computes the same function), and the depooling is
  the backward kernel; a deconv applies its tied conv's weights, which
  the conv's own application does not train;
* the stochastic pools draw their uint16 stream on the device from the
  net's generator, one draw a layer a step (the JAX package splits its
  key there), into :func:`pool_ops.stochastic_pooling` /
  ``stochastic_pool_depool``, in training and in :meth:`FusedNet.predict`
  alike; only the distribution of the winners can match the JAX
  package's;
* windows take their minibatches host-stacked (:meth:`FusedNet.run_window`,
  :meth:`FusedNet.run_window_mse`), gathered from the device dataset by
  row index (``run_window_indexed``, ``run_window_mse_indexed``) or
  sliced from the epoch's shuffled dataset on the device
  (``run_window_sliced``, ``run_window_mse_sliced``);
* the armed profiler counts the first dispatch of each entry point
  into its cost registry under the JAX package's names (``fused.step``,
  ``fused.step_mse``, ``fused.window.<form>.k<K>``,
  ``fused.predict.b<B>``, ``fused.predict_idx.b<B>``; JAX
  :1229-1300, :1814-1874, :2114-2225), against 3 x
  :func:`flops_per_image` a trained row (1 x for a predict); a window
  is the K steps of its loop, counted whole;
* :meth:`FusedNet.host_fetch`, the trainer's readback, holds the
  ``fused.host_fetch`` fault site (JAX :2160-2173), and
  :meth:`FusedNet.device_state` / :meth:`FusedNet.load_device_state`
  keep a state on the device for the fused rollback.

* ``compute_dtype`` (bfloat16 as a rule) casts the input and the
  parameters at each product; the master parameters, the optimizer
  state, the loss and the accumulators stay float32 and the device
  dataset is stored in it (the max pools' kernels run in it);
* ``pool_impl="reshape"`` is :func:`pool_ops.max_pooling_reshape` /
  ``avg_pooling_reshape``, plain PyTorch, for windows that do not
  overlap.

* a ``mesh`` (:func:`znicz_tpu_torch.parallel.mesh.make_mesh`, a
  ``(data, model)`` grid of ``torch.distributed`` ranks, JAX
  :1079-1226) splits the work as GSPMD splits JAX's: every rank is
  given the global batch and trains on its contiguous rows of it; the
  step's gradient, loss and ``n_err`` (and a single step's output rows)
  are summed over the data axis in one all-reduce, so the step equals
  the single-device step over the global batch up to the order of the
  batch sum; an FC layer whose ``n_out`` divides by the model axis (and
  that has no ortho term, which sums over all rows) keeps its rows
  ``[m*n_out/M, (m+1)*n_out/M)`` of ``w``, ``b`` and their optimizer
  slots (``_param_spec``, JAX :1184-1191), its input's gradient summed
  and its output all-gathered over the model axis; the window
  statistics stay per-rank partials, folded in one all-reduce when the
  caller reads them (:meth:`FusedNet.fold_shards`, JAX ``_eval_stats``
  :845-901, ``_fold`` :959); dropout masks and the stochastic pools'
  draws are made for the global batch from the shared stream, each
  rank keeping its rows.  Unlike JAX, which leaves its Pallas forward
  off under a mesh (JAX :1026-1029), the pooling kernels run on every
  rank's rows: a rank's share is an ordinary single-device batch.

The spans (:func:`znicz_tpu_torch.core.telemetry.span`, armed while
telemetry is on or a ``torch.profiler`` capture runs), one fixed
vocabulary, each booked in ``telemetry.span_totals()``; those marked
"card" are also timed on the card by CUDA events when the net is
there:

* ``fused.window`` (``form``, ``steps``): a window, the fused
  trainer's included (JAX's trainer span ``fused.window`` covers
  them);
* ``fused.step`` (card): one step of a window, or :meth:`FusedNet.step`
  / :meth:`FusedNet.step_mse`;
* ``fused.fetch``: a window step's rows and labels;
* ``fused.forward``, ``fused.backward``, ``fused.update`` (card): the
  parts of a step, at the boundaries of ``mark``'s "forward",
  "backward" and "update" (:func:`_grad_step`); a mesh's all-reduce
  falls inside ``fused.backward``;
* ``fused.stats``: the evaluator's statistics of a window step and the
  fold into the epoch accumulator;
* ``fused.epoch_perm``: :meth:`FusedNet.set_epoch_perm`;
* ``fused.readback``: :meth:`FusedNet.host_fetch`, the accumulator's
  readback at each epoch turn.
"""

import contextlib
from collections import namedtuple
from dataclasses import dataclass, field

import numpy
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core import faults, memory, profiler, prng, telemetry
from znicz_tpu_torch.core.backends import (default_device,
                                            deterministic, full_f32)
from znicz_tpu_torch.ops import activations, dense, evaluator, gd_math
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.ops import init as init_ops
from znicz_tpu_torch.ops import normalization as norm_ops
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.parallel import mesh as mesh_mod
from znicz_tpu_torch.params import (tree_map, train_state_from_numpy,
                                    train_state_to_numpy)

#: the FC family: activation and the weights-magnitude constant C of
#: the unit class of each type (znicz_tpu/units/all2all.py)
FC_TYPES = {"all2all": ("linear", 10), "all2all_tanh": ("tanh", 9.0),
            "all2all_relu": ("relu", 10), "all2all_str": ("strict_relu", 10),
            "all2all_sigmoid": ("sigmoid", 1), "softmax": ("linear", 10)}
CONV_TYPES = {"conv": "linear", "conv_tanh": "tanh",
              "conv_sigmoid": "sigmoid", "conv_relu": "relu",
              "conv_str": "strict_relu"}
POOL_TYPES = {"max_pooling": "max", "maxabs_pooling": "maxabs",
              "avg_pooling": "avg",
              "stochastic_pooling": "stochastic",
              "stochastic_abs_pooling": "stochasticabs",
              "stochastic_pool_depool": "stochastic_depool",
              "stochastic_abs_pool_depool": "stochasticabs_depool"}
ACTIVATION_TYPES = {"activation_tanh": "tanh",
                    "activation_sigmoid": "sigmoid",
                    "activation_relu": "relu",
                    "activation_str": "strict_relu",
                    "activation_log": "log",
                    "activation_tanhlog": "tanhlog",
                    "activation_sincos": "sincos"}
#: strictly monotonically increasing activations — applied after a
#: following max pool, where they commute with it.  "relu" (softplus,
#: with a seam at 15) and strict relu are not strictly increasing.
_MONOTONIC_ACTS = frozenset(("linear", "tanh", "sigmoid"))

DEFAULT_HYPER = dict(lr=0.01, wd=0.00005, l1_vs_l2=0.0, moment=0.0,
                     acc_alpha=0.0, acc_beta=0.0, gd_alpha=0.0, gd_beta=1.0,
                     factor_ortho=0.0)

#: the context of a dispatch the profiler does not count
_UNCOUNTED = contextlib.nullcontext()

#: this rank's rows ``[lo, hi)`` of a global batch of ``batch`` rows
#: under ``mesh``: what a forward and a loss under a mesh are given
Shard = namedtuple("Shard", "mesh lo hi batch")


def layer_hyper(layer, defaults=None):
    """(hyper, hyper_bias, flags) for one layer dict: top-level keys
    merged under the "<-" backward kwargs."""
    layer = dict(layer)
    for k in ("type", "name", "->"):
        layer.pop(k, None)
    bwd = dict(layer.pop("<-", {}))
    merged = dict(layer)
    merged.update(bwd)
    return _parse_hyper(merged, dict(DEFAULT_HYPER, **(defaults or {})))


def _parse_hyper(bwd, defaults):
    """(hyper, hyper_bias, flags) from a layer's backward kwargs."""
    hyper = dict(defaults)
    hyper.update(
        lr=bwd.get("learning_rate", defaults["lr"]),
        wd=bwd.get("weights_decay", defaults["wd"]),
        l1_vs_l2=bwd.get("l1_vs_l2", defaults["l1_vs_l2"]),
        moment=bwd.get("gradient_moment", defaults["moment"]),
        acc_alpha=bwd.get("acc_alpha", defaults["acc_alpha"]),
        acc_beta=bwd.get("acc_beta", defaults["acc_beta"]),
        gd_alpha=bwd.get("gd_alpha", defaults["gd_alpha"]),
        gd_beta=bwd.get("gd_beta", defaults["gd_beta"]),
        factor_ortho=bwd.get("factor_ortho", defaults["factor_ortho"]))
    hyper_bias = dict(hyper)
    hyper_bias.update(
        lr=bwd.get("learning_rate_bias", hyper["lr"]),
        wd=bwd.get("weights_decay_bias", 0.0),
        l1_vs_l2=bwd.get("l1_vs_l2_bias", hyper["l1_vs_l2"]),
        moment=bwd.get("gradient_moment_bias", hyper["moment"]),
        factor_ortho=0.0)
    flags = dict(accumulate=bool(bwd.get("accumulate_gradient", False)),
                 apply=True,
                 solvers=frozenset(bwd.get("solvers", ())),
                 ortho=bool(hyper["factor_ortho"]),
                 variant_moment=bwd.get("variant_moment_gradient", True))
    return hyper, hyper_bias, flags


@dataclass
class FCSpec:
    """One fully-connected layer; weights ``(n_out, n_in)``."""
    type: str
    n_in: int
    n_out: int
    activation: str
    hyper: dict = field(default_factory=dict)
    hyper_bias: dict = field(default_factory=dict)
    flags: dict = field(default_factory=dict)
    weights_stddev: float = None
    bias_stddev: float = None
    weights_filling: str = "uniform"
    bias_filling: str = "uniform"
    include_bias: bool = True

    kind = "fc"

    @property
    def is_softmax(self):
        return self.type == "softmax"

    @property
    def out_shape(self):
        return (self.n_out,)

    def init_stddev(self):
        """The magnitude heuristic with the type's C, capped at 0.5."""
        if self.weights_stddev is not None:
            return self.weights_stddev
        vle = init_ops.weights_magnitude(FC_TYPES[self.type][1], self.n_in,
                                         self.n_out, self.weights_filling)
        return min(vle, 0.5)


@dataclass
class ConvSpec:
    """One convolutional layer: NHWC, weights ``(n_kernels, ky*kx*C)``,
    padding (left, top, right, bottom), sliding (x, y)."""
    type: str
    in_shape: tuple
    out_shape: tuple
    n_kernels: int
    kx: int
    ky: int
    padding: tuple
    sliding: tuple
    activation: str
    hyper: dict = field(default_factory=dict)
    hyper_bias: dict = field(default_factory=dict)
    flags: dict = field(default_factory=dict)
    weights_stddev: float = None
    bias_stddev: float = None
    weights_filling: str = "uniform"
    bias_filling: str = "uniform"
    include_bias: bool = True
    max_supposed: float = 1.0

    kind = "conv"
    is_softmax = False

    @property
    def n_channels(self):
        return self.in_shape[2]

    def init_stddev(self):
        """``1 / (max_supposed * sqrt(kx*ky*C))`` (a third for a gaussian
        filling), capped at 0.05."""
        if self.weights_stddev is not None:
            return self.weights_stddev
        vle = 1.0 / (self.max_supposed *
                     numpy.sqrt(self.kx * self.ky * self.n_channels))
        if self.weights_filling == "gaussian":
            vle /= 3
        return min(vle, 0.05)


@dataclass
class PoolSpec:
    """max / maxabs / avg pooling, ceil-mode.  ``impl`` is the max-pool
    lowering: "reduce_window" (the default), "offsets" (the kernels) or
    "gather" (see :mod:`znicz_tpu_torch.ops.pooling`)."""
    type: str
    in_shape: tuple
    out_shape: tuple
    mode: str
    kx: int
    ky: int
    sliding: tuple
    impl: str = "reduce_window"

    #: tied to a depooling: the pool records its winners' offsets (set
    #: on the instance by :func:`build_specs`)
    record_offsets = False
    kind = "pool"
    is_softmax = False


@dataclass
class LRNSpec:
    """Cross-channel local response normalization."""
    type: str
    in_shape: tuple
    out_shape: tuple
    alpha: float = 1e-4
    beta: float = 0.75
    k: float = 2.0
    n: int = 5

    kind = "lrn"
    is_softmax = False


@dataclass
class ActivationSpec:
    """A standalone activation layer."""
    type: str
    in_shape: tuple
    out_shape: tuple
    activation: str = "linear"

    kind = "activation"
    is_softmax = False


@dataclass
class DeconvSpec:
    """A transposed conv with the weights of the conv at spec index
    ``tied``, in that conv's geometry; only this application trains
    them (the conv's own runs detached)."""
    type: str
    in_shape: tuple      # (ny, nx, K)
    out_shape: tuple     # (H, W, C): the tied conv's input shape
    tied: int
    n_kernels: int
    kx: int
    ky: int
    padding: tuple
    sliding: tuple
    unsafe_padding: bool = False

    kind = "deconv"
    is_softmax = False


@dataclass
class DepoolSpec:
    """Scatters its input to the winners that the pool at spec index
    ``tied`` recorded in the same forward pass."""
    type: str
    in_shape: tuple
    out_shape: tuple     # the tied pool's input shape
    tied: int

    kind = "depool"
    is_softmax = False


@dataclass
class ZeroFillSpec:
    """A ``zero_filter`` layer: identity in the chain; its grouping mask
    goes to the next layer with weights (``weight_mask``)."""
    type: str
    in_shape: tuple
    out_shape: tuple
    grouping: int

    kind = "zerofill"
    is_softmax = False


@dataclass
class DropoutSpec:
    """Inverted dropout: ``keep / (1 - ratio)`` in training."""
    type: str
    in_shape: tuple
    out_shape: tuple
    ratio: float = 0.5

    kind = "dropout"
    is_softmax = False


def _normalize_sample_shape(shape):
    if isinstance(shape, (int, numpy.integer)):
        return (int(shape),)
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:    # (H, W) -> one implicit channel
        shape = shape + (1,)
    return shape


def build_specs(layers, input_sample_shape, defaults=None):
    """The spec list of a declarative ``layers`` config (dicts with
    "type", forward kwargs at the top or under "->", backward kwargs
    under "<-"); sample shapes thread through the geometry."""
    defaults = dict(DEFAULT_HYPER, **(defaults or {}))
    specs = []
    names = {}               # layer name -> spec index (tied_to)
    pending_grouping = None  # zero_filter masks the NEXT layer's weights
    shape = _normalize_sample_shape(input_sample_shape)
    for index, layer in enumerate(layers):
        orig_layer = layer
        layer = dict(layer)
        tpe = layer.pop("type")
        name = layer.pop("name", None) or "%s_%d" % (tpe, index)
        fwd = dict(layer.pop("->", {}))
        layer.pop("<-", None)
        fwd.update(layer)
        if tpe in FC_TYPES:
            oshape = fwd.get("output_sample_shape",
                             fwd.get("output_samples"))
            if oshape is None:
                raise ValueError("layer %r needs output_sample_shape" % tpe)
            n_out = int(numpy.prod(oshape))
            hyper, hyper_bias, flags = layer_hyper(orig_layer, defaults)
            specs.append(FCSpec(
                type=tpe, n_in=int(numpy.prod(shape)), n_out=n_out,
                activation=FC_TYPES[tpe][0],
                hyper=hyper, hyper_bias=hyper_bias, flags=flags,
                weights_stddev=fwd.get("weights_stddev"),
                bias_stddev=fwd.get("bias_stddev"),
                weights_filling=fwd.get("weights_filling", "uniform"),
                bias_filling=fwd.get("bias_filling", "uniform"),
                include_bias=fwd.get("include_bias", True)))
            shape = (n_out,)
        elif tpe in CONV_TYPES:
            if len(shape) != 3:
                raise ValueError(
                    "conv layer %r needs a (H, W, C) input, have %r"
                    % (tpe, shape))
            kx, ky = int(fwd["kx"]), int(fwd["ky"])
            n_kernels = int(fwd["n_kernels"])
            padding = tuple(fwd.get("padding", (0, 0, 0, 0)))
            sliding = tuple(fwd.get("sliding", (1, 1)))
            ny, nx = conv_ops.output_spatial(
                shape[0], shape[1], ky, kx, padding, sliding)
            hyper, hyper_bias, flags = layer_hyper(orig_layer, defaults)
            specs.append(ConvSpec(
                type=tpe, in_shape=shape, out_shape=(ny, nx, n_kernels),
                n_kernels=n_kernels, kx=kx, ky=ky,
                padding=padding, sliding=sliding,
                activation=CONV_TYPES[tpe],
                hyper=hyper, hyper_bias=hyper_bias, flags=flags,
                weights_stddev=fwd.get("weights_stddev"),
                bias_stddev=fwd.get("bias_stddev"),
                weights_filling=fwd.get("weights_filling", "uniform"),
                bias_filling=fwd.get("bias_filling", "uniform"),
                include_bias=fwd.get("include_bias", True),
                max_supposed=fwd.get("input_max_supposed", 1.0)))
            shape = (ny, nx, n_kernels)
        elif tpe in POOL_TYPES:
            if len(shape) != 3:
                raise ValueError(
                    "pooling layer %r needs a (H, W, C) input, have %r"
                    % (tpe, shape))
            kx, ky = int(fwd["kx"]), int(fwd["ky"])
            sliding = tuple(fwd.get("sliding") or (kx, ky))
            mode = POOL_TYPES[tpe]
            if mode.endswith("_depool"):
                # pooling and depooling in one: the input's shape
                out_shape = shape
            else:
                ny, nx = pool_ops.output_spatial(
                    shape[0], shape[1], ky, kx, sliding)
                out_shape = (ny, nx, shape[2])
            specs.append(PoolSpec(
                type=tpe, in_shape=shape, out_shape=out_shape,
                mode=mode, kx=kx, ky=ky, sliding=sliding))
            shape = out_shape
        elif tpe == "norm":
            if len(shape) != 3:
                raise ValueError(
                    "LRN layer needs a (H, W, C) input, have %r" % (shape,))
            specs.append(LRNSpec(
                type=tpe, in_shape=shape, out_shape=shape,
                alpha=fwd.get("alpha", 1e-4), beta=fwd.get("beta", 0.75),
                k=fwd.get("k", 2), n=fwd.get("n", 5)))
        elif tpe in ACTIVATION_TYPES:
            specs.append(ActivationSpec(
                type=tpe, in_shape=shape, out_shape=shape,
                activation=ACTIVATION_TYPES[tpe]))
        elif tpe == "dropout":
            specs.append(DropoutSpec(
                type=tpe, in_shape=shape, out_shape=shape,
                ratio=fwd.get("dropout_ratio", 0.5)))
        elif tpe == "zero_filter":
            pending_grouping = int(fwd.get("grouping", 2))
            if pending_grouping < 2:
                raise ValueError("grouping value %d is invalid"
                                 % pending_grouping)
            specs.append(ZeroFillSpec(
                type=tpe, in_shape=shape, out_shape=shape,
                grouping=pending_grouping))
        elif tpe == "deconv":
            conv_spec = _tied_spec(fwd, names, specs, "a conv layer")
            if conv_spec.kind != "conv":
                raise ValueError("tied_to %r is not a conv layer"
                                 % fwd["tied_to"])
            if shape != conv_spec.out_shape:
                raise ValueError("deconv input %r != tied conv output %r"
                                 % (shape, conv_spec.out_shape))
            # only the deconv's application trains the shared weights,
            # and its "<-" governs their update
            conv_spec.stop_gradient = True
            if orig_layer.get("<-"):
                (conv_spec.hyper, conv_spec.hyper_bias,
                 conv_spec.flags) = layer_hyper(orig_layer, defaults)
            specs.append(DeconvSpec(
                type=tpe, in_shape=shape, out_shape=conv_spec.in_shape,
                tied=names[fwd["tied_to"]], n_kernels=conv_spec.n_kernels,
                kx=conv_spec.kx, ky=conv_spec.ky,
                padding=tuple(conv_spec.padding),
                sliding=conv_spec.sliding,
                unsafe_padding=fwd.get("unsafe_padding", False)))
            shape = conv_spec.in_shape
        elif tpe == "depooling":
            pool_spec = _tied_spec(fwd, names, specs, "a pooling layer")
            if pool_spec.kind != "pool" or pool_spec.mode not in (
                    "max", "maxabs", "stochastic", "stochasticabs"):
                raise ValueError(
                    "tied_to %r is not an offset-recording pooling"
                    % fwd["tied_to"])
            if shape != pool_spec.out_shape:
                raise ValueError("depooling input %r != tied pool output %r"
                                 % (shape, pool_spec.out_shape))
            pool_spec.record_offsets = True
            specs.append(DepoolSpec(
                type=tpe, in_shape=shape, out_shape=pool_spec.in_shape,
                tied=names[fwd["tied_to"]]))
            shape = pool_spec.in_shape
        else:
            raise ValueError("fused path does not support layer type %r"
                             % tpe)
        names[name] = len(specs) - 1
        spec = specs[-1]
        if pending_grouping is not None and spec.kind in ("fc", "conv"):
            # the ZeroFiller mask of this layer's weights: (k % G != c % G)
            if spec.kind == "fc":
                kernels, chans = spec.n_out, spec.n_in
            else:
                kernels = spec.n_kernels
                chans = spec.kx * spec.ky * spec.n_channels
            g = pending_grouping
            if chans % g:
                raise ValueError(
                    "Non-multiple of grouping weights shape: (%d, %d), "
                    "grouping=%d" % (kernels, chans, g))
            krow = numpy.arange(kernels)[:, None] % g
            ccol = numpy.arange(chans)[None, :] % g
            spec.weight_mask = (krow != ccol).astype(numpy.float64)
            pending_grouping = None
    return specs


def build_fc_specs(layers, input_sample_size, defaults=None):
    """:func:`build_specs` for a fully-connected stack; any other layer
    type raises."""
    specs = build_specs(layers, int(input_sample_size), defaults)
    for spec in specs:
        if spec.kind != "fc":
            raise ValueError("fused FC path does not support layer type %r"
                             % spec.type)
    return specs


def _tied_spec(fwd, names, specs, what):
    """The spec a deconv or depooling layer's ``tied_to`` names."""
    tied = fwd.get("tied_to")
    if tied is None or tied not in names:
        raise ValueError("a fused deconv or depooling needs tied_to=<name "
                         "of %s before it>, got %r" % (what, tied))
    return specs[names[tied]]


def init_params(specs, rand=None, dtype=numpy.float32):
    """Host numpy parameters, one ``{"w", "b"}`` dict per spec (``{}``
    for layers without weights), drawn from ``rand`` (default
    ``prng.get()``) weights then bias, layer by layer — the JAX
    package's draws for the same stream."""
    rand = rand or prng.get()
    params = []
    for spec in specs:
        if spec.kind == "fc":
            w_shape = (spec.n_out, spec.n_in)
            n_bias = spec.n_out
        elif spec.kind == "conv":
            w_shape = (spec.n_kernels,
                       spec.kx * spec.ky * spec.n_channels)
            n_bias = spec.n_kernels
        else:
            params.append({})
            continue
        stddev = spec.init_stddev()
        bias_stddev = spec.bias_stddev if spec.bias_stddev is not None \
            else stddev
        w = numpy.zeros(w_shape, dtype=dtype)
        init_ops.fill_array(rand, spec.weights_filling, w, stddev)
        p = {"w": w}
        if spec.include_bias:
            b = numpy.zeros(n_bias, dtype=dtype)
            init_ops.fill_array(rand, spec.bias_filling, b, bias_stddev)
            p["b"] = b
        params.append(p)
    return params


def init_opt_state(specs, params):
    """Optimizer state mirroring ``params`` (tensors): one
    :func:`gd_math.init_state` per parameter, velocity always kept."""
    states = []
    for spec, p in zip(specs, params):
        states.append({name: gd_math.init_state(
            p[name], dict(spec.flags, need_vel=True))
            for name in ("w", "b") if name in p})
    return states


def _mask(spec, w):
    """The spec's grouping mask as a tensor like ``w`` (cached on the
    spec per dtype and device), or None; a layer split over the model
    axis takes its rows of it."""
    mask = getattr(spec, "weight_mask", None)
    if mask is None:
        return None
    rows = getattr(spec, "rows", None)
    if rows is not None:
        mask = mask[rows[0]:rows[1]]
    cache = spec.__dict__.setdefault("_mask_tensors", {})
    key = (w.dtype, w.device)
    if key not in cache:
        cache[key] = torch.as_tensor(mask).to(device=w.device,
                                              dtype=w.dtype)
    return cache[key]


def forward(params, x, specs, return_logits=False, generator=None,
            train=False, compute_dtype=None, shard=None):
    """The forward pass through the whole spec stack.

    ``compute_dtype`` (a torch dtype, e.g. ``torch.bfloat16``) casts the
    input and each layer's parameters where they are used, so every
    product runs in it; the parameters themselves keep their dtype and
    a softmax head normalizes in float32 (JAX :622-690).
    With ``return_logits`` the softmax head is left un-normalized.
    Dropout masks are drawn from ``generator`` when ``train``; otherwise
    dropout is the identity.  The stochastic pools draw their winners
    from ``generator`` whenever it is given (in inference too).  A
    strictly monotonic conv activation is applied after a following max
    pool (``_MONOTONIC_ACTS``).  Under a mesh, ``shard`` (a
    :data:`Shard`) says which rows of the global batch ``x`` holds: the
    random draws are made for the global batch and cut to those rows,
    and a layer split over the model axis (``spec.rows``) sums its
    input's gradient and gathers its output over that axis."""
    cd = compute_dtype

    def _p(t):
        return t if cd is None or t is None else t.to(cd)

    y = x if cd is None else x.to(cd)
    deferred_act = None
    offsets = {}         # spec index -> winner offsets, for a depooling
    for i, (p, spec) in enumerate(zip(params, specs)):
        if deferred_act is not None and spec.kind != "pool":
            raise AssertionError("deferred activation not consumed")
        if spec.kind == "fc":
            w = _p(p["w"])
            mask = _mask(spec, w)
            if mask is not None:
                w = w * mask
            split = getattr(spec, "rows", None) is not None
            if split:
                y = mesh_mod.SumGradAxis.apply(y, shard.mesh, "model")
            y = dense.forward(y, w, _p(p.get("b")),
                              "linear" if spec.is_softmax
                              else spec.activation,
                              include_bias="b" in p)
            if split:
                y = mesh_mod.GatherAxis.apply(y, shard.mesh, "model", 1)
            if spec.is_softmax and not return_logits:
                if cd is not None:
                    y = y.float()
                y = torch.softmax(y, dim=1)
        elif spec.kind == "conv":
            y = y.reshape((y.shape[0],) + spec.in_shape)
            w = _p(p["w"])
            mask = _mask(spec, w)
            if mask is not None:
                w = w * mask
            if getattr(spec, "stop_gradient", False):
                w = w.detach()   # a tied deconv's application trains it
            act = spec.activation
            if (act in _MONOTONIC_ACTS and i + 1 < len(specs)
                    and specs[i + 1].kind == "pool"
                    and specs[i + 1].mode == "max"):
                deferred_act, act = act, "linear"
            y = conv_ops.forward(y, w, _p(p.get("b")), spec.ky, spec.kx,
                                 spec.padding, spec.sliding,
                                 activation=act, include_bias="b" in p)
        elif spec.kind == "pool":
            y = y.reshape((y.shape[0],) + spec.in_shape)
            if spec.mode.startswith("stochastic"):
                y, offsets[i] = _stochastic_pool(spec, y, generator, shard)
            elif spec.record_offsets:
                y, offsets[i] = pool_ops.max_pooling_train(
                    y, spec.ky, spec.kx, spec.sliding,
                    spec.mode == "maxabs")
            elif spec.impl == "reshape":
                if spec.mode == "avg":
                    y = pool_ops.avg_pooling_reshape(y, spec.ky, spec.kx)
                else:
                    y = pool_ops.max_pooling_reshape(
                        y, spec.ky, spec.kx, spec.mode == "maxabs")
            elif spec.mode != "avg" and spec.impl == "offsets":
                y, _ = pool_ops.max_pooling_train(
                    y, spec.ky, spec.kx, spec.sliding,
                    spec.mode == "maxabs")
            elif spec.mode != "avg" and spec.impl == "gather":
                y = pool_ops.max_pooling_gather(
                    y, spec.ky, spec.kx, spec.sliding,
                    spec.mode == "maxabs")
            else:
                y = pool_ops.pooling_reduce_window(
                    y, spec.ky, spec.kx, spec.sliding, spec.mode)
            if deferred_act is not None:
                y = activations.apply(deferred_act, y)
                deferred_act = None
        elif spec.kind == "deconv":
            y = y.reshape((y.shape[0],) + spec.in_shape)
            out_shape = (y.shape[0],) + spec.out_shape
            y = conv_ops.deconv_forward(y, _p(params[spec.tied]["w"]),
                                        spec.ky,
                                        spec.kx, spec.padding, spec.sliding,
                                        out_shape)
            if spec.unsafe_padding:
                # the value divided by the hits, the gradient the
                # undivided scatter's, as the reference's GDDeconv
                div = y / _hits(spec, y)
                y = y + (div - y).detach()
        elif spec.kind == "depool":
            y = y.reshape((y.shape[0],) + spec.in_shape)
            t = specs[spec.tied]
            y = _Depooling.apply(y.contiguous(), offsets[spec.tied],
                                 (y.shape[0],) + spec.out_shape, t.ky, t.kx,
                                 t.sliding)
        elif spec.kind == "lrn":
            y = y.reshape((y.shape[0],) + spec.in_shape)
            y = norm_ops.lrn_forward(y, alpha=spec.alpha, beta=spec.beta,
                                     k=spec.k, n=spec.n)
        elif spec.kind == "activation":
            y = activations.apply(spec.activation, y)
        elif spec.kind == "dropout":
            if train and generator is not None:
                # drawn in at least float32: a bfloat16 compute draws
                # the float32 run's masks
                shape = tuple(y.shape) if shard is None else \
                    (shard.batch,) + tuple(y.shape[1:])
                keep = torch.rand(shape, generator=generator,
                                  device=y.device,
                                  dtype=torch.promote_types(
                                      y.dtype, torch.float32)) >= \
                    spec.ratio
                if shard is not None:
                    keep = keep[shard.lo:shard.hi]
                y = y * keep.to(y.dtype) / (1.0 - spec.ratio)
        elif spec.kind != "zerofill":  # pragma: no cover
            raise AssertionError(spec.kind)
    return y


def draw_u16(generator, n):
    """``n`` uniform uint16 values (int32 tensor) drawn on
    ``generator``'s device: a stochastic pool's stream for one step."""
    return torch.randint(0, 1 << 16, (int(n),), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _stochastic_pool(spec, y, generator, shard=None):
    """A stochastic pool's ``(output, int32 winner offsets)`` on
    :func:`pool_ops.stochastic_pooling` (or ``stochastic_pool_depool``),
    fed one uint16 a window from ``generator``: one draw a layer a
    step, where the JAX package splits its key.  Only the distribution
    matches the JAX package's draw.  Under a mesh the stream is drawn
    for the global batch and each rank takes its rows' part."""
    if generator is None:
        raise ValueError("stochastic pooling needs the net's generator")
    use_abs = "abs" in spec.mode
    b, h, w, c = y.shape
    if spec.mode.endswith("_depool"):
        ny, nx = pool_ops.output_spatial(h, w, spec.ky, spec.kx,
                                         (spec.kx, spec.ky))
    else:
        ny, nx, _ = spec.out_shape
    per = ny * nx * c
    if shard is None:
        rand = draw_u16(generator, b * per)
    else:
        rand = draw_u16(generator, shard.batch * per)[
            shard.lo * per:shard.hi * per]
    if spec.mode.endswith("_depool"):
        return pool_ops.stochastic_pool_depool(y, rand, spec.ky, spec.kx,
                                               use_abs)
    return pool_ops.stochastic_pooling(y, rand, spec.ky, spec.kx,
                                       spec.sliding, use_abs)


def _hits(spec, y):
    """The deconv's window count per output cell, ``(B, H, W, 1)`` like
    ``y`` and at least 1 (cached on the spec by batch, dtype and
    device)."""
    cache = spec.__dict__.setdefault("_hits", {})
    key = (y.shape[0], y.dtype, y.device)
    if key not in cache:
        hits = conv_ops.deconv_hits(
            (y.shape[0],) + spec.in_shape[:2], spec.ky, spec.kx,
            spec.padding, spec.sliding, tuple(y.shape), dtype=y.dtype,
            device=y.device)
        cache[key] = torch.clamp(hits, min=1)[..., None]
    return cache[key]


class _Depooling(torch.autograd.Function):
    """:func:`pool_ops.depooling` (the backward kernel on the card),
    whose gradient takes each value's cotangent back from its winner."""

    @staticmethod
    def forward(ctx, values, offsets, x_shape, ky, kx, sliding):
        ctx.save_for_backward(offsets)
        return pool_ops.depooling(values, offsets, x_shape, ky, kx, sliding)

    @staticmethod
    def backward(ctx, grad):
        offsets, = ctx.saved_tensors
        return (torch.take(grad, offsets.long()), None, None, None, None,
                None)


def _loss_and_stats(params, x, labels, specs, generator=None,
                    compute_dtype=None, shard=None, n_valid=None):
    """Mean softmax-CE loss over the rows labelled >= 0, the number of
    them misclassified, the softmax output and its int32 argmax; the
    loss is taken in float32 under a ``compute_dtype`` (JAX :805-812).
    Under a mesh the rows are this rank's (``shard``) and the mean is
    over ``n_valid``, the global batch's count: the ranks' losses sum
    to the global one."""
    y = forward(params, x, specs, return_logits=True, generator=generator,
                train=True, compute_dtype=compute_dtype, shard=shard)
    if compute_dtype is not None:
        y = y.float()
    logp = F.log_softmax(y, dim=1)
    valid = labels >= 0
    lbl = labels.clamp(min=0)
    ce = -torch.gather(logp, 1, lbl[:, None].long())[:, 0]
    ce = torch.where(valid, ce, 0.0)
    loss = ce.sum() / (valid.sum() if n_valid is None
                       else n_valid).clamp(min=1)
    max_idx = torch.argmax(y, dim=1).to(torch.int32)
    n_err = (valid & (max_idx != lbl)).sum()
    return loss, (n_err, torch.exp(logp.detach()), max_idx)


def _loss_mse(params, x, target, batch_size, specs, generator=None,
              compute_dtype=None, shard=None):
    """``(loss, output)``: ``sum((y - t)^2) / (2 * batch_size)`` over the
    rows in the batch, whose gradient in ``y`` is the MSE evaluator's
    ``err_output``, ``(y - t) / batch_size``; in float32 under a
    ``compute_dtype`` (JAX :825-835).  Under a mesh the rows are this
    rank's (``shard``), masked by their place in the global batch."""
    y = forward(params, x, specs, generator=generator, train=True,
                compute_dtype=compute_dtype, shard=shard)
    if compute_dtype is not None:
        y = y.float()
    b = y.shape[0]
    o2 = y.reshape(b, -1)
    valid = torch.arange(b, device=y.device) < batch_size - (
        0 if shard is None else shard.lo)
    diff = torch.where(valid[:, None],
                       o2 - target.reshape(b, -1).to(o2.dtype), 0)
    return 0.5 * (diff * diff).sum() / max(int(batch_size), 1), y


def default_hypers(specs):
    """The live hyperparameters: ``{"w": {...}, "b": {...}}`` per spec
    with weights (``{}`` for the others), from the config."""
    hypers = []
    for spec in specs:
        if spec.kind in ("fc", "conv"):
            h = {"w": dict(spec.hyper)}
            if spec.include_bias:
                h["b"] = dict(spec.hyper_bias)
            hypers.append(h)
        else:
            hypers.append({})
    return hypers


def _apply_weight_masks(params, specs):
    """Re-zero the grouped weight positions before the step, so weight
    decay and ortho see masked weights (the unit graph's order)."""
    out = []
    for spec, p in zip(specs, params):
        if "w" in p:
            mask = _mask(spec, p["w"])
            if mask is not None:
                p = dict(p, w=p["w"] * mask)
        out.append(p)
    return out


def _grad_step(params, state, specs, hypers, loss_fn, mark=None,
               sync=None, on_card=False):
    """``(new_params, new_state, loss, aux)``: the gradient of
    ``loss_fn(params) -> (loss, aux)`` and every layer's update.
    ``mark``, when given, is called with "forward", "backward" and
    "update" as each part has been enqueued.  ``sync(grads, loss, aux)
    -> (grads, loss, aux)``, under a mesh, sums them over the data
    axis before the update.  ``on_card`` times the spans
    ``fused.forward``, ``fused.backward`` and ``fused.update`` on the
    card."""
    with telemetry.span("fused.forward", device=on_card):
        with torch.no_grad():
            params = _apply_weight_masks(params, specs)
        leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
                  for p in params]
        with torch.enable_grad():
            loss, aux = loss_fn(leaves)
    if mark is not None:
        mark("forward")
    with telemetry.span("fused.backward", device=on_card):
        flat = [v for p in leaves for v in p.values()]
        with torch.enable_grad():
            grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        if sync is not None:
            grads, loss, aux = sync(grads, loss, aux)
    grads = iter(grads)
    if mark is not None:
        mark("backward")
    if hypers is None:
        hypers = [None] * len(params)
    new_params, new_state = [], []
    with telemetry.span("fused.update", device=on_card):
        for spec, p, st, hy in zip(specs, params, state, hypers):
            np_, nst = {}, {}
            for name in p:   # "w" then "b", the order of ``flat``
                g = next(grads)
                if name == "w":
                    hyper = hy["w"] if hy else spec.hyper
                    flags = spec.flags
                else:
                    hyper = hy["b"] if hy else spec.hyper_bias
                    flags = dict(spec.flags, ortho=False)
                np_[name], nst[name], _ = gd_math.update(
                    p[name], g.to(p[name].dtype), st[name], hyper, flags)
            new_params.append(np_)
            new_state.append(nst)
    if mark is not None:
        mark("update")
    return new_params, new_state, loss, aux


def _rank_labels(labels, shard):
    """``(labels, n_valid)``: a global batch's labels cut to this rank's
    rows and the global count of rows labelled >= 0, under a mesh
    (``shard``); the labels and None without one."""
    if shard is None:
        return labels, None
    return labels[shard.lo:shard.hi], (labels >= 0).sum()


def _all_reduce_step(shard, grads, scalars, rows):
    """The step's one all-reduce over the data axis: the gradients and
    the ``scalars`` (the loss, ``n_err``) summed, and each of ``rows``
    (this rank's rows of an output) gathered into the global batch's
    by a sum over zeros; all in the gradients' dtype (exact for the
    counts and indices it carries)."""
    mesh = shard.mesh
    dtype = grads[0].dtype
    n, i = mesh.shape["data"], mesh.coords["data"]
    flat = [g.reshape(-1) for g in grads]
    flat += [t.reshape(1).to(dtype) for t in scalars]
    for r in rows:
        block = r.reshape(r.shape[0], -1).to(dtype)
        full = block.new_zeros((n,) + tuple(block.shape))
        full[i] = block
        flat.append(full.reshape(-1))
    buf = mesh.all_reduce(torch.cat(flat), "data")
    out = iter(torch.split(buf, [t.numel() for t in flat]))
    grads = [next(out).view_as(g) for g in grads]
    scalars = [next(out).reshape(()).to(t.dtype) for t in scalars]
    rows = [next(out).reshape((n * r.shape[0],) + tuple(r.shape[1:])).to(
        r.dtype) for r in rows]
    return grads, scalars, rows


def _train_step(params, state, x, labels, specs, generator=None,
                hypers=None, with_output=False, mark=None,
                compute_dtype=None, shard=None, n_valid=None,
                gather_output=False):
    """One softmax step: ``(new_params, new_state, metrics)`` (see
    :func:`_grad_step` for ``mark``).  Under a mesh (``shard``, with the
    global ``n_valid``) the loss and ``n_err`` are the global batch's,
    and the output rows this rank's, or the global batch's with
    ``gather_output``."""
    sync = None
    if shard is not None and shard.mesh.distributed("data"):
        def sync(grads, loss, aux):
            n_err, probs, max_idx = aux
            rows = [probs, max_idx] if gather_output else []
            grads, (loss, n_err), rows = _all_reduce_step(
                shard, grads, [loss, n_err], rows)
            if gather_output:
                probs, max_idx = rows
            return grads, loss, (n_err, probs, max_idx)
    # the mesh's arguments only under a mesh: the single-device call is
    # the plain one
    on_mesh = {} if shard is None else {"shard": shard, "n_valid": n_valid}
    new_params, new_state, loss, (n_err, probs, max_idx) = _grad_step(
        params, state, specs, hypers,
        lambda p: _loss_and_stats(p, x, labels, specs, generator,
                                  compute_dtype, **on_mesh), mark, sync,
        x.is_cuda)
    metrics = {"loss": loss, "n_err": n_err}
    if with_output:
        metrics["output"] = probs
        metrics["max_idx"] = max_idx
    return new_params, new_state, metrics


def _train_step_mse(params, state, x, target, batch_size, specs,
                    generator=None, hypers=None, mark=None,
                    compute_dtype=None, shard=None, gather_output=False):
    """One MSE step: ``(new_params, new_state, {"loss", "output"})``;
    under a mesh as :func:`_train_step`."""
    sync = None
    if shard is not None and shard.mesh.distributed("data"):
        def sync(grads, loss, y):
            rows = [y.detach()] if gather_output else []
            grads, (loss,), rows = _all_reduce_step(shard, grads, [loss],
                                                    rows)
            return grads, loss, rows[0] if gather_output else y
    new_params, new_state, loss, y = _grad_step(
        params, state, specs, hypers,
        lambda p: _loss_mse(p, x, target, batch_size, specs, generator,
                            compute_dtype, **({} if shard is None
                                              else {"shard": shard})),
        mark, sync, x.is_cuda)
    return new_params, new_state, {"loss": loss, "output": y.detach()}


def flops_per_image(specs):
    """Forward FLOPs per sample (matmul and conv MACs x 2); a train
    step is about 3 x forward."""
    total = 0
    for spec in specs:
        if spec.kind == "fc":
            total += 2 * spec.n_in * spec.n_out
        elif spec.kind == "conv":
            ny, nx, k = spec.out_shape
            total += 2 * ny * nx * k * spec.kx * spec.ky * spec.n_channels
        elif spec.kind == "deconv":
            ny, nx, k = spec.in_shape
            total += 2 * ny * nx * k * spec.kx * spec.ky * spec.out_shape[2]
    return total


def _hypers_at(hypers_s, k):
    """Step ``k``'s hypers from a pytree whose leaves are host arrays
    with a leading step axis (a 0-d leaf holds for every step)."""
    def leaf(v):
        a = numpy.asarray(v)
        return float(a if a.ndim == 0 else a[k])
    return tree_map(leaf, hypers_s)


def stack_hypers(hypers, n_steps):
    """A window's per-step hypers: ``hypers`` with every leaf repeated
    along a leading axis of ``n_steps`` (host float64 arrays)."""
    return tree_map(lambda v: numpy.full(n_steps, v, numpy.float64),
                     hypers)


_TORCH_DTYPES = {numpy.dtype(numpy.float32): torch.float32,
                 numpy.dtype(numpy.float64): torch.float64}

#: the floating dtypes a ``compute_dtype`` may name, by the names the
#: JAX package's ``astype`` takes (the CLI's ``compute_dtype=bfloat16``)
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "half": torch.float16, "float32": torch.float32,
                   "single": torch.float32, "float64": torch.float64,
                   "double": torch.float64}


def compute_dtype_of(value):
    """The torch dtype of a ``compute_dtype``: None, a torch floating
    dtype, a numpy floating dtype or one of the names JAX's ``astype``
    takes (``"bfloat16"``, ``"float16"``, ``"float32"``, ``"float64"``
    and numpy's aliases); any other value raises ``TypeError``, as
    ``astype`` does."""
    if value is None or isinstance(value, torch.dtype) and \
            value.is_floating_point:
        return value
    name = value if isinstance(value, str) else getattr(
        value, "__name__", None)
    if name is None:
        try:
            name = numpy.dtype(value).name
        except TypeError:
            name = None
    if name not in _COMPUTE_DTYPES:
        raise TypeError("compute_dtype %r is not a floating dtype"
                        % (value,))
    return _COMPUTE_DTYPES[name]


class FusedNet:
    """Trainer for a feed-forward spec stack on one device, or on the
    ranks of a ``mesh`` (see the module's notes; every rank of the mesh
    builds the net from the same ``rand`` stream and ``dropout_seed``,
    and calls each entry point with the same global batch).

    ``device`` is the card (``cuda``) unless the caller passes "cpu";
    without CUDA it raises.  ``pool_impl`` picks every max pool's
    lowering ("offsets", "gather", "reshape" or the default
    "reduce_window"; "reshape" lowers avg pools too and needs windows
    that do not overlap); a pool tied to a depooling records its
    winners on the forward kernel whatever the choice.
    ``compute_dtype`` (see :func:`compute_dtype_of`; e.g. "bfloat16")
    runs the products in that dtype: the parameters and the optimizer
    state stay in ``dtype``, the gradient reaches them through the
    cast, the loss, the window accumulators and :meth:`predict`'s
    answer are float32 and :meth:`set_dataset` stores the rows in it
    (JAX :1317, :1369-1395, :1490, :1663, :1915).  ``dropout_seed`` seeds
    the net's ``torch.Generator``.  ``objective`` is "softmax" (a softmax head,
    :meth:`step` and the softmax windows) or "mse" (no softmax layer,
    :meth:`step_mse` and the MSE windows, whose stats follow
    ``mse_root`` and ``class_targets`` as they stand at each window).
    Under a mesh the net runs on the mesh's device for this rank where
    the mesh maps one, else on ``device``."""

    def __init__(self, layers, input_sample_shape, mesh=None, rand=None,
                 dtype=numpy.float32, defaults=None, dropout_seed=0,
                 compute_dtype=None, pool_impl=None, objective="softmax",
                 device=None):
        if objective not in ("softmax", "mse"):
            raise ValueError("unknown objective %r" % (objective,))
        if pool_impl not in (None, "reduce_window", "offsets", "gather",
                             "reshape"):
            raise ValueError("unknown pool_impl %r" % (pool_impl,))
        self.compute_dtype = compute_dtype_of(compute_dtype)
        if mesh is not None and mesh.device is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError("device %s is not the mesh's %s for rank "
                                 "%d" % (device, mesh.device, mesh.rank))
            device = mesh.device
        self.device = default_device(device)
        #: whether the spans of the steps are timed on the card
        self._on_card = self.device.type == "cuda"
        self.mesh = mesh
        #: the mesh's data and model extents (1 and 1 without one)
        self._dp = mesh_mod.data_parallel_size(mesh)
        self._mp = mesh_mod.model_parallel_size(mesh)
        full_f32(self.device)
        deterministic(self.device)
        self.specs = build_specs(layers, input_sample_shape, defaults)
        for spec in self.specs:
            if spec.kind == "pool" and not spec.record_offsets:
                if pool_impl == "reshape" and \
                        tuple(spec.sliding) != (spec.kx, spec.ky):
                    raise ValueError(
                        "pool_impl='reshape' needs sliding == kernel "
                        "(got %r vs (%d, %d))"
                        % (spec.sliding, spec.kx, spec.ky))
                spec.impl = pool_impl or "reduce_window"
            if self._param_split(spec):
                per = spec.n_out // self._mp
                m = mesh.coords["model"]
                spec.rows = (m * per, (m + 1) * per)
        if objective == "mse":
            if any(s.is_softmax for s in self.specs):
                raise ValueError(
                    "the mse objective does not take a softmax head")
        elif not self.specs[-1].is_softmax:
            raise ValueError(
                "the fused softmax objective needs a 'softmax' head "
                "(got %r); pass objective='mse' for regression and "
                "autoencoder topologies" % self.specs[-1].type)
        elif any(s.is_softmax for s in self.specs[:-1]):
            raise ValueError(
                "softmax is only supported as the head of a fused net")
        self.input_sample_shape = _normalize_sample_shape(input_sample_shape)
        self.objective = objective
        self.dtype = numpy.dtype(dtype)
        self._tdtype = _TORCH_DTYPES[self.dtype]
        #: the dtype of the loss, the accumulators and predict's answer
        self._out_tdtype = torch.float32 if self.compute_dtype is not None \
            else self._tdtype
        self._win_acc = None
        self._data_d = self._labels_d = self._targets_d = None
        self._data_p = self._labels_p = self._targets_p = None
        #: the stochastic pools draw from the generator in inference too
        self._has_stochastic = any(
            s.kind == "pool" and s.mode.startswith("stochastic")
            for s in self.specs)
        #: the MSE windows' stats, read at every window: the evaluator's
        #: ``root`` and the nearest-class-target matrix (None: no n_err)
        self.mse_root = True
        self.class_targets = None
        #: the softmax windows' ``max_err_sum`` scale: the evaluator's
        #: ``mean`` (err_output divided by the batch size, or not)
        self.stats_mean = True
        self._ct_cache = None
        params_host = init_params(self.specs, rand, self.dtype)
        self.params = self._place(self._local_rows(params_host))
        self.state = init_opt_state(self.specs, self.params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(dropout_seed))
        #: live hyperparameters (python floats), used by :meth:`step`
        self.hypers = default_hypers(self.specs)

    # -- the mesh -------------------------------------------------------------
    @property
    def data_shards(self):
        """The mesh's data-parallel extent (1 without a mesh)."""
        return self._dp

    def _param_split(self, spec):
        """Whether ``spec``'s parameters split over the model axis (JAX's
        ``_param_spec``, :1184-1191): an FC layer whose ``n_out`` divides
        by it.  A layer with an ortho term stays whole: the term sums
        over all its rows."""
        return (spec.kind == "fc" and self._mp > 1
                and spec.n_out % self._mp == 0
                and not spec.flags.get("ortho"))

    def _local_rows(self, tree):
        """A per-spec tree of whole host arrays or tensors (parameters,
        optimizer slots) cut to this rank's rows of each split layer."""
        out = []
        for spec, leaf in zip(self.specs, tree):
            rows = getattr(spec, "rows", None)
            if rows is not None:
                leaf = tree_map(lambda a: a[rows[0]:rows[1]], leaf)
            out.append(leaf)
        return out

    def _whole(self, tree):
        """A per-spec tree of this rank's tensors with each split layer
        gathered whole over the model axis (a collective: every rank of
        the model line calls it)."""
        out = []
        for spec, leaf in zip(self.specs, tree):
            if getattr(spec, "rows", None) is not None:
                leaf = tree_map(
                    lambda t: self.mesh.all_gather(t, "model", 0)
                    if isinstance(t, torch.Tensor) else t, leaf)
            out.append(leaf)
        return out

    def _shard(self, batch):
        """This rank's :data:`Shard` of a global batch of ``batch`` rows
        (None without a mesh); raises when the data axis does not divide
        it."""
        if self.mesh is None:
            return None
        mesh_mod.check_data_batch(self.mesh, batch)
        b = batch // self._dp
        lo = self.mesh.coords["data"] * b
        return Shard(self.mesh, lo, lo + b, int(batch))

    def _rows(self, batch):
        """``(lo, hi)``: this rank's rows of a global batch."""
        shard = self._shard(batch)
        return (0, batch) if shard is None else (shard.lo, shard.hi)

    #: how :meth:`fold_shards` folds each leaf over the data axis
    _FOLDS = {"n_err": "sum", "confusion": "sum", "max_err_sum": "max",
              "metrics": "sum_max_min", "output": "rows",
              "max_idx": "rows", "mse_per": "rows"}

    def fold_shards(self, tree):
        """Under a data mesh, a dict of this rank's window statistics
        (``n_err``, ``confusion`` and ``max_err_sum``, or the MSE
        ``metrics`` and ``n_err``: partials over its rows) and of its
        rows of the last step (``output``, ``max_idx``, ``mse_per``),
        folded over the data axis as JAX folds its per-shard partials
        (``_fold``, :959): counts summed, the max maxed, the MSE
        ``[sum, max, min]`` each by its own, the rows gathered.  One
        all-reduce in float64 (exact for the counts and for every float
        it carries; a sum of the ranks' float partials reassociates).
        The tree itself without a mesh."""
        if self.mesh is None or not self.mesh.distributed("data"):
            return tree
        n, i = self._dp, self.mesh.coords["data"]
        keys = list(tree)
        flat = [tree[k].reshape(-1).to(torch.float64) for k in keys]
        sizes = [f.numel() for f in flat]
        buf = torch.zeros((n, sum(sizes)), dtype=torch.float64,
                          device=self.device)
        buf[i] = torch.cat(flat)
        self.mesh.all_reduce(buf, "data")
        out = {}
        for k, part in zip(keys, torch.split(buf, sizes, dim=1)):
            leaf, how = tree[k], self._FOLDS[k]
            if how == "rows":
                v = part.reshape((n * leaf.shape[0],) + tuple(leaf.shape[1:]))
            elif how == "sum":
                v = part.sum(dim=0).reshape(leaf.shape)
            elif how == "max":
                v = part.max(dim=0).values.reshape(leaf.shape)
            else:
                v = torch.stack([part[:, 0].sum(), part[:, 1].max(),
                                 part[:, 2].min()])
            out[k] = v.to(leaf.dtype)
        return out

    # -- placement ----------------------------------------------------------
    def _place(self, tree):
        """A pytree of host arrays as tensors on the net's device,
        floating leaves in the net's dtype."""
        def put(v):
            t = torch.as_tensor(numpy.asarray(v))
            if t.is_floating_point():
                t = t.to(self._tdtype)
            return t.to(self.device)
        return tree_map(put, tree)

    def _batch(self, x, labels=None, rows=None):
        """A host or device batch on the net's device; ``rows`` (lo, hi)
        cuts ``x`` to them before the copy (the labels stay whole)."""
        x = torch.as_tensor(x)
        if rows is not None:
            x = x[rows[0]:rows[1]]
        x = x.to(self.device, self._tdtype)
        if labels is None:
            return x, None
        return x, torch.as_tensor(labels).to(self.device, torch.int32)

    # -- cost accounting ------------------------------------------------------
    def _cost(self, name, steps, batch, train=True):
        """The profiler's count of the first dispatch of ``name`` (JAX
        :1229-1250): a train step's analytic FLOPs are 3 x the forward's
        (the MFU convention), a predict's 1 x.  A registered name costs
        one dict lookup; the spec walk runs for the first dispatch only.
        Call sites guard with ``profiler.enabled()``."""
        if profiler.cost_entry(name) is not None:
            return _UNCOUNTED
        fpi = flops_per_image(self.specs)
        mult = 3.0 if train else 1.0
        return profiler.count_cost(
            name, analytic_flops=mult * fpi * int(batch) * int(steps),
            steps=int(steps), batch=int(batch),
            analytic_flops_per_image=mult * fpi)

    # -- steps --------------------------------------------------------------
    def _need(self, objective, what):
        if self.objective != objective:
            raise ValueError("%s needs the %s objective (this net's is %s)"
                             % (what, objective, self.objective))

    def step(self, x, labels, hypers=None, mark=None):
        """One train step on a host or device batch.  Returns {"loss",
        "n_err", "output", "max_idx"} as device tensors.  ``hypers``
        overrides the live hyperparameters for this step; ``mark`` is
        passed to the step (see :func:`_grad_step`)."""
        self._need("softmax", "step")
        batch = len(x)
        shard = self._shard(batch)
        x, labels = self._batch(x, labels, None if shard is None
                                else (shard.lo, shard.hi))
        labels, n_valid = _rank_labels(labels, shard)
        with self._cost("fused.step", 1, batch) \
                if profiler.enabled() else _UNCOUNTED, \
                telemetry.span("fused.step", device=self._on_card):
            self.params, self.state, metrics = _train_step(
                self.params, self.state, x, labels, self.specs, self._gen,
                self.hypers if hypers is None else hypers, with_output=True,
                mark=mark, compute_dtype=self.compute_dtype, shard=shard,
                n_valid=n_valid, gather_output=True)
        return metrics

    def step_mse(self, x, target, batch_size=None, hypers=None, mark=None):
        """One MSE train step on a host or device batch against
        ``target``; rows at or past ``batch_size`` (all by default) are
        masked.  Returns {"loss", "output"} as device tensors."""
        self._need("mse", "step_mse")
        batch = len(x)
        shard = self._shard(batch)
        rows = None if shard is None else (shard.lo, shard.hi)
        x, _ = self._batch(x, rows=rows)
        t = self._batch(target, rows=rows)[0]
        with self._cost("fused.step_mse", 1, batch) \
                if profiler.enabled() else _UNCOUNTED, \
                telemetry.span("fused.step", device=self._on_card):
            self.params, self.state, metrics = _train_step_mse(
                self.params, self.state, x, t,
                batch if batch_size is None else int(batch_size),
                self.specs, self._gen,
                self.hypers if hypers is None else hypers, mark,
                self.compute_dtype, shard, gather_output=True)
        return metrics

    def run_steps(self, xs, labels_s):
        """Train steps over stacked minibatches ``xs (K, B, ...)``,
        ``labels_s (K, B)``; returns the per-step {"loss", "n_err"}
        stacked on the device."""
        self._need("softmax", "run_steps")
        losses, errs = [], []
        for x, lbl in zip(xs, labels_s):
            shard = self._shard(len(x))
            x, lbl = self._batch(x, lbl, None if shard is None
                                 else (shard.lo, shard.hi))
            lbl, n_valid = _rank_labels(lbl, shard)
            self.params, self.state, m = _train_step(
                self.params, self.state, x, lbl, self.specs, self._gen,
                self.hypers, compute_dtype=self.compute_dtype, shard=shard,
                n_valid=n_valid)
            losses.append(m["loss"])
            errs.append(m["n_err"])
        return {"loss": torch.stack(losses), "n_err": torch.stack(errs)}

    # -- device-resident data -------------------------------------------------
    def set_dataset(self, data, labels, targets=None):
        """Place the whole training set on the device once (rows and
        the MSE objective's ``targets`` in the net's dtype, labels int32;
        no labels: -1 each).  Under a ``compute_dtype`` the rows are
        stored in it, since the forward's cast commutes with the row
        gather, and the targets in float32, which the loss reads
        unrounded (JAX :1369-1395)."""
        self._data_d, self._labels_d = self._batch(
            numpy.ascontiguousarray(data),
            numpy.full(len(data), -1, numpy.int32)
            if labels is None or not len(labels) else labels)
        if self.compute_dtype is not None:
            self._data_d = self._data_d.to(self.compute_dtype)
        self._targets_d = None if targets is None else self._batch(
            numpy.ascontiguousarray(targets))[0].to(self._out_tdtype)
        self._data_p = self._labels_p = self._targets_p = None

    @property
    def has_dataset(self):
        return self._data_d is not None

    def set_epoch_perm(self, perm, pad):
        """The epoch's shuffled dataset on the device, once per
        reshuffle: ``data_p[i] = data[perm[i]]`` (and the targets') plus
        ``pad`` zero rows labelled -1, so every window's slices stay in
        range."""
        if not self.has_dataset:
            raise RuntimeError("set_dataset() before set_epoch_perm")

        def permuted(arr, fill):
            rows = arr.index_select(0, p)
            return torch.cat([rows, rows.new_full(
                (int(pad),) + tuple(rows.shape[1:]), fill)])
        with telemetry.span("fused.epoch_perm"):
            p = torch.as_tensor(numpy.array(perm, dtype=numpy.int64)).to(
                self.device)
            self._data_p = permuted(self._data_d, 0)
            self._labels_p = permuted(self._labels_d, -1)
            self._targets_p = None if self._targets_d is None else \
                permuted(self._targets_d, 0)

    @property
    def has_epoch_perm(self):
        return self._data_p is not None

    # -- windows --------------------------------------------------------------
    def _run_window(self, form, n_steps, batch, fetch, batch_sizes,
                    hypers_s):
        """K steps; ``fetch(k)`` gives step k's ``(x, labels)`` on the
        device; ``batch_sizes (K,)`` masks padded rows; ``hypers_s`` is
        the hyper pytree with a leading K axis (:func:`stack_hypers`).
        Stats fold on the device; nothing is read back.  ``form`` names
        the window in the cost registry (``fused.window.<form>.k<K>``)."""
        self._need("softmax", "a softmax window")
        with self._cost("fused.window.%s.k%d" % (form, n_steps), n_steps,
                        batch) if profiler.enabled() else _UNCOUNTED, \
                telemetry.span("fused.window", form=form, steps=n_steps):
            return self._window_steps(n_steps, batch, fetch, batch_sizes,
                                      hypers_s)

    def _window_steps(self, n_steps, batch, fetch, batch_sizes, hypers_s):
        """The softmax window's loop: ``fetch(k)`` gives this rank's
        rows of step k and the global batch's labels; the stats are
        this rank's partials (:meth:`fold_shards` folds them)."""
        shard = self._shard(batch)
        n_classes = int(self.specs[-1].n_out)
        nerr = torch.zeros(2, dtype=torch.int32, device=self.device)
        conf = torch.zeros((n_classes, n_classes), dtype=torch.int32,
                           device=self.device)
        mx = torch.zeros((), dtype=self._out_tdtype, device=self.device)
        rows = torch.arange(batch, device=self.device)
        sizes = numpy.asarray(batch_sizes, dtype=numpy.int64)
        losses = []
        m = None
        for k in range(n_steps):
            with telemetry.span("fused.step", device=self._on_card):
                with telemetry.span("fused.fetch"):
                    x, lbl = fetch(k)
                    bs = int(sizes[k])
                    lbl = torch.where(rows < bs, lbl, -1)
                    lbl, n_valid = _rank_labels(lbl, shard)
                hy = _hypers_at(hypers_s, k)
                self.params, self.state, m = _train_step(
                    self.params, self.state, x, lbl, self.specs, self._gen,
                    hy, with_output=True, compute_dtype=self.compute_dtype,
                    shard=shard, n_valid=n_valid)
                with telemetry.span("fused.stats"):
                    d_nerr, d_conf, d_mx = evaluator.eval_stats(
                        m["output"], m["max_idx"], lbl, bs, n_classes,
                        mean=self.stats_mean)
                    nerr, conf = nerr + d_nerr, conf + d_conf
                    mx = torch.maximum(mx, d_mx)
            losses.append(m["loss"])
        with telemetry.span("fused.stats"):
            acc = self._window_acc()
            acc = {"n_err": acc["n_err"] + nerr,
                   "confusion": acc["confusion"] + conf,
                   "max_err_sum": torch.maximum(acc["max_err_sum"], mx)}
        self._win_acc = acc
        return {"loss": torch.stack(losses), "n_err": nerr,
                "confusion": conf, "max_err_sum": mx,
                "output": m["output"], "max_idx": m["max_idx"],
                "acc": acc}

    def _stacked(self, arr, dtype=None):
        """A host-stacked window array on the device (a tensor already
        there is taken as it is)."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(numpy.ascontiguousarray(arr))
        return arr.to(self.device, dtype or self._tdtype)

    def run_window(self, xs, labels_s, batch_sizes, hypers_s):
        """Windowed training over host-stacked minibatches ``xs (K, B,
        ...)`` and ``labels_s (K, B)`` (host arrays, or tensors already
        on the device); rows at or past ``batch_sizes[k]`` are
        masked."""
        xs = self._stacked(xs)
        labels_s = self._stacked(labels_s, torch.int32)
        lo, hi = self._rows(xs.shape[1])
        return self._run_window("stacked", xs.shape[0], xs.shape[1],
                                lambda k: (xs[k][lo:hi], labels_s[k]),
                                batch_sizes, hypers_s)

    def run_window_indexed(self, idx_s, batch_sizes, hypers_s):
        """Windowed training over the device dataset (:meth:`set_dataset`)
        from dataset row indices ``idx_s (K, B)`` (-1: a padded slot), a
        host array or a tensor (already on the device: no copy)."""
        if not self.has_dataset:
            raise RuntimeError("set_dataset() before run_window_indexed")
        if not isinstance(idx_s, torch.Tensor):
            idx_s = torch.as_tensor(numpy.asarray(idx_s, numpy.int64))
        idx_s = idx_s.to(self.device, torch.int64)
        lo, hi = self._rows(idx_s.shape[1])

        def fetch(k):
            idx = idx_s[k]
            safe = idx.clamp(min=0)
            lbl = torch.where(idx < 0, -1,
                              self._labels_d.index_select(0, safe))
            return self._data_d.index_select(0, safe[lo:hi]), lbl
        return self._run_window("indexed", idx_s.shape[0], idx_s.shape[1],
                                fetch, batch_sizes, hypers_s)

    def run_window_sliced(self, starts, batch, batch_sizes, hypers_s):
        """Windowed training over the epoch's shuffled dataset
        (:meth:`set_epoch_perm`): step k reads rows ``starts[k]`` to
        ``starts[k] + batch`` (host ints; a start past the end is
        clamped as ``dynamic_slice`` clamps it)."""
        if not self.has_epoch_perm:
            raise RuntimeError("set_epoch_perm() before run_window_sliced")
        starts = numpy.asarray(starts, dtype=numpy.int64)
        batch = int(batch)
        last = self._data_p.shape[0] - batch
        lo, hi = self._rows(batch)

        def fetch(k):
            s = min(max(int(starts[k]), 0), last)
            return self._data_p[s + lo:s + hi], self._labels_p[s:s + batch]
        return self._run_window("sliced", len(starts), batch, fetch,
                                batch_sizes, hypers_s)

    # -- MSE windows ----------------------------------------------------------
    def _class_targets_tensor(self):
        """``class_targets`` on the device in the net's dtype, uploaded
        again only when its values change; None without them."""
        if self.class_targets is None:
            self._ct_cache = None
            return None
        ct = numpy.ascontiguousarray(self.class_targets, dtype=self.dtype)
        key = (ct.shape, ct.tobytes())
        if self._ct_cache is None or self._ct_cache[0] != key:
            self._ct_cache = (key, torch.from_numpy(ct.copy()).to(
                self.device, self._out_tdtype))
        return self._ct_cache[1]

    def _run_window_mse(self, form, n_steps, batch, fetch, batch_sizes,
                        hypers_s):
        """K MSE steps; ``fetch(k)`` gives step k's ``(x, labels,
        targets)`` on the device.  Each step's evaluator stats (the
        ``[sum, max, min]`` of :func:`evaluator.mse` with ``mse_root``,
        and the nearest-class-target ``n_err`` where ``class_targets``
        is set) fold on the device into the window's and then the epoch
        accumulator's, in the JAX package's order; nothing is read
        back.  ``form`` names the window in the cost registry."""
        self._need("mse", "an MSE window")
        with self._cost("fused.window.%s.k%d" % (form, n_steps), n_steps,
                        batch) if profiler.enabled() else _UNCOUNTED, \
                telemetry.span("fused.window", form=form, steps=n_steps):
            return self._window_steps_mse(n_steps, batch, fetch,
                                          batch_sizes, hypers_s)

    def _window_steps_mse(self, n_steps, batch, fetch, batch_sizes,
                          hypers_s):
        """The MSE window's loop: ``fetch(k)`` gives this rank's rows and
        targets of step k and the global batch's labels; the stats are
        this rank's partials (:meth:`fold_shards` folds them)."""
        shard = self._shard(batch)
        lo, hi = self._rows(batch)
        root, ct = bool(self.mse_root), self._class_targets_tensor()
        zero = torch.zeros((), dtype=self._out_tdtype, device=self.device)
        msum, mmax, mmin = zero, zero, zero + float("inf")
        nerr = torch.zeros(2, dtype=torch.int32, device=self.device)
        rows = torch.arange(batch, device=self.device)
        sizes = numpy.asarray(batch_sizes, dtype=numpy.int64)
        losses = []
        m = mse_per = None
        for k in range(n_steps):
            with telemetry.span("fused.step", device=self._on_card):
                with telemetry.span("fused.fetch"):
                    x, lbl, t = fetch(k)
                bs = int(sizes[k])
                # the rows of this rank's part that are in the batch
                bs_local = min(max(bs - lo, 0), hi - lo)
                self.params, self.state, m = _train_step_mse(
                    self.params, self.state, x, t, bs, self.specs,
                    self._gen, _hypers_at(hypers_s, k),
                    compute_dtype=self.compute_dtype, shard=shard)
                with telemetry.span("fused.stats"):
                    _, md, mse_per = evaluator.mse(
                        m["output"], t.to(self._out_tdtype), bs_local,
                        root=root)
                    msum = msum + md[0]
                    mmax = torch.maximum(mmax, md[1])
                    mmin = torch.minimum(mmin, md[2])
                    if ct is not None:
                        nerr = nerr + evaluator.nearest_target_errors(
                            m["output"], ct,
                            torch.where(rows < bs, lbl, -1)[lo:hi],
                            bs_local)
            losses.append(m["loss"])
        with telemetry.span("fused.stats"):
            acc = self._window_acc()
            acc = {"metrics": torch.stack([
                acc["metrics"][0] + msum,
                torch.maximum(acc["metrics"][1], mmax),
                torch.minimum(acc["metrics"][2], mmin)]),
                "n_err": acc["n_err"] + nerr}
        self._win_acc = acc
        return {"loss": torch.stack(losses),
                "metrics": torch.stack([msum, mmax, mmin]),
                "mse_per": mse_per, "n_err": nerr, "output": m["output"],
                "acc": acc}

    def run_window_mse_indexed(self, idx_s, batch_sizes, hypers_s):
        """K MSE steps over the device dataset with targets from dataset
        row indices ``idx_s (K, B)`` (-1: a padded slot), a host array or
        a tensor already on the device."""
        if self._targets_d is None:
            raise RuntimeError("set_dataset() with targets before "
                               "run_window_mse_indexed")
        if not isinstance(idx_s, torch.Tensor):
            idx_s = torch.as_tensor(numpy.asarray(idx_s, numpy.int64))
        idx_s = idx_s.to(self.device, torch.int64)
        lo, hi = self._rows(idx_s.shape[1])

        def fetch(k):
            idx = idx_s[k]
            safe = idx.clamp(min=0)
            lbl = torch.where(idx < 0, -1,
                              self._labels_d.index_select(0, safe))
            mine = safe[lo:hi]
            return (self._data_d.index_select(0, mine), lbl,
                    self._targets_d.index_select(0, mine))
        return self._run_window_mse("mse_indexed", idx_s.shape[0],
                                    idx_s.shape[1], fetch, batch_sizes,
                                    hypers_s)

    def run_window_mse(self, xs, ts, lbl_s, batch_sizes, hypers_s):
        """K MSE steps over host-stacked minibatches ``xs (K, B, ...)``
        and targets ``ts (K, B, ...)``; ``lbl_s (K, B)`` feeds the
        nearest-class-target ``n_err`` where ``class_targets`` is set
        (-1s otherwise).  Host arrays, or tensors already on the
        device."""
        xs, ts = self._stacked(xs), self._stacked(ts)
        lbl_s = self._stacked(lbl_s, torch.int32)
        lo, hi = self._rows(xs.shape[1])
        return self._run_window_mse(
            "mse", xs.shape[0], xs.shape[1],
            lambda k: (xs[k][lo:hi], lbl_s[k], ts[k][lo:hi]),
            batch_sizes, hypers_s)

    def run_window_mse_sliced(self, starts, batch, batch_sizes, hypers_s):
        """K MSE steps over the epoch's shuffled dataset and targets
        (:meth:`set_epoch_perm` after :meth:`set_dataset` with targets):
        step k reads rows ``starts[k]`` to ``starts[k] + batch``."""
        if not self.has_epoch_perm or self._targets_p is None:
            raise RuntimeError("set_epoch_perm() with targets before "
                               "run_window_mse_sliced")
        starts = numpy.asarray(starts, dtype=numpy.int64)
        batch = int(batch)
        last = self._data_p.shape[0] - batch
        lo, hi = self._rows(batch)

        def fetch(k):
            s = min(max(int(starts[k]), 0), last)
            return (self._data_p[s + lo:s + hi],
                    self._labels_p[s:s + batch],
                    self._targets_p[s + lo:s + hi])
        return self._run_window_mse("mse_sliced", len(starts), batch,
                                    fetch, batch_sizes, hypers_s)

    # -- the epoch accumulator ----------------------------------------------
    def window_acc_zeros(self):
        """Host zeros of the epoch accumulator (the MSE metrics' min at
        inf)."""
        out_dtype = numpy.float32 if self.compute_dtype is not None \
            else self.dtype
        if self.objective == "mse":
            return {"metrics": numpy.array([0, 0, numpy.inf], out_dtype),
                    "n_err": numpy.zeros(2, numpy.int32)}
        n_classes = int(self.specs[-1].n_out)
        return {"n_err": numpy.zeros(2, numpy.int32),
                "confusion": numpy.zeros((n_classes, n_classes),
                                         numpy.int32),
                "max_err_sum": numpy.zeros((), out_dtype)}

    def _window_acc(self):
        if self._win_acc is None:
            # zeros made on the device: a copy from the host would block
            self._win_acc = tree_map(
                lambda a: torch.zeros_like(torch.from_numpy(a),
                                           device=self.device),
                self.window_acc_zeros())
            if self.objective == "mse":
                self._win_acc["metrics"][2] = float("inf")
        return self._win_acc

    @property
    def window_acc(self):
        """The epoch accumulator on the device (None after a reset)."""
        return self._win_acc

    def window_acc_host(self):
        """One host copy of the epoch accumulator, or None; under a data
        mesh folded over it first (:meth:`fold_shards`, a collective)."""
        if self._win_acc is None:
            return None
        return self.host_fetch(self.fold_shards(self._win_acc))

    def reset_window_acc(self):
        """Zero the epoch accumulator (at every epoch boundary)."""
        self._win_acc = None

    def set_window_acc(self, acc):
        """Restore a host copy of the accumulator (:meth:`window_acc_host`
        output, or None for zeros) — a mid-segment snapshot's.  Under a
        data mesh the folded values go to the ranks at data coordinate 0
        and zeros to the others, so that the next fold gives them
        back."""
        if acc is None:
            self._win_acc = None
            return
        if self.mesh is not None and self.mesh.coords["data"] != 0:
            acc = self.window_acc_zeros()

        def put(v):
            t = torch.as_tensor(numpy.asarray(v))
            if t.is_floating_point():
                t = t.to(self._out_tdtype)
            return t.to(self.device)
        self._win_acc = tree_map(put, acc)

    # -- reads ----------------------------------------------------------------
    def host_fetch(self, tree):
        """Host numpy copies of a pytree of tensors, in one readback
        (:func:`znicz_tpu_torch.core.memory.host_fetch`), behind the
        ``fused.host_fetch`` fault site.  Like the dispatch site it is
        not retried in place: the supervised launcher's restart and
        mid-epoch resume are the recovery.  Metered on the telemetry d2h
        counters as one call (JAX :2160-2190)."""
        if faults.enabled():
            faults.check("fused.host_fetch")
        with telemetry.span("fused.readback"):
            host = memory.host_fetch(tree)
        if telemetry.enabled():
            nbytes = []
            tree_map(lambda v: nbytes.append(v.nbytes)
                     if isinstance(v, numpy.ndarray) else None, host)
            telemetry.add_bytes("d2h", sum(nbytes))
        return host

    def params_finite(self):
        """Whether every parameter is finite: one reduction on the
        device and one readback (under a model axis, agreed over it)."""
        ok = torch.stack([torch.isfinite(t).all()
                          for p in self.params for t in p.values()]).all()
        if self._mp > 1 and self.mesh.distributed("model"):
            ok = self.mesh.all_reduce(ok.to(torch.int32), "model", "min")
        return bool(ok)

    def _forward_eval(self, x):
        """The forward of a global batch; under a mesh of this rank's
        rows, gathered over the data axis."""
        shard = self._shard(x.shape[0])
        if shard is not None:
            x = x[shard.lo:shard.hi]
        with torch.no_grad():
            y = forward(self.params, x, self.specs,
                        generator=self._gen if self._has_stochastic
                        else None, compute_dtype=self.compute_dtype,
                        shard=shard)
            y = y.to(self._out_tdtype)
        return y if shard is None else self.mesh.gather_rows(y)

    def predict(self, x):
        """The output of a batch (softmax, or the MSE objective's
        regression), on the device."""
        x, _ = self._batch(x)
        with self._cost("fused.predict.b%d" % x.shape[0], 1, x.shape[0],
                        train=False) if profiler.enabled() else _UNCOUNTED:
            return self._forward_eval(x)

    def predict_with_idx(self, x):
        """(softmax output, int32 argmax) of a batch, on the device."""
        x, _ = self._batch(x)
        with self._cost("fused.predict_idx.b%d" % x.shape[0], 1,
                        x.shape[0], train=False) \
                if profiler.enabled() else _UNCOUNTED:
            probs = self._forward_eval(x)
            return probs, torch.argmax(probs, dim=1).to(torch.int32)

    def host_params(self):
        """The parameters as host arrays, one dict a layer; a layer split
        over the model axis gathered whole (a collective there)."""
        return memory.host_fetch(self._whole(self.params))

    # -- checkpoint / resume --------------------------------------------------
    def state_dict(self):
        """Parameters, optimizer slots, the generator's state and the
        live hypers as host values: resuming from it is exact."""
        sd = train_state_to_numpy(self._whole(self.params),
                                  self._whole(self.state), self.hypers)
        sd["key"] = self._gen.get_state().numpy()
        return sd

    def device_state(self):
        """Clones of the parameters and optimizer slots on the device,
        the generator's state (a small host tensor, as PyTorch keeps
        it) and the live hypers: :meth:`state_dict` without a copy to
        the host."""
        def clone(t):
            return t.clone() if isinstance(t, torch.Tensor) else t
        return {"params": tree_map(clone, self.params),
                "opt": tree_map(clone, self.state),
                "key": self._gen.get_state(),
                "hypers": tree_map(clone, self.hypers)}

    def load_device_state(self, sd):
        """Restore a :meth:`device_state` (its tensors cloned again, so
        the state can be restored more than once)."""
        def clone(t):
            return t.clone() if isinstance(t, torch.Tensor) else t
        self.params = tree_map(clone, sd["params"])
        self.state = tree_map(clone, sd["opt"])
        self.hypers = tree_map(clone, sd["hypers"])
        self._gen.set_state(sd["key"].clone())

    def load_state_dict(self, sd):
        """Restore :meth:`state_dict` output.  ``"key"`` is optional (a
        state carried over from the JAX package has none the port can
        use) and must be this port's generator state."""
        params, state, hypers = train_state_from_numpy(
            sd, self.device, self._tdtype)
        self.params = self._local_rows(params)
        self.state = self._local_rows(state)
        if hypers is not None:
            self.hypers = hypers
        key = sd.get("key")
        if key is not None:
            key = numpy.asarray(key)
            if key.dtype != numpy.uint8:
                raise ValueError("'key' of dtype %s is not a torch "
                                 "generator state" % key.dtype)
            self._gen.set_state(torch.from_numpy(key.copy()))


class FusedMLP(FusedNet):
    """:class:`FusedNet` for a fully-connected stack over a flat input
    (JAX :2260); any other layer type raises before a draw is made."""

    def __init__(self, layers, input_sample_size, **kwargs):
        build_fc_specs(layers, int(input_sample_size),
                       kwargs.get("defaults"))
        super(FusedMLP, self).__init__(
            layers, int(input_sample_size), **kwargs)
