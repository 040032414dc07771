"""The fused training unit — the whole train step inside the unit graph.

Counterpart of ``znicz_tpu/units/fused_trainer.py`` (``GDProxy``
:105, ``FusedForwardBackward`` :179-1010).  The unit graph stays the
epoch-level control plane (loader -> train step -> evaluator ->
decision -> snapshotter), and the per-minibatch forward, backward and
update run in :class:`znicz_tpu_torch.parallel.fused.FusedNet`.
:class:`FusedForwardBackward` stands for the whole forwards + GD chain
and exposes ``output`` / ``max_idx`` as the last forward would.

TRAIN minibatches run in windows of up to ``window`` steps over the
dataset on the device (``FusedNet.run_window_indexed``): the unit
drives the loader itself to collect a window's row indices and never
crosses a segment boundary.  The control plane is asynchronous: a
mid-segment window reads nothing back — its stats ride the net's
device accumulator and the evaluator gets the deferred sentinel — and
the segment-final window reads the accumulator, the output and the
argmax back in ONE copy.  Index windows are staged in a ring of
``pipeline_depth + 1`` host buffers (pinned on the card, copied
without blocking), each reused only after the event recorded behind
its copy has passed; dispatched windows are bounded at
``pipeline_depth`` by events, a completion wait and not a transfer.
VALID minibatches run through ``FusedNet.predict_with_idx``.

With ``loss="mse"`` the unit trains against the loader's targets: its
windows are ``FusedNet.run_window_mse_indexed`` over the dataset and its
targets on the device (the JAX trainer takes the sliced window here,
over the same rows), the segment-final readback carries the
``[sum, max, min]`` metrics, the nearest-class-target ``n_err``, the
output and the per-sample MSE, and VALID minibatches run through
``FusedNet.predict``.

A window's hypers are taken step by step: after each minibatch it
collects, the unit calls ``hyper_tick`` (the learning-rate adjuster's
``run``, set by ``StandardWorkflow.link_lr_adjuster``), so a schedule
boundary inside a window takes effect at its own step, as in the unit
graph.  A window in which no hyper changed reuses its stacked hypers.

Not in this slice of the port (each raises, see ``ROADMAP.md``): the
host-stacked window (a window over a loader whose fill the device
gather cannot replay), the JAX trainer's other keys
(:attr:`FusedForwardBackward.LATER_KEYS`: the mesh, the sliced window,
the synchronous per-window readback, ...), ``FusedNNRollback``, and the
fault, health and profiler hooks.
"""

import collections
import copy

import numpy
import torch

from znicz_tpu_torch.core import memory, prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import (TRAIN, FullBatchLoader,
                                         FullBatchLoaderMSEMixin)
from znicz_tpu_torch.parallel import fused

_LATER = "not in this slice of the port (see ROADMAP.md)"

#: ``window_stats`` of a mid-segment window: its stats ride the net's
#: device accumulator until the segment-final readback; the evaluator
#: takes it as consumed
DEFERRED_WINDOW_STATS = {"deferred": True}


class _StagingRing(object):
    """Rotating host buffers for windows of row indices.

    ``depth`` buffers rotate round robin.  On the card each is pinned
    and uploaded without blocking, so the host must not refill one
    before its copy ran: the event recorded behind the copy is waited
    on before the buffer is handed out again."""

    def __init__(self, depth, device):
        self.depth = max(1, int(depth))
        self.device = device
        self._slots = [None] * self.depth   # [host tensor, event]
        self._turn = 0
        self._last = None                   # the slot get() handed out

    def get(self, shape):
        """The next buffer, ``(K, B)`` int64, as a writable numpy array."""
        i = self._turn
        self._turn = (i + 1) % self.depth
        slot = self._slots[i]
        if slot is not None and slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        if slot is None or tuple(slot[0].shape) != tuple(shape):
            host = torch.empty(tuple(shape), dtype=torch.int64,
                               pin_memory=self.device.type == "cuda")
            slot = self._slots[i] = [host, None]
        self._last = slot
        return slot[0].numpy()

    def upload(self, n):
        """The first ``n`` rows of the buffer :meth:`get` handed out
        last, on the device."""
        slot = self._last
        rows = slot[0][:n]
        if self.device.type != "cuda":
            return rows.clone()   # a CPU tensor would alias the buffer
        dev = rows.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return dev


def _stack_trees(trees, dtype):
    """Pytrees of one structure (dicts and lists of floats) as one
    tree whose leaves are ``dtype`` arrays with a leading axis over
    ``trees``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees], dtype) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[i] for t in trees], dtype)
                for i in range(len(first))]
    return numpy.asarray(trees, dtype=dtype)


class GDProxy(object):
    """Hyperparameters of one fused layer — the attribute surface of a
    GD unit without its compute (and a ``gate_skip`` the learning-rate
    adjuster takes).  Every change of a value bumps ``serial``, the
    trainer's key for its collected hypers."""

    STATE_ATTRS = ("learning_rate", "learning_rate_bias",
                   "weights_decay", "weights_decay_bias",
                   "l1_vs_l2", "l1_vs_l2_bias",
                   "gradient_moment", "gradient_moment_bias",
                   "factor_ortho", "acc_alpha", "acc_beta",
                   "gd_alpha", "gd_beta")

    def __init__(self, name, hyper, hyper_bias):
        self.serial = 0
        self.name = name
        self.gate_skip = Bool(False)
        self.learning_rate = hyper["lr"]
        self.learning_rate_bias = hyper_bias["lr"]
        self.weights_decay = hyper["wd"]
        self.weights_decay_bias = hyper_bias["wd"]
        self.l1_vs_l2 = hyper["l1_vs_l2"]
        self.l1_vs_l2_bias = hyper_bias["l1_vs_l2"]
        self.gradient_moment = hyper["moment"]
        self.gradient_moment_bias = hyper_bias["moment"]
        self.factor_ortho = hyper["factor_ortho"]
        self.acc_alpha = hyper["acc_alpha"]
        self.acc_beta = hyper["acc_beta"]
        self.gd_alpha = hyper["gd_alpha"]
        self.gd_beta = hyper["gd_beta"]

    def __setattr__(self, name, value):
        if name in self.STATE_ATTRS and getattr(self, name, None) != value:
            object.__setattr__(self, "serial",
                               getattr(self, "serial", 0) + 1)
        object.__setattr__(self, name, value)

    def hyper_dicts(self):
        """``(hyper, hyper_bias)`` in ``gd_math.update``'s vocabulary."""
        common = dict(acc_alpha=self.acc_alpha, acc_beta=self.acc_beta,
                      gd_alpha=self.gd_alpha, gd_beta=self.gd_beta)
        hyper = dict(common, lr=float(self.learning_rate),
                     wd=float(self.weights_decay),
                     l1_vs_l2=float(self.l1_vs_l2),
                     moment=float(self.gradient_moment),
                     factor_ortho=float(self.factor_ortho))
        hyper_bias = dict(common, lr=float(self.learning_rate_bias),
                          wd=float(self.weights_decay_bias),
                          l1_vs_l2=float(self.l1_vs_l2_bias),
                          moment=float(self.gradient_moment_bias),
                          factor_ortho=0.0)
        return hyper, hyper_bias

    def state_dict(self):
        return {a: float(getattr(self, a)) for a in self.STATE_ATTRS}

    def load_state_dict(self, sd):
        for a, v in sd.items():
            if a in self.STATE_ATTRS:
                setattr(self, a, v)


class FusedForwardBackward(Unit):
    """One unit = the whole train or eval step over the layer stack.

    Demands ``input`` / ``minibatch_class`` / ``minibatch_size`` and
    ``labels`` (softmax) or ``target`` (``loss="mse"``) from the
    loader; provides ``output`` and, for softmax, ``max_idx``.  The
    ``fused`` config's keys: ``pool_impl`` (None is "reduce_window";
    "offsets" runs the hand-written kernels on the card; "gather"),
    ``dtype`` (default
    ``root.common.engine.precision_dtype``, else float32),
    ``dropout_seed`` and ``window`` (default 8 where the loader's rows
    can be gathered on the device, else 1: a step a minibatch)."""

    #: dispatched windows in flight before collection waits for the
    #: oldest; the staging ring holds one more
    PIPELINE_DEPTH = 2
    #: the JAX trainer's keys this slice of the port leaves out
    LATER_KEYS = ("mesh", "model_parallel", "compute_dtype", "defaults",
                  "device_data", "device_perm", "async_windows",
                  "pipeline_depth", "rand")

    def __init__(self, workflow, layers, pool_impl=None, dtype=None,
                 dropout_seed=0, window=None, loss="softmax", **kwargs):
        later = sorted(set(kwargs) & set(self.LATER_KEYS))
        if later:
            raise NotImplementedError(
                "fused %s %s" % (", ".join(later), _LATER))
        if loss not in ("softmax", "mse"):
            raise ValueError("unknown fused loss %r" % (loss,))
        super(FusedForwardBackward, self).__init__(workflow, **kwargs)
        self.layers = copy.deepcopy(list(layers))
        self.pool_impl = pool_impl
        self.dtype = dtype
        self.dropout_seed = dropout_seed
        self.window = None if window is None else int(window)
        self.loss = loss
        #: the MSE evaluator's ``root``, mirrored into the net's windows
        #: (``StandardWorkflow.link_evaluator`` sets it)
        self.stats_root = True
        self.output = Array(name="output")
        self.max_idx = Array(name="max_idx")
        #: one event per dispatched mid-segment window, oldest first
        self._inflight = collections.deque()
        self._staging = None
        self._hyper_serials = None
        self._hyper_cache = None
        self._hyper_stacked = {}
        #: the loader: driven directly during window collection, and
        #: its label count sets the head width
        self.loader_unit = None
        #: called after each minibatch collected into a window (the
        #: learning-rate adjuster's ``run``), or None
        self.hyper_tick = None
        #: the stats of the window just run (host), the deferred
        #: sentinel, or None when no window ran
        self.window_stats = None
        self.net = None
        self._use_device_data = False
        self.gd_proxies = []
        # a tied deconv's "<-" governs its conv's shared weights
        overrides = {layer.get("->", {}).get("tied_to"): layer
                     for layer in self.layers
                     if layer.get("type") == "deconv" and layer.get("<-")}
        for i, layer in enumerate(self.layers):
            tpe = layer.get("type")
            if tpe in fused.FC_TYPES or tpe in fused.CONV_TYPES:
                name = layer.get("name", "%s_%d" % (tpe, i))
                hyper, hyper_bias, _ = fused.layer_hyper(
                    overrides.get(name, layer))
                self.gd_proxies.append(GDProxy("gd_" + name, hyper,
                                               hyper_bias))
        self.demand("input", "minibatch_class", "minibatch_size",
                    "target" if loss == "mse" else "labels")
        #: params, optimizer state, generator and hypers (an exact
        #: resume), and the device accumulator drained to the host
        self.exports = ["fused_state", "epoch_acc"]

    def _fix_head_width(self):
        """The softmax head's width from the loader's label count, an
        MSE head's from its target sample shape."""
        last = self.layers[-1]
        if self.loader_unit is None:
            return
        if self.loss == "mse":
            tshape = getattr(self.loader_unit, "targets_shape", None)
            if last.get("type") in fused.FC_TYPES and tshape:
                fwd = last.setdefault("->", {})
                oss = fwd.get("output_sample_shape")
                if oss is not None and \
                        int(numpy.prod(oss)) != int(numpy.prod(tshape)):
                    self.warning("Overriding output_sample_shape %s with %s "
                                 "(loader targets)", oss, tshape)
                    fwd["output_sample_shape"] = tuple(tshape)
                elif oss is None:
                    fwd["output_sample_shape"] = tuple(tshape)
            return
        if last.get("type") != "softmax":
            return
        try:
            ulc = int(self.loader_unit.unique_labels_count)
        except (AttributeError, TypeError):
            return
        if not ulc:
            return
        fwd = last.setdefault("->", {})
        oss = fwd.get("output_sample_shape")
        if oss is not None and int(numpy.prod(oss)) != ulc:
            self.warning("Overriding softmax output_sample_shape %s "
                         "with (%d,)", oss, ulc)
        fwd["output_sample_shape"] = ulc

    def initialize(self, device=None, **kwargs):
        super(FusedForwardBackward, self).initialize(device=device,
                                                     **kwargs)
        if self.net is not None:
            return
        self._fix_head_width()
        dtype = self.dtype
        if dtype is None:
            dtype = root.common.engine.get("precision_dtype")
        if dtype is None:
            dtype = numpy.float32
        self.net = fused.FusedNet(
            self.layers, input_sample_shape=tuple(self.input.shape[1:]),
            rand=prng.get(), dtype=dtype, dropout_seed=self.dropout_seed,
            pool_impl=self.pool_impl, objective=self.loss, device=device)
        if self.loss == "mse":
            self.net.mse_root = bool(self.stats_root)
            ct = getattr(self.loader_unit, "class_targets", None)
            if ct is not None and ct:
                mem = numpy.asarray(ct.mem)
                self.net.class_targets = mem.reshape(mem.shape[0], -1)
        self._staging = _StagingRing(self.PIPELINE_DEPTH + 1,
                                     self.net.device)
        self._setup_device_data()
        batch = int(self.input.shape[0])
        self.output.reset(numpy.zeros(
            (batch,) + tuple(self.net.specs[-1].out_shape), dtype=dtype))
        self.max_idx.reset(numpy.zeros(batch, dtype=numpy.int32))
        for arr in (self.output, self.max_idx):
            arr.device = self.net.device

    # -- the device-resident dataset ----------------------------------------
    def _loader_qualifies_for_device_data(self):
        """The loader's fill is the stock FullBatchLoader copy (for MSE,
        the stock targets fill over it, with targets), so a gather from
        the normalized dataset on the device gives the same rows."""
        lu = self.loader_unit
        if not (isinstance(lu, FullBatchLoader) and bool(lu.original_data)):
            return False
        if self.loss == "mse":
            if not (isinstance(lu, FullBatchLoaderMSEMixin)
                    and type(lu).fill_minibatch
                    is FullBatchLoaderMSEMixin.fill_minibatch
                    and bool(lu.original_targets)):
                return False
            mro = type(lu).__mro__
            for klass in mro[mro.index(FullBatchLoaderMSEMixin) + 1:]:
                fill = klass.__dict__.get("fill_minibatch")
                if fill is not None:
                    return fill is FullBatchLoader.__dict__["fill_minibatch"]
            return False
        return (type(lu).fill_minibatch is FullBatchLoader.fill_minibatch
                and len(lu.original_labels) > 0)

    def _setup_device_data(self):
        qualifies = (self.loader_unit is not None
                     and self._loader_qualifies_for_device_data())
        if self.window is None:
            self.window = 8 if qualifies else 1
        if self.window > 1 and not qualifies:
            raise NotImplementedError(
                "a host-stacked window (fused window=%d over a loader "
                "whose rows the device cannot gather) is %s"
                % (self.window, _LATER))
        self._use_device_data = self.window > 1
        if self._use_device_data:
            # TRAIN rows are gathered on the device; the loader skips
            # their host fill (VALID still fills)
            self.loader_unit.skip_fill = True

    # -- TRAIN windows --------------------------------------------------------
    def _run_train_window(self):
        """Collect up to ``window`` TRAIN minibatches, driving the loader
        directly and stopping at its segment's last minibatch, and run
        them as one window.  Returns the number of steps."""
        loader = self.loader_unit
        mse = self.loss == "mse"
        if not self.net.has_dataset:
            self.net.set_dataset(
                numpy.asarray(loader.original_data.mem,
                              dtype=self.input.dtype),
                loader.original_labels,
                numpy.asarray(loader.original_targets.mem,
                              dtype=self.target.dtype) if mse else None)
        stage = self._staging.get((self.window, int(self.input.shape[0])))
        sizes, hyper_steps = [], []
        while True:
            loader.fill_window_slot(stage[len(sizes)])
            sizes.append(int(self.minibatch_size))
            hyper_steps.append(self._current_hypers())
            if len(sizes) >= self.window or bool(loader.last_minibatch):
                break
            loader.run()
            if self.hyper_tick is not None:
                self.hyper_tick()
        n = len(sizes)
        final = bool(loader.last_minibatch)
        run = self.net.run_window_mse_indexed if mse else \
            self.net.run_window_indexed
        stats = run(self._staging.upload(n), sizes,
                    self._stacked_hypers(hyper_steps))
        if not final:
            # no readback: bound the windows in flight with events
            self.window_stats = DEFERRED_WINDOW_STATS
            if self.net.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                self._inflight.append(event)
                while self._inflight and self._inflight[0].query():
                    self._inflight.popleft()
                while len(self._inflight) > self.PIPELINE_DEPTH:
                    self._inflight.popleft().synchronize()
            return n
        # the segment's one readback: the accumulator and the last
        # step's output (with its argmax, or its per-sample MSE)
        acc = self.net.window_acc
        fetch = dict(acc, output=stats["output"])
        fetch.update({"mse_per": stats["mse_per"]} if mse else
                     {"max_idx": stats["max_idx"]})
        host = memory.host_fetch(fetch)
        if mse:
            self.window_stats = {"metrics": host["metrics"],
                                 "n_err": host["n_err"],
                                 "mse_per": host["mse_per"]}
        else:
            self.window_stats = {"n_err": host["n_err"],
                                 "confusion": host["confusion"],
                                 "max_err_sum": float(host["max_err_sum"])}
            self.max_idx.mem = host["max_idx"]
        self.net.reset_window_acc()
        self._inflight.clear()
        self.output.mem = host["output"].astype(self.output.dtype,
                                                copy=False)
        return n

    def _current_hypers(self):
        """The live hyper pytree from the proxies, rebuilt only when a
        proxy value changed."""
        s = tuple(p.serial for p in self.gd_proxies)
        if s != self._hyper_serials:
            hypers, it = [], iter(self.gd_proxies)
            for spec in self.net.specs:
                h = {}
                if spec.kind in ("fc", "conv"):
                    hyper, hyper_bias = next(it).hyper_dicts()
                    h["w"] = hyper
                    if spec.include_bias:
                        h["b"] = hyper_bias
                hypers.append(h)
            self._hyper_cache = hypers
            self._hyper_serials = s
            self._hyper_stacked.clear()
        return self._hyper_cache

    def _stacked_hypers(self, hyper_steps):
        """The window's per-step hypers (one :meth:`_current_hypers`
        tree a step) stacked along a leading step axis, cast to the
        net's dtype as the JAX trainer casts them.  A window whose steps
        all share one tree (no hyper changed in it) reuses the stack
        cached for its length."""
        n = len(hyper_steps)
        if any(h is not hyper_steps[0] for h in hyper_steps):
            return _stack_trees(hyper_steps, self.net.dtype)
        stacked = self._hyper_stacked.get(n)
        if stacked is None:
            stacked = self._hyper_stacked[n] = _stack_trees(
                hyper_steps, self.net.dtype)
        return stacked

    def run(self):
        train = int(self.minibatch_class) == TRAIN
        self.window_stats = None
        if train and self._use_device_data:
            self._run_train_window()
            return
        x = self.input.mem
        if self.loss == "mse":
            out = self.net.step_mse(
                x, self.target.mem, int(self.minibatch_size),
                hypers=self._current_hypers())["output"] if train else \
                self.net.predict(x)
            self.output.set_dev(out)
            return
        if train:
            metrics = self.net.step(
                x, numpy.asarray(self.labels.mem, dtype=numpy.int32),
                hypers=self._current_hypers())
            out, idx = metrics["output"], metrics["max_idx"]
        else:
            out, idx = self.net.predict_with_idx(x)
        self.output.set_dev(out)
        self.max_idx.set_dev(idx)

    # -- snapshot / resume (after initialize) --------------------------------
    @property
    def fused_state(self):
        sd = self.net.state_dict()
        sd["proxies"] = [p.state_dict() for p in self.gd_proxies]
        return sd

    @fused_state.setter
    def fused_state(self, sd):
        self.net.load_state_dict(sd)
        for proxy, ps in zip(self.gd_proxies, sd.get("proxies", ())):
            proxy.load_state_dict(ps)

    @property
    def epoch_acc(self):
        """The device accumulator drained to the host (None at a
        segment boundary: nothing in flight to save)."""
        return self.net.window_acc_host()

    @epoch_acc.setter
    def epoch_acc(self, value):
        self.net.set_window_acc(value)
