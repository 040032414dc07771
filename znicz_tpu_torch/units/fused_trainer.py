"""The fused training unit — the whole train step inside the unit graph.

Counterpart of ``znicz_tpu/units/fused_trainer.py`` (``GDProxy``
:105, ``FusedForwardBackward`` :179-1010).  The unit graph stays the
epoch-level control plane (loader -> train step -> evaluator ->
decision -> snapshotter), and the per-minibatch forward, backward and
update run in :class:`znicz_tpu_torch.parallel.fused.FusedNet`.
:class:`FusedForwardBackward` stands for the whole forwards + GD chain
and exposes ``output`` / ``max_idx`` as the last forward would.

TRAIN minibatches run in windows of up to ``window`` steps, in the
form the JAX trainer chooses (``device_data``, ``device_perm``): over
the dataset on the device, gathered by row index
(``FusedNet.run_window_indexed``) or sliced from the epoch's shuffled
dataset (``run_window_sliced``, ``device_perm=True``), or stacked on the
host where the loader's rows cannot be read on the device
(``run_window``; ``device_data=False`` asks for it).  The unit drives
the loader itself to collect a window and never crosses a segment
boundary.  The control plane is asynchronous: a mid-segment window
reads nothing back — its stats ride the net's device accumulator and
the evaluator gets the deferred sentinel — and the segment-final
window reads the accumulator, the output and the argmax back in ONE
copy.  A window's host arrays (row indices, or stacked rows, labels
and targets) are staged in a ring of ``pipeline_depth + 1`` host
buffers a key (pinned on the card, copied without blocking), each
reused only after the event recorded behind its copy has passed;
dispatched windows are bounded at ``pipeline_depth`` by events, a
completion wait and not a transfer.  VALID minibatches run through
``FusedNet.predict_with_idx``.

With ``loss="mse"`` the unit trains against the loader's targets, in
the MSE windows of the same three forms (``run_window_mse_indexed``,
``run_window_mse_sliced``, ``run_window_mse``; the JAX trainer slices
every device-data MSE window, the port gathers by index unless
``device_perm=True``, over the same rows), the segment-final readback
carries the ``[sum, max, min]`` metrics, the nearest-class-target
``n_err``, the output and the per-sample MSE, and VALID minibatches
run through ``FusedNet.predict``.

A window's hypers are taken step by step: after each minibatch it
collects, the unit calls ``hyper_tick`` (the learning-rate adjuster's
``run``, set by ``StandardWorkflow.link_lr_adjuster``), so a schedule
boundary inside a window takes effect at its own step, as in the unit
graph.  A window in which no hyper changed reuses its stacked hypers.

``async_windows=False`` reads every window's own stats back and folds
them into the evaluator's host accumulators (which ride a snapshot),
the JAX trainer's synchronous mode; a mid-segment window's are folded
at once, before the snapshotter's ``window_tick`` (the JAX trainer
hands them to the evaluator after the tick, so its mid-epoch snapshot
misses that window's stats).  The training control plane's
hooks sit where the JAX trainer has them: the ``fused.dispatch`` fault
site before a TRAIN window's dispatch and before a single step (not
retried in place: the supervised launcher restarts and resumes), the
health monitor's check after each window and step, and the
snapshotter's ``window_tick`` after each window that is not its
segment's last, so a resume splits the remaining minibatches into the
windows the uninterrupted run dispatches.  :class:`FusedNNRollback`
is the fused graph's rollback.

Not in this slice of the port (each raises, see ``ROADMAP.md``): the
JAX trainer's other keys (:attr:`FusedForwardBackward.LATER_KEYS`: the
mesh, ``compute_dtype``, ``defaults``, ``rand``) and the profiler
hooks.
"""

import collections
import copy

import numpy
import torch

from znicz_tpu_torch.core import faults, health, prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.mutable import Bool
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.loader.base import (TRAIN, FullBatchLoader,
                                         FullBatchLoaderMSEMixin, Loader)
from znicz_tpu_torch.parallel import fused

_LATER = "not in this slice of the port (see ROADMAP.md)"

#: ``window_stats`` of a mid-segment window: its stats ride the net's
#: device accumulator until the segment-final readback; the evaluator
#: takes it as consumed
DEFERRED_WINDOW_STATS = {"deferred": True}


class _StagingRing(object):
    """Rotating host buffers for a window's arrays, by key ("idx" for
    the row indices of a device-data window; "x", "lbl" and "tgt" for
    a host-stacked window's rows, labels and targets).

    ``depth`` buffers a key rotate round robin.  On the card each is
    pinned and uploaded without blocking, so the host must not refill
    one before its copy ran: the event recorded behind the copy is
    waited on before the buffer is handed out again."""

    def __init__(self, depth, device):
        self.depth = max(1, int(depth))
        self.device = device
        self._slots = {}   # key -> [[host tensor, event] or None, ...]
        self._turn = {}
        self._last = {}    # key -> the slot get() handed out last

    def get(self, key, shape, dtype):
        """The next buffer of ``key``, ``shape`` of numpy ``dtype``, as
        a writable numpy array."""
        slots = self._slots.setdefault(key, [None] * self.depth)
        i = self._turn.get(key, 0)
        self._turn[key] = (i + 1) % self.depth
        slot = slots[i]
        if slot is not None and slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        want = torch.from_numpy(numpy.zeros(0, dtype)).dtype
        if slot is None or tuple(slot[0].shape) != tuple(shape) or \
                slot[0].dtype != want:
            host = torch.empty(tuple(shape), dtype=want,
                               pin_memory=self.device.type == "cuda")
            slot = slots[i] = [host, None]
        self._last[key] = slot
        return slot[0].numpy()

    def upload(self, key, n):
        """The first ``n`` rows of the buffer :meth:`get` handed out
        last for ``key``, on the device."""
        slot = self._last[key]
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
    ``dropout_seed``, ``window`` (default 8 where the loader's rows
    can be gathered on the device, else 1: a step a minibatch),
    ``device_data`` ("auto", True or False: whether a window reads its
    rows from the dataset on the device; True raises where the loader
    does not qualify, False stacks every window's rows on the host) and
    ``device_perm`` ("auto", True or False: True slices each window
    from the epoch's shuffled dataset on the device, and raises where
    that path cannot engage), ``async_windows`` (True: one readback a
    segment; False: one a window) and ``pipeline_depth`` (dispatched
    windows in flight before collection waits for the oldest; the
    staging ring holds one more), as the JAX trainer takes them."""

    #: the JAX trainer's keys this slice of the port leaves out
    LATER_KEYS = ("mesh", "model_parallel", "compute_dtype", "defaults",
                  "rand")

    def __init__(self, workflow, layers, pool_impl=None, dtype=None,
                 dropout_seed=0, window=None, loss="softmax",
                 device_data="auto", device_perm="auto",
                 async_windows=True, pipeline_depth=2, **kwargs):
        later = sorted(set(kwargs) & set(self.LATER_KEYS))
        if later:
            raise NotImplementedError(
                "fused %s %s" % (", ".join(later), _LATER))
        if loss not in ("softmax", "mse"):
            raise ValueError("unknown fused loss %r" % (loss,))
        for key, value in (("device_data", device_data),
                           ("device_perm", device_perm)):
            if value not in ("auto", True, False):
                raise ValueError("fused %s must be 'auto', True or False, "
                                 "not %r" % (key, value))
        super(FusedForwardBackward, self).__init__(workflow, **kwargs)
        self.layers = copy.deepcopy(list(layers))
        self.pool_impl = pool_impl
        self.dtype = dtype
        self.dropout_seed = dropout_seed
        self.window = None if window is None else int(window)
        self.loss = loss
        self.device_data = device_data
        self.device_perm = device_perm
        self.async_windows = bool(async_windows)
        self.pipeline_depth = int(pipeline_depth)
        #: the evaluator's ``mean``, mirrored into the net's softmax
        #: windows (``StandardWorkflow.link_evaluator`` sets it)
        self.stats_mean = True
        #: the evaluator, which folds a synchronous mid-segment window's
        #: stats as soon as they are read (``link_evaluator`` sets it)
        self.stats_sink = None
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
        self._use_sliced = False
        #: the TRAIN order on the device for the sliced window (host)
        self._perm_host = None
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
        self.net.stats_mean = bool(self.stats_mean)
        if self.loss == "mse":
            self.net.mse_root = bool(self.stats_root)
            ct = getattr(self.loader_unit, "class_targets", None)
            if ct is not None and ct:
                mem = numpy.asarray(ct.mem)
                self.net.class_targets = mem.reshape(mem.shape[0], -1)
        self._staging = _StagingRing(self.pipeline_depth + 1,
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

    def _loader_serves_contiguous_slices(self):
        """The loader's minibatch walk and reshuffle are the stock ones,
        so a TRAIN minibatch at class offset ``o`` is the rows
        ``train_indices[o:o + n]`` of the order current while it is
        served (the sliced window's contract)."""
        lu = self.loader_unit
        return (type(lu).run is Loader.run
                and type(lu)._shuffle is Loader._shuffle)

    def _setup_device_data(self):
        """Choose the TRAIN window's form as the JAX trainer does: rows
        from the dataset on the device where the loader qualifies and a
        window holds more than one minibatch (gathered by index, or
        sliced from the epoch's shuffled dataset under
        ``device_perm=True``), else stacked on the host.  The MSE
        windows qualify only with ``device_perm`` not False and the
        stock minibatch walk; unlike the JAX trainer, which slices them
        always, they gather by index unless ``device_perm=True`` (the
        same rows)."""
        self._use_device_data = self._use_sliced = False
        self._perm_host = None
        lu = self.loader_unit
        qualifies = (self.device_data in ("auto", True) and lu is not None
                     and self._loader_qualifies_for_device_data())
        if self.loss == "mse":
            qualifies = qualifies and self.device_perm in ("auto", True) \
                and self._loader_serves_contiguous_slices()
        if self.window is None:
            self.window = 8 if qualifies else 1
        if qualifies and self.window > 1:
            # TRAIN rows are read on the device; the loader skips their
            # host fill (VALID still fills)
            self._use_device_data = True
            lu.skip_fill = True
            self._use_sliced = self.device_perm is True and \
                self._loader_serves_contiguous_slices()
        elif self.device_data is True and not qualifies:
            raise ValueError(
                "fused device_data=True needs a stock FullBatchLoader "
                "(no fill_minibatch override) with labels")
        if self.device_perm is True and not self._use_sliced:
            raise ValueError(
                "fused device_perm=True needs the windowed device-data "
                "path and the stock Loader run/_shuffle "
                "(contiguous-slice contract)")

    # -- TRAIN windows --------------------------------------------------------
    def _run_train_window(self):
        """One TRAIN window (:meth:`_run_train_window_inner`), then the
        health check over the net's parameters and optimizer slots (the
        velocity holds the last update), and the snapshotter's
        ``window_tick`` where the window is not its segment's last:
        always at a window boundary, so a run resumed from the
        ``midepoch`` snapshot splits the remaining minibatches into the
        same windows.  Returns the number of steps."""
        n = self._run_train_window_inner()
        if health.enabled():
            health.check_training_step(
                self, steps=n, params=self.net.params,
                updates=self.net.state, context="fused_window")
        snap = getattr(self.workflow, "snapshotter", None)
        if snap is not None and getattr(snap, "window_interval", 0) \
                and not bool(self.loader_unit.last_minibatch):
            snap.window_tick()
        return n

    def _run_train_window_inner(self):
        """Collect up to ``window`` TRAIN minibatches, driving the loader
        directly and stopping at its segment's last minibatch, and run
        them as one window: sliced or gathered from the dataset on the
        device, or stacked on the host in the pinned staging ring.
        Returns the number of steps."""
        loader = self.loader_unit
        mse = self.loss == "mse"
        if self._use_device_data and not self.net.has_dataset:
            self.net.set_dataset(
                numpy.asarray(loader.original_data.mem,
                              dtype=self.input.dtype),
                loader.original_labels,
                numpy.asarray(loader.original_targets.mem,
                              dtype=self.target.dtype) if mse else None)
        batch = int(self.input.shape[0])
        stage = {}
        if self._use_device_data and not self._use_sliced:
            stage["idx"] = self._staging.get(
                "idx", (self.window, batch), numpy.int64)
        elif not self._use_device_data:
            stage["x"] = self._staging.get(
                "x", (self.window,) + tuple(self.input.shape),
                self.input.dtype)
            stage["lbl"] = self._staging.get(
                "lbl", (self.window, batch), numpy.int32)
            if mse:
                stage["tgt"] = self._staging.get(
                    "tgt", (self.window,) + tuple(self.target.shape),
                    self.target.dtype)
        want_lbl = not mse or (
            self.net.class_targets is not None and
            bool(getattr(loader, "minibatch_labels", None)))
        starts, sizes, hyper_steps = [], [], []
        while True:
            i = len(sizes)
            if self._use_sliced:
                starts.append(self._sliced_start(first=not sizes))
            elif self._use_device_data:
                loader.fill_window_slot(indices_out=stage["idx"][i])
            else:
                loader.fill_window_slot(
                    x_out=stage["x"][i],
                    labels_out=stage["lbl"][i] if want_lbl else None,
                    targets_out=stage["tgt"][i] if mse else None)
                if not want_lbl:
                    stage["lbl"][i] = -1
            sizes.append(int(self.minibatch_size))
            hyper_steps.append(self._current_hypers())
            if len(sizes) >= self.window or bool(loader.last_minibatch):
                break
            loader.run()
            if self.hyper_tick is not None:
                self.hyper_tick()
        n = len(sizes)
        final = bool(loader.last_minibatch)
        hypers_s = self._stacked_hypers(hyper_steps)
        net = self.net
        if faults.enabled():
            # a failed dispatch is not retried here: the supervised
            # launcher's restart and mid-epoch resume recover it
            faults.check("fused.dispatch")
        if self._use_sliced:
            run = net.run_window_mse_sliced if mse else \
                net.run_window_sliced
            stats = run(starts, batch, sizes, hypers_s)
        elif self._use_device_data:
            run = net.run_window_mse_indexed if mse else \
                net.run_window_indexed
            stats = run(self._staging.upload("idx", n), sizes, hypers_s)
        else:
            up = self._staging.upload
            if mse:
                stats = net.run_window_mse(up("x", n), up("tgt", n),
                                           up("lbl", n), sizes, hypers_s)
            else:
                stats = net.run_window(up("x", n), up("lbl", n), sizes,
                                       hypers_s)
        if self.async_windows and not final:
            # no readback: bound the windows in flight with events
            self.window_stats = DEFERRED_WINDOW_STATS
            if net.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                self._inflight.append(event)
                while self._inflight and self._inflight[0].query():
                    self._inflight.popleft()
                while len(self._inflight) > self.pipeline_depth:
                    self._inflight.popleft().synchronize()
            return n
        # one readback: the segment's accumulator (async), or this
        # window's own stats (async_windows=False), with the segment's
        # last output (and its argmax, or its per-sample MSE)
        src = net.window_acc if self.async_windows else stats
        fetch = {k: src[k] for k in (("metrics", "n_err") if mse else
                                     ("n_err", "confusion", "max_err_sum"))}
        if final:
            fetch["output"] = stats["output"]
            fetch.update({"mse_per": stats["mse_per"]} if mse else
                         {"max_idx": stats["max_idx"]})
        host = net.host_fetch(fetch)
        if mse:
            self.window_stats = {"metrics": host["metrics"],
                                 "n_err": host["n_err"],
                                 "mse_per": host.get("mse_per")}
        else:
            self.window_stats = {"n_err": host["n_err"],
                                 "confusion": host["confusion"],
                                 "max_err_sum": float(host["max_err_sum"])}
        if not final:
            if self.stats_sink is not None:
                # fold now, before the snapshotter's window_tick: a
                # mid-epoch snapshot then holds the segment so far
                self.stats_sink.fold_window_stats(self.window_stats)
                self.window_stats = DEFERRED_WINDOW_STATS
            return n
        if not mse:
            self.max_idx.mem = host["max_idx"]
        net.reset_window_acc()
        self._inflight.clear()
        self.output.mem = host["output"].astype(self.output.dtype,
                                                copy=False)
        return n

    def _sliced_start(self, first):
        """The served TRAIN minibatch's start in the epoch's order on the
        device, its rows held against the loader's indices.  The order
        is put on the device again (:meth:`FusedNet.set_epoch_perm`)
        only at a window's first minibatch, where the loader's order
        changed since: with no VALID segment, the epoch's last
        minibatch reshuffles the loader in place after it is served,
        so a window that starts with it still reads the old order."""
        loader = self.loader_unit
        n = int(self.minibatch_size)
        start = int(loader.minibatch_class_offset)
        served = loader.minibatch_indices.mem[:n]
        perm = self._perm_host
        if perm is None or \
                not numpy.array_equal(perm[start:start + n], served):
            if not first:
                raise RuntimeError("the loader's TRAIN order changed "
                                   "inside a sliced window")
            perm = self._perm_host = numpy.array(loader.train_indices)
            self.net.set_epoch_perm(perm, pad=int(loader.max_minibatch_size))
            if not numpy.array_equal(perm[start:start + n], served):
                raise RuntimeError("the loader's TRAIN minibatch is not a "
                                   "slice of its order")
        return start

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
        if train and self.window > 1:
            self._run_train_window()
            return
        if train and faults.enabled():
            faults.check("fused.dispatch")
        self._run_minibatch(train)
        if train and health.enabled():
            health.check_training_step(
                self, steps=1, params=self.net.params,
                updates=self.net.state, context="fused_step")

    def _run_minibatch(self, train):
        """One minibatch: a train step, or the VALID forward."""
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

    def host_params(self):
        """The net's parameters as host arrays, one dict a layer."""
        return self.net.host_params()

    @property
    def epoch_acc(self):
        """The device accumulator drained to the host (None at a
        segment boundary: nothing in flight to save)."""
        return self.net.window_acc_host()

    @epoch_acc.setter
    def epoch_acc(self, value):
        self.net.set_window_acc(value)


class FusedNNRollback(Unit):
    """Divergence recovery in the fused graph (the JAX trainer's
    ``FusedNNRollback``, reference nn_rollback.py:44-190 over whole-net
    states).  On an improvement every proxy's learning rates grow by
    ``lr_plus`` and the net's state is pushed onto a history of
    ``history_limit``; after ``minus_steps`` epochs without one (at once
    when a parameter is not finite) the rates shrink by ``lr_minus``
    and the oldest stored state is restored, the rates keeping their
    shrunk values.  The history stays on the net's device
    (:meth:`FusedNet.device_state`: clones of its tensors, no host
    copy), and the NaN probe is one reduction on the device with one
    scalar read (:meth:`FusedNet.params_finite`)."""

    def __init__(self, workflow, **kwargs):
        super(FusedNNRollback, self).__init__(workflow, **kwargs)
        self.trainer = kwargs["trainer"]
        self.lr_plus = kwargs.get("lr_plus", 1.04)
        self.lr_minus = kwargs.get("lr_minus", 0.65)
        self.plus_steps = kwargs.get("plus_steps", 1)
        self.minus_steps = kwargs.get("minus_steps", 3)
        self._plus_steps = self.plus_steps
        self._minus_steps = self.minus_steps
        self.history_limit = kwargs.get("history_limit", 2)
        self.improved = None
        self.demand("improved")
        self._history = []
        self._first_run = True

    def _scale_lrs(self, k):
        for proxy in self.trainer.gd_proxies:
            proxy.learning_rate *= k
            proxy.learning_rate_bias *= k

    def run(self):
        if self.improved:
            self._plus_steps += 1
            if self._plus_steps < self.plus_steps:
                return
            self._plus_steps = 0
            self._minus_steps = 0
            self._scale_lrs(self.lr_plus)
            self._history.append(self.trainer.net.device_state())
            while len(self._history) > self.history_limit:
                self._history.pop(0)
        elif not self._first_run:
            if not self.trainer.net.params_finite():
                self.warning("NaNs encountered, rolling back")
                self._minus_steps = self.minus_steps
            self._minus_steps += 1
            if self._minus_steps < self.minus_steps:
                return
            self._minus_steps = 0
            self._plus_steps = 0
            self._scale_lrs(self.lr_minus)
            if not self._history:
                self.warning("No rollback state stored")
            else:
                self.info("Rolling back fused net state")
                sd = self._history[0]
                del self._history[1:]
                self.trainer.net.load_device_state(sd)
        self._first_run = False
