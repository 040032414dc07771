"""NN unit base classes, the layer-type registry, the NN workflow and
its snapshotter.

Counterpart of ``znicz_tpu/units/nn_units.py``:

* ``Match`` / ``MatchingObject`` (:39-88) — the registry keystone:
  every forward unit declares ``MAPPING = {"type-string"}``, backward
  units register under the same names, and ``StandardWorkflowBase``
  instantiates from a ``layers`` config through :data:`mapping`;
* ``as_nhwc`` (:111), ``Forward`` / ``NNLayerBase`` (:127-200) with
  weight and bias init, ``FullyConnectedOutput`` (:203-246) and
  ``GradientDescentWithActivation`` (:248-258);
* ``GradientDescentBase`` (:261-522) — every hyperparameter, the
  ``_hyper`` / ``_flags`` split (the bias gets ``factor_ortho=0`` and
  no ortho) and the exported optimizer Arrays; its update is
  :func:`znicz_tpu_torch.ops.gd_math.update`.  The JAX package's
  ``numpy_run`` / ``jax_run`` fork is one ``run`` on the unit's
  device, and the per-minibatch path reads nothing back; after each
  run the health monitor checks the unit's arrays (:516-521), where it
  is on, and the armed profiler splits the run into dispatch and device
  time (``note_gd_step``, :507-513) and counts each update's first
  dispatch (``gd.update.<unit>.<weights|bias>``, :440);
* ``NNWorkflow`` (:524), ``NNSnapshotterToFile`` ("nnfile", :570) and
  ``load_snapshot_into_workflow`` (:574) with the mapping of a snapshot
  between the fused and the unit-graph modes (:606-657).

``Forward.generate_data_for_slave`` / ``apply_data_from_master``
(:169-192) are the forwards' weight broadcast, through which
``StandardWorkflow.extract_forward_workflow`` hands a trained
workflow's weights to its forward-only copy; a unit in
``forward_mode`` neither sends nor takes.  The GD units' master/slave
gradient protocol (:457-500) is JAX's: a slave's units apply no update
(``apply_gradient = not workflow.is_slave``) and send their velocity
(``generate_data_for_master``), which the master folds into its
weights (``apply_data_from_slave``); the master sends its rates
(``generate_data_for_slave``), which a slave takes with zeroed
gradients (``apply_data_from_master``).  Outside a standalone run the
velocity Arrays always exist (:350-362).
"""

import time

import numpy

from znicz_tpu_torch.core import health, profiler, prng, telemetry
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.core.backends import deterministic, full_f32
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.core.workflow import Repeater
from znicz_tpu_torch.ops import gd_math
from znicz_tpu_torch.ops.init import fill_array


class Match(object):
    """One registry row: the forward class and its backward classes."""

    def __init__(self):
        self._forward = None
        self._backwards = []

    @property
    def forward(self):
        if self._forward is None:
            raise KeyError("no forward unit registered")
        return self._forward

    @property
    def backwards(self):
        """An iterator over the registered GD classes (the workflow
        takes the first)."""
        return iter(self._backwards)

    @property
    def has_forward(self):
        return self._forward is not None


#: the type-string registry: ``{type: Match}``
mapping = {}


class MatchingObject(type):
    """Metaclass registering classes by their ``MAPPING`` type strings."""

    def __init__(cls, name, bases, clsdict):
        super(MatchingObject, cls).__init__(name, bases, clsdict)
        types = clsdict.get("MAPPING", None)
        if not types or clsdict.get("hide_from_registry"):
            return
        if not isinstance(types, (set, frozenset)):
            raise TypeError(
                "%s.MAPPING must be a set of type strings, got %s"
                % (name, type(types).__name__))
        for tpe in types:
            match = mapping.setdefault(tpe, Match())
            if getattr(cls, "_registry_role", None) == "backward":
                match._backwards.append(cls)
            else:
                if match._forward is not None and match._forward is not cls:
                    raise ValueError(
                        "duplicate forward registration for %r" % tpe)
                match._forward = cls


def as_nhwc(t):
    """A 4-D NHWC view of a 3-D ``(B, H, W)`` or 4-D tensor or shape: the
    implicit single channel of every spatial unit."""
    if isinstance(t, tuple):
        return t + (1,) if len(t) == 3 else t
    return t.reshape(tuple(t.shape) + (1,)) if t.dim() == 3 else t


class ForwardBase(AcceleratedUnit, metaclass=MatchingObject):
    """Base of the forward-propagation units."""
    hide_from_registry = True
    MAPPING = set()
    _registry_role = "forward"


class Forward(ForwardBase):
    """A forward unit with weights and bias."""

    hide_from_registry = True
    MAPPING = set()
    #: exports that only a resumed run needs, never a served forward
    RESUME_ONLY = ()

    def __init__(self, workflow, **kwargs):
        super(Forward, self).__init__(workflow, **kwargs)
        self.weights_stddev = kwargs.get("weights_stddev")
        self.bias_stddev = kwargs.get("bias_stddev", self.weights_stddev)
        self.weights_filling = kwargs.get("weights_filling", "uniform")
        self.bias_filling = kwargs.get("bias_filling", "uniform")
        self.rand = kwargs.get("rand", prng.get())
        self.weights_transposed = kwargs.get("weights_transposed", False)
        self.include_bias = kwargs.get("include_bias", True)
        self.demand("input")
        self.output = Array(name="output")
        self.weights = Array(name="weights")
        self.bias = Array(name="bias")
        self.forward_mode = False
        self.exports = ["weights", "bias", "include_bias",
                        "weights_transposed"]

    def initialize(self, device=None, **kwargs):
        super(Forward, self).initialize(device=device, **kwargs)
        full_f32(self.device)
        deterministic(self.device)
        for arr in (self.output, self.weights, self.bias):
            arr.device = self.device

    def fill_array(self, filling, array, stddev):
        fill_array(self.rand, filling, array, stddev)

    @property
    def package_attrs(self):
        """The exports a deployment package and a snapshot's serving
        topology describe: :attr:`exports` less :attr:`RESUME_ONLY`."""
        return [a for a in self.exports if a not in self.RESUME_ONLY]

    def package_export(self):
        """The unit's public state for a deployment package
        (``znicz_tpu/units/nn_units.py:154``): every allocated Array of
        :attr:`package_attrs` as a host copy, every other value as it
        is."""
        data = {}
        for attr in self.package_attrs:
            value = getattr(self, attr, None)
            if value is None:
                continue
            if isinstance(value, Array):
                if not value:
                    continue
                value = numpy.array(value.mem)
            data[attr] = value
        return data

    # -- the weight broadcast -------------------------------------------------
    def generate_data_for_slave(self, slave=None):
        """Host copies ``[weights, bias]`` (None where unallocated);
        None in ``forward_mode``."""
        if self.forward_mode:
            return None
        data = [None, None]
        if self.weights:
            data[0] = numpy.array(self.weights.mem)
        if self.bias:
            data[1] = numpy.array(self.bias.mem)
        return data

    def apply_data_from_master(self, data):
        """Take ``[weights, bias]`` from the master: copied into the
        allocated Arrays, or adopted as they are where none is
        allocated yet (the unit's ``initialize`` then keeps them);
        nothing in ``forward_mode``."""
        if self.forward_mode:
            return
        for arr, value in zip((self.weights, self.bias), data):
            if value is None:
                continue
            if arr:
                arr.map_invalidate()
                numpy.copyto(arr.mem, value)
            else:
                arr.reset(numpy.array(value))

    def apply_params(self, weights, bias):
        """Set the weights and bias from host arrays (either None to
        leave it), in their dtype where they have one, whatever the
        shape held before and in ``forward_mode`` too: a snapshot's or
        the fused trainer's parameters restored into the unit."""
        for arr, value in ((self.weights, weights), (self.bias, bias)):
            if value is not None:
                arr.reset(numpy.array(value, dtype=arr.dtype))


class NNLayerBase(Forward):
    """A layer with weights (the JAX package's run-and-log base)."""
    hide_from_registry = True
    MAPPING = set()


class FullyConnectedOutput(object):
    """The output geometry of a fully-connected layer."""

    def __init__(self, *args, **kwargs):
        super(FullyConnectedOutput, self).__init__(*args, **kwargs)
        self._output_sample_shape = tuple()
        self.output_sample_shape = kwargs.get("output_sample_shape", tuple())

    @property
    def output_sample_shape(self):
        return self._output_sample_shape

    @output_sample_shape.setter
    def output_sample_shape(self, value):
        if isinstance(value, (int, numpy.integer)):
            self._output_sample_shape = (int(value),)
        elif hasattr(value, "shape"):
            self._output_sample_shape = tuple(value.shape[1:])
        elif hasattr(value, "__iter__"):
            self._output_sample_shape = tuple(value)
        else:
            raise TypeError("Unsupported output_sample_shape type: %s"
                            % type(value))

    @property
    def neurons_number(self):
        return int(numpy.prod(self.output_sample_shape))


class GradientDescentWithActivation(object):
    """Mixin: the backward starts with ``err_output *= f'(output)``, so
    it demands the forward's output."""

    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(GradientDescentWithActivation, self).__init__(workflow, **kwargs)
        self.demand("output")


class GradientDescentBase(AcceleratedUnit, metaclass=MatchingObject):
    """Base of the backward (gradient-descent) units: every
    hyperparameter of the JAX package's, the optimizer Arrays it exports
    (velocity and accumulator, whose restore makes a resumed run exact)
    and the update through :func:`gd_math.update` on the device."""

    hide_from_registry = True
    MAPPING = set()
    _registry_role = "backward"

    def __init__(self, workflow, **kwargs):
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.err_input = Array(name="err_input")
        self.weights = None
        self.bias = None
        self.output = None
        self.demand("input", "err_output")
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get("learning_rate_bias",
                                             self.learning_rate)
        self.weights_decay = kwargs.get("weights_decay", 0.00005)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        self.l1_vs_l2 = kwargs.get("l1_vs_l2", 0)
        self.l1_vs_l2_bias = kwargs.get("l1_vs_l2_bias", self.l1_vs_l2)
        self.gradient_moment = kwargs.get("gradient_moment", 0)
        self.gradient_moment_bias = kwargs.get("gradient_moment_bias",
                                               self.gradient_moment)
        self.weights_transposed = kwargs.get("weights_transposed", False)
        self.err_input_alpha = kwargs.get("err_input_alpha", 1.0)
        self.err_input_beta = kwargs.get("err_input_beta", 0.0)
        self.need_err_input = kwargs.get("need_err_input", True)
        self.need_gradient_weights = kwargs.get("need_gradient_weights", True)
        self.include_bias = kwargs.get("include_bias", True)
        self.factor_ortho = kwargs.get("factor_ortho", 0)
        self.accumulate_gradient = kwargs.get("accumulate_gradient", False)
        self.acc_alpha = kwargs.get("acc_alpha", 0.0)
        self.acc_beta = kwargs.get("acc_beta", 0.0)
        self.gd_alpha = kwargs.get("gd_alpha", 0.0)
        self.gd_beta = kwargs.get("gd_beta", 1.0)
        self.solvers = frozenset(kwargs.get("solvers", ()))
        self.variant_gradient = kwargs.get("variant_gradient", True)
        self.variant_moment_gradient = kwargs.get(
            "variant_moment_gradient", True)
        self.gradient_weights = Array(name="gradient_weights")
        self.gradient_bias = Array(name="gradient_bias")
        self.accumulated_gradient_weights = Array()
        self.accumulated_gradient_bias = Array()
        self.gradient_weights_with_moment = Array()
        self.gradient_bias_with_moment = Array()
        self.apply_gradient = kwargs.get(
            "apply_gradient", not getattr(workflow, "is_slave", False))
        #: set by each run, cleared when the velocity goes to the master
        self.gradient_changed = False
        self.exports = ["gradient_weights_with_moment",
                        "gradient_bias_with_moment",
                        "accumulated_gradient_weights",
                        "accumulated_gradient_bias"]
        #: the solvers' slots (adagrad, adadelta, fast) on the device,
        #: by "weights" / "bias"
        self._solver_state = {}

    def initialize(self, device=None, **kwargs):
        super(GradientDescentBase, self).initialize(device=device, **kwargs)
        full_f32(self.device)
        deterministic(self.device)
        for attr in ("learning_rate", "weights_decay", "gradient_moment",
                     "learning_rate_bias", "weights_decay_bias",
                     "gradient_moment_bias"):
            setattr(self, attr, kwargs.get(attr, getattr(self, attr)))
        for which, moment in (("weights", self.gradient_moment),
                              ("bias", self.gradient_moment_bias)):
            ref = getattr(self, which)
            if not (self.need_gradient_weights and ref) or (
                    which == "bias" and not self.include_bias):
                continue
            zeros = numpy.zeros(ref.shape, ref.dtype)
            grad = getattr(self, "gradient_" + which)
            acc = getattr(self, "accumulated_gradient_" + which)
            vel = getattr(self, "gradient_%s_with_moment" % which)
            if not grad:
                grad.reset(zeros.copy())
            if self.accumulate_gradient and not acc:
                acc.reset(zeros.copy())
            if (moment or not self.is_standalone or self.solvers) and \
                    not vel:
                vel.reset(zeros.copy())
        if self.need_err_input and not self.err_input:
            self.err_input.reset(numpy.zeros(self.input.shape,
                                             self.err_output.dtype))
        for arr in (self.err_input, self.gradient_weights,
                    self.gradient_bias, self.accumulated_gradient_weights,
                    self.accumulated_gradient_bias,
                    self.gradient_weights_with_moment,
                    self.gradient_bias_with_moment):
            arr.device = self.device
        self._solver_state = {}

    # -- the update ----------------------------------------------------------
    def _hyper(self, bias=False):
        if bias:
            return dict(lr=self.learning_rate_bias,
                        wd=self.weights_decay_bias,
                        l1_vs_l2=self.l1_vs_l2_bias,
                        moment=self.gradient_moment_bias,
                        acc_alpha=self.acc_alpha, acc_beta=self.acc_beta,
                        gd_alpha=self.gd_alpha, gd_beta=self.gd_beta,
                        factor_ortho=0.0)
        return dict(lr=self.learning_rate, wd=self.weights_decay,
                    l1_vs_l2=self.l1_vs_l2, moment=self.gradient_moment,
                    acc_alpha=self.acc_alpha, acc_beta=self.acc_beta,
                    gd_alpha=self.gd_alpha, gd_beta=self.gd_beta,
                    factor_ortho=float(self.factor_ortho))

    def _flags(self, bias=False):
        return dict(accumulate=bool(self.accumulate_gradient),
                    apply=bool(self.apply_gradient),
                    solvers=self.solvers,
                    # ortho regularizes weight ROWS, never the 1-D bias
                    ortho=bool(self.factor_ortho) and not bias,
                    variant_moment=self.variant_moment_gradient)

    def apply_update(self, which, grad):
        """Store ``grad`` as ``gradient_<which>`` and run the update
        algebra on the device for "weights" or "bias": the parameter
        (the forward's Array) and the optimizer Arrays are written with
        ``set_dev``, nothing is read back."""
        getattr(self, "gradient_" + which).set_dev(grad)
        vec = getattr(self, which)
        acc = getattr(self, "accumulated_gradient_" + which)
        vel = getattr(self, "gradient_%s_with_moment" % which)
        w = vec.dev
        slots = self._solver_state.get(which)
        if slots is None:
            slots = self._solver_state[which] = gd_math.init_state(
                w, {"solvers": self.solvers, "need_vel": False})
        state = dict(slots, acc=acc.dev if acc else None,
                     vel=vel.dev if vel else None)
        bias = which == "bias"
        if profiler.enabled():
            with gd_math.register_update_cost(
                    "gd.update.%s.%s" % (self.name, which), w):
                new_w, new_state, _ = gd_math.update(
                    w, grad, state, self._hyper(bias), self._flags(bias))
        else:
            new_w, new_state, _ = gd_math.update(
                w, grad, state, self._hyper(bias), self._flags(bias))
        if self.apply_gradient:
            vec.set_dev(new_w)
        for arr, key in ((acc, "acc"), (vel, "vel")):
            if arr and new_state.get(key) is not None:
                arr.set_dev(new_state[key])
        for key in slots:
            slots[key] = new_state[key]

    def _fire(self):
        """The scheduler's call; after a run, the health monitor's check
        of this unit's gradients, weights and updates (JAX
        nn_units.py:516-521), interval-gated inside.  The armed
        profiler's step breakdown splits the run into dispatch and
        device time (``profiler.note_gd_step``, a synchronize paid only
        while armed), and a run sets ``gradient_changed``: here, since
        the port's GD units' ``run`` does not call a base ``run`` as the
        JAX units' does."""
        runs = self.run_count_
        if profiler.enabled():
            t0 = time.perf_counter()
            super(GradientDescentBase, self)._fire()
            if self.run_count_ != runs:
                profiler.note_gd_step(self, t0)
        else:
            super(GradientDescentBase, self)._fire()
        if self.run_count_ != runs:
            # JAX's GD run marks it (nn_units.py:500)
            self.gradient_changed = True
            if health.enabled():
                health.check_gd_unit(self)

    # -- the master-slave gradient protocol (JAX :457-500) ----------------
    def generate_data_for_slave(self, slave=None):
        return (self.learning_rate, self.weights_decay, self.gradient_moment,
                self.learning_rate_bias, self.weights_decay_bias,
                self.gradient_moment_bias)

    @staticmethod
    def fill_zeros(vector):
        if not vector:
            return
        vector.map_invalidate()
        vector.mem[:] = 0

    def apply_data_from_master(self, data):
        (self.learning_rate, self.weights_decay, self.gradient_moment,
         self.learning_rate_bias, self.weights_decay_bias,
         self.gradient_moment_bias) = data
        for v in (self.gradient_weights_with_moment,
                  self.gradient_bias_with_moment,
                  self.gradient_weights, self.gradient_bias,
                  self.accumulated_gradient_weights,
                  self.accumulated_gradient_bias):
            self.fill_zeros(v)
        self._solver_state = {}

    def generate_data_for_master(self):
        if not self.gradient_changed:
            return None
        self.gradient_changed = False
        return (numpy.array(self.gradient_weights_with_moment.mem)
                if self.gradient_weights_with_moment else None,
                numpy.array(self.gradient_bias_with_moment.mem)
                if self.gradient_bias_with_moment else None)

    def apply_data_from_slave(self, data, slave=None):
        if self.weights and data[0] is not None:
            self.weights.map_write()
            self.gradient_weights_with_moment.map_write()
            self.gradient_weights_with_moment.mem *= self.gradient_moment
            self.gradient_weights_with_moment.mem += data[0]
            self.weights.mem += self.gradient_weights_with_moment.mem
        if self.bias and data[1] is not None:
            self.bias.map_write()
            self.gradient_bias_with_moment.map_write()
            self.gradient_bias_with_moment.mem *= self.gradient_moment_bias
            self.gradient_bias_with_moment.mem += data[1]
            self.bias.mem += self.gradient_bias_with_moment.mem

    def set_err_input(self, err_in):
        """``err_input = alpha * err_in (+ beta * err_input)``."""
        bp = err_in * self.err_input_alpha
        if self.err_input_beta:
            bp = bp + self.err_input_beta * self.err_input.dev
        self.err_input.set_dev(bp)


class NNWorkflow(AcceleratedWorkflow):
    """Workflow with the canonical NN slots."""

    def __init__(self, workflow=None, **kwargs):
        super(NNWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.loader = None
        self.forwards = []
        self.evaluator = None
        self.decision = None
        self.gds = []


class NNSnapshotterToFile(SnapshotterToFile):
    """File snapshots that log min/max/avg of every exported array (the
    units' own, not those inside a nested export such as the trainer's
    state) and warn of NaN or inf; ``skip`` is one more Bool gate."""

    MAPPING = "nnfile"

    def __init__(self, workflow, **kwargs):
        super(NNSnapshotterToFile, self).__init__(workflow, **kwargs)
        self.skip = kwargs.get("skip", None)

    def _log_attr(self, name, value):
        if not isinstance(value, numpy.ndarray) or value.size == 0:
            return
        self.debug("%s: min %.6f max %.6f avg %.6f", name, value.min(),
                   value.max(), value.mean())
        if not numpy.isfinite(value).all():
            self.warning("NaN/inf detected in %s", name)

    def export(self):
        state = self.collect_state()
        for uname, ustate in state.items():
            for attr, value in ustate.items():
                self._log_attr("%s.%s" % (uname, attr), value)
        return super(NNSnapshotterToFile, self).export(units_state=state)

    def run(self):
        if self.skip is not None and bool(self.skip):
            return
        super(NNSnapshotterToFile, self).run()


def load_snapshot_into_workflow(state, workflow):
    """Apply a snapshot's state dict onto a built, initialized
    workflow: the prng streams' states, then every unit's exports
    (weights, optimizer state and generator, decision bookkeeping,
    loader position).  Resuming this way continues bit for bit."""
    if "prng" in state:
        prng.restore(state["prng"])
    telemetry.record_event("snapshot.restore",
                           workflow=getattr(workflow, "name", None),
                           suffix=state.get("suffix"))
    units = {u.name: u for u in workflow.units}
    for uname, ustate in state["units"].items():
        u = units.get(uname)
        if u is None:
            continue
        for attr, value in ustate.items():
            cur = getattr(u, attr, None)
            if isinstance(cur, Array):
                if value is not None:
                    cur.reset(numpy.array(value))
            else:
                setattr(u, attr, value)
    _map_cross_mode_state(state, workflow)


def _unit_graph_name(layer, index):
    """The forward unit's name of ``layers[index]`` in the unit graph
    (``StandardWorkflowBase._get_layer_type_kwargs``)."""
    if "name" in layer:
        return layer["name"] + "_forward"
    return "%s_%d_forward" % (layer.get("type"), index)


def _map_cross_mode_state(state, workflow):
    """A snapshot restores across execution modes: a fused snapshot's
    parameters go into the unit graph's forwards, and a unit-graph
    snapshot's weights into the fused trainer, layer by layer.  The
    optimizer state does not transfer between the two representations,
    so momentum restarts cold: both directions warn."""
    snap_units = state.get("units", {})
    fused_state = snap_units.get("fused_trainer", {}).get("fused_state")
    trainer = getattr(workflow, "fused_trainer", None)
    forwards = list(getattr(workflow, "forwards", ()))
    if fused_state is not None and trainer is None and forwards:
        workflow.warning(
            "snapshot was written in FUSED mode; mapping its params onto "
            "the unit graph (optimizer momentum restarts cold: pass "
            "--fused to resume bit-exactly)")
        for fwd, p in zip(forwards, fused_state.get("params", ())):
            if p and hasattr(fwd, "apply_params"):
                fwd.apply_params(p.get("w"), p.get("b"))
        return
    if fused_state is None and trainer is not None and \
            "fused_trainer" not in snap_units:
        params = []
        for i, layer in enumerate(trainer.layers):
            ustate = snap_units.get(_unit_graph_name(layer, i), {})
            p = {}
            if ustate.get("weights") is not None:
                p["w"] = numpy.array(ustate["weights"])
                if ustate.get("bias") is not None:
                    p["b"] = numpy.array(ustate["bias"])
            params.append(p)
        if not any(params):
            return
        workflow.warning(
            "snapshot was written in UNIT-GRAPH mode; mapping its weights "
            "onto the fused trainer (optimizer momentum restarts cold: "
            "drop --fused to resume bit-exactly)")
        sd = trainer.fused_state
        for tgt, src in zip(sd["params"], params):
            for k, v in src.items():
                if k in tgt and tgt[k].shape == v.shape:
                    tgt[k] = v.astype(tgt[k].dtype)
        trainer.fused_state = sd
