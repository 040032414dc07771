"""graftlint — project-invariant static analysis for the port's tree.

Counterpart of ``znicz_tpu/analysis/graftlint.py``: stdlib ``ast``
only (it imports nothing it checks, and not torch itself), the same
:class:`Finding`, pragma, baseline and :func:`selftest` design, driven
by ``tools/graftlint_torch.py``.  The checkers:

* ``knob-vocabulary`` — every ``root.common.*`` read or write
  (attribute chains, ``.get("key")`` literals, ``getattr`` /
  ``setattr``, module aliases like ``_cfg = root.common.serving``)
  must resolve to a knob the port's ``core/config.py`` declares
  (``config.declare``).  The config tree auto-vivifies, so an
  undeclared read is a silent, TRUTHY default.
* ``telemetry-series`` / ``telemetry-collision`` /
  ``telemetry-cardinality`` — metric call sites use the bounded series
  vocabulary, never pass ``labeled()`` a label named ``name`` (it
  collides with the positional parameter), and never derive a label
  value from request data (each value is a registry entry for good).
* ``lock-guard`` — per class, an attribute ever written under ``with
  self.<lock>`` is flagged where it is written (or mutated) outside
  it; ``# graftlint: guarded-by(self._lock)`` on a ``def`` declares a
  method that runs with the lock already held.
* ``torch-host-sync`` / ``torch-rng`` — inside the device bodies
  :data:`TRACED_BODIES` declares (the port's counterparts of the
  functions the JAX package jits or scans): no ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()`` / ``int()`` /
  ``bool()`` of a tensor parameter, ``numpy.asarray`` of one, or
  ``torch.cuda.synchronize`` (each one waits for the card, breaking
  the no-readback-inside-a-window promise of ``parallel/fused.py``);
  no ``random.*`` or ``numpy.random.*``, and every torch draw passes
  its ``generator=`` (the port's explicit-generator rule).  PyTorch
  runs eagerly, so nothing marks these bodies the way ``jax.jit`` and
  ``lax.scan`` mark the JAX package's: the table declares them.  The
  JAX package's ``jax-time`` and ``jax-donation`` have no counterpart:
  a wall-clock read in an eager body is read at every call, not baked
  in once at trace time, and nothing is donated (an eager update
  writes its buffers in place).
* ``gate-order`` — the off-by-default subsystems (:data:`GATED_MODULES`:
  health, profiler, faults, telemetry, locksmith, timeseries, pyprof,
  reqtrace, blackbox) hit their one-predicate gate before any config
  walk or ``torch.cuda`` touch in their hot entry points: the
  zero-overhead-off contract the monkeypatch-boom tests pin.
* ``thread-name`` — every thread the port starts carries a stable
  ``znicz:<component>`` name (``core/pyprof.py`` attributes samples
  by thread name).

Plus the style checks: ``syntax``, ``tabs``, ``trailing-whitespace``,
``line-length``, ``unused-import`` (names used only inside string
constants count when dotted or in a doctest line), ``bare-except``,
``library-print``.

Suppression: ``# noqa`` keeps its meaning on style lines;
``# graftlint: disable=check-id[,check-id...]`` suppresses the named
checks on that line (on a ``def`` / ``class`` line, for the whole
body); the CLI also honours a reviewed baseline file of ``path ::
check :: token`` fingerprints (``tools/graftlint_torch_baseline.txt``).

Scope (:func:`iter_py`): ``znicz_tpu_torch/`` (style and invariants),
``tests/test_torch_*.py`` (style: tests monkeypatch around every
invariant), the port's tools (``tools/trace_records.py`` and
``tools/graftlint_torch.py``, both) and ``chip_smoke.py``
(invariants).
"""

import ast
import os
import re

# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

#: first dotted segment of every legal telemetry series name — the JAX
#: package's families less its ``jax`` compile family; extend ONLY with
#: a reviewed family prefix (each series is a /metrics entry)
SERIES_PREFIXES = frozenset((
    "analysis", "blackbox", "faults", "fleet", "health", "launcher",
    "loader", "memory", "profiler", "pyprof", "registry", "release",
    "router", "serving", "slo", "snapshotter", "timeseries", "trainer",
    "transfer", "unit", "wire", "workflow",
))

#: legal ``labeled()`` label keys — a bounded set by design (every
#: (key, value) pair mints a new series): the JAX package's
LABEL_KEYS = frozenset((
    "bucket", "breaker", "codec", "device", "dtype", "gen", "model",
    "priority", "replica", "scenario", "site",
))

#: identifiers that mark a label VALUE as derived from request data —
#: unbounded cardinality (one series per request id or payload)
LABEL_VALUE_DENY = frozenset((
    "request_id", "request_ids", "rid", "rids", "request", "req",
    "payload", "body", "uuid",
))

_SERIES_RE = re.compile(r"^[a-z][a-z0-9_.]*$")

#: Config methods that may terminate a knob chain
_CFG_METHODS = frozenset(("get", "update", "items", "keys", "as_dict",
                          "print_", "to_json"))

#: container-mutating method names counted as writes by lock-guard
_MUTATORS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear",
    "update", "setdefault", "sort", "reverse", "rotate",
))

#: gated subsystems: per-module gate-function names and the hot entry
#: points REQUIRED to gate (the zero-overhead-off contract)
GATED_MODULES = {
    "znicz_tpu_torch/core/health.py": {
        "gates": ("enabled",),
        "required": ("check_training_step", "check_gd_unit",
                     "observe_loss"),
    },
    "znicz_tpu_torch/core/profiler.py": {
        "gates": ("enabled",),
        "required": ("register_cost", "ledger_swap", "epoch_check",
                     "note_data_wait", "note_gd_step", "window_probe"),
    },
    "znicz_tpu_torch/core/faults.py": {
        "gates": ("enabled",),
        "required": (),
    },
    "znicz_tpu_torch/core/telemetry.py": {
        "gates": ("enabled", "journal_enabled", "_get_metric"),
        "required": ("instant", "record_event", "counter", "gauge",
                     "histogram"),
    },
    "znicz_tpu_torch/analysis/locksmith.py": {
        "gates": ("enabled",),
        "required": ("lock", "rlock", "condition"),
    },
    "znicz_tpu_torch/core/timeseries.py": {
        "gates": ("enabled",),
        "required": ("sample_once", "maybe_start"),
    },
    "znicz_tpu_torch/core/pyprof.py": {
        "gates": ("enabled",),
        "required": ("sample_once", "maybe_start", "gil_probe_once"),
    },
    "znicz_tpu_torch/serving/reqtrace.py": {
        "gates": ("enabled", "sampled"),
        "required": ("begin",),
    },
    "znicz_tpu_torch/core/blackbox.py": {
        "gates": ("enabled",),
        "required": ("maybe_arm",),
    },
}

#: the device bodies the torch-host-sync / torch-rng checks scan: the
#: port's counterparts of the functions the JAX package hands to
#: ``jax.jit`` or ``lax.scan``, by module, each with its HOST
#: parameters (Python numbers and layouts, as ``static_argnames``
#: marks them for ``jax.jit``: ``int()`` of one reads no device);
#: ``Outer.inner`` names a method of a class, or a function defined
#: inside another
TRACED_BODIES = {
    # the fused trainer: JAX's step_fn, window_fn / scan_fn and their
    # scan bodies, fwd_idx and the jitted forwards
    "znicz_tpu_torch/parallel/fused.py": {
        "forward": (), "_stochastic_pool": (), "_hits": (),
        "_loss_and_stats": (), "_loss_mse": ("batch_size",),
        "_apply_weight_masks": (), "_grad_step": (), "_train_step": (),
        "_train_step_mse": (), "FusedNet.step": (),
        "FusedNet.step_mse": ("batch_size",), "FusedNet.run_steps": (),
        "FusedNet._window_steps": ("batch_sizes",),
        "FusedNet._window_steps_mse": ("batch_sizes",),
        "FusedNet._forward_eval": (), "FusedNet.predict": (),
        "FusedNet.predict_with_idx": (),
        "FusedNet.set_epoch_perm": ("perm", "pad"),
        # the sharded step's one all-reduce and the window fold
        "_rank_labels": (), "_all_reduce_step": (),
        "FusedNet.fold_shards": ()},
    # the ring (JAX's shard_map body fwd and its fori_loop body)
    "znicz_tpu_torch/parallel/sequence.py": {
        "attention_reference": ("causal",), "_ring_body": ("scale",
                                                          "causal"),
        "_ring_local": ("axis", "n", "t_local", "causal")},
    # long_context's jitted gradient
    "znicz_tpu_torch/samples/research/long_context.py": {
        "forward": ("heads",), "loss_fn": ("heads",)},
    # the genetic optimizer's batched generation (JAX's vmapped
    # train_eval with its epoch and step scans)
    "znicz_tpu_torch/parallel/population.py": {
        "_conv": (), "_folded": (), "forward": (), "_train_step": (),
        "make_population_evaluator.train": (),
        "make_population_evaluator.fitness": ("n",)},
    # the GD math (JAX _update_jax)
    "znicz_tpu_torch/ops/gd_math.py": {"_gradient_step": (),
                                       "update": ()},
    # the evaluators (JAX softmax_ce_jax, mse_jax)
    "znicz_tpu_torch/ops/evaluator.py": {
        "_one_hot": (), "softmax_ce": (), "eval_stats": (), "mse": ()},
    "znicz_tpu_torch/ops/dense.py": {"forward": (), "softmax": (),
                                     "backward": ()},
    "znicz_tpu_torch/ops/conv.py": {
        "forward": (), "deconv_forward": (), "deconv_hits": (),
        "deconv_backward": (),
        "backward": ("need_err_input", "include_bias")},
    "znicz_tpu_torch/ops/normalization.py": {"lrn_forward": (),
                                             "lrn_backward": ()},
    "znicz_tpu_torch/ops/kohonen.py": {
        "winners": (), "train_step": (),
        "train_step_sharded": ("sigma", "gmult")},
    "znicz_tpu_torch/ops/recurrent.py": {"lstm_cell": (),
                                         "lstm_scan": ()},
    "znicz_tpu_torch/ops/pooling.py": {
        "max_pooling_plain": (), "max_pooling": (),
        "max_pooling_backward_plain": (), "max_pooling_backward": (),
        "depooling": (), "stochastic_pooling": (),
        "stochastic_pool_depool": (),
        "max_pooling_train": ("ky", "kx", "sliding", "use_abs"),
        "max_pooling_gather": (), "pooling_reduce_window": (),
        "max_pooling_reshape": ("ky", "kx", "use_abs"),
        "avg_pooling_reshape": (), "avg_pooling": (),
        "avg_pooling_backward": ()},
    # the health monitor's one reduction over every tree (JAX kernel),
    # whose one readback is memory.host_fetch
    "znicz_tpu_torch/core/health.py": {"_leaf_norms": ()},
    # the serving forward (JAX's jitted engine forward); a layer's
    # manifest entry is host data
    "znicz_tpu_torch/serving/engine.py": {
        "forward": (), "apply_layer": ("entry",),
        "_apply_quantized_layer": ("entry",),
        "_apply_fast_layer": ("entry",)},
    # the scan LSTM's gradient (JAX bwd)
    "znicz_tpu_torch/units/lstm_scan.py": {"GDLSTMScan.run": ()},
}

# style-check knobs
MAX_LINE = 80
LIB_DIRS = ("znicz_tpu_torch/",)
PRINT_OK = ("samples", "__main__.py", "launcher.py", "parity.py")


class Finding(object):
    """One reported violation."""

    __slots__ = ("path", "line", "check", "message", "token")

    def __init__(self, path, line, check, message, token=""):
        self.path = path
        self.line = int(line)
        self.check = check
        self.message = message
        self.token = token or ""

    @property
    def fingerprint(self):
        """Line-number-free identity for the baseline file."""
        return "%s :: %s :: %s" % (self.path, self.check, self.token)

    def __str__(self):
        return "%s:%d: [%s] %s" % (self.path, self.line, self.check,
                                   self.message)

    def __repr__(self):
        return "<Finding %s>" % self


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*([^#]*)")
_GUARDED_RE = re.compile(r"guarded-by\(([^)]+)\)")
_DISABLE_RE = re.compile(r"disable=([A-Za-z0-9_,-]+)")


class _Pragmas(object):
    """Per-file pragma index: line -> disabled checks / guard lock."""

    def __init__(self, lines):
        self.disabled = {}    # lineno -> set of check ids
        self.guarded = {}     # lineno -> lock attr name (e.g. "_lock")
        for i, line in enumerate(lines, 1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            text = m.group(1)
            d = _DISABLE_RE.search(text)
            if d:
                self.disabled[i] = set(
                    c.strip() for c in d.group(1).split(",") if c)
            g = _GUARDED_RE.search(text)
            if g:
                lock = g.group(1).strip()
                if lock.startswith("self."):
                    lock = lock[len("self."):]
                self.guarded[i] = lock

    def allows(self, check, lineno):
        return check in self.disabled.get(lineno, ())

    def allows_span(self, check, node):
        """A pragma anywhere on the lines a (possibly multi-line)
        expression spans suppresses it."""
        end = getattr(node, "end_lineno", None) or node.lineno
        return any(self.allows(check, i)
                   for i in range(node.lineno, end + 1))


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

def _attr_chain(node):
    """``a.b.c`` -> ["a", "b", "c"]; None for non-trivial bases."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _walk(node):
    """Depth-first pre-order (ast.walk is BFS; checker logic needs
    source order)."""
    yield node
    for child in ast.iter_child_nodes(node):
        for sub in _walk(child):
            yield sub


def _parent_map(tree):
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _names_in(node):
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out

# ---------------------------------------------------------------------------
# Knob vocabulary
# ---------------------------------------------------------------------------

def load_vocabulary():
    """The declared knob and namespace paths of the port's
    ``core/config.py`` (an import of the config module alone)."""
    from znicz_tpu_torch.core import config
    return config.declared_knobs(), config.declared_nodes()


def _knob_declared(path, knobs, nodes):
    if path in knobs or path in nodes:
        return True
    parts = path.split(".")
    for i in range(1, len(parts)):
        if ".".join(parts[:i]) in knobs:
            return True   # payload inside a dict-valued knob
    return False


def check_knobs(tree, rel, pragmas, knobs, nodes, findings):
    """Every ``root.common.*`` path must resolve to a declared knob."""
    if rel.replace(os.sep, "/").endswith("znicz_tpu_torch/core/config.py"):
        return   # the declaration site itself
    parents = _parent_map(tree)
    # module/function aliases: NAME = root.common.<chain>
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            chain = _attr_chain(node.value) \
                if isinstance(node.value, ast.Attribute) else None
            if chain and chain[:2] == ["root", "common"]:
                aliases[node.targets[0].id] = ".".join(chain[1:])

    def resolve(chain):
        """Dotted path relative to ``root`` or None if unrelated."""
        if chain[:2] == ["root", "common"]:
            return ".".join(chain[1:])
        if chain[0] in aliases:
            return ".".join([aliases[chain[0]]] + chain[1:])
        return None

    def report(path, node):
        if pragmas.allows("knob-vocabulary", node.lineno):
            return
        if not _knob_declared(path, knobs, nodes):
            findings.append(Finding(
                rel, node.lineno, "knob-vocabulary",
                "undeclared config knob root.%s — declare it in "
                "core/config.py (config.declare) or fix the typo; an "
                "undeclared read auto-vivifies a truthy empty node"
                % path, token=path))

    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and \
                    parent.value is node:
                continue   # not a maximal chain
            chain = _attr_chain(node)
            if not chain:
                continue
            # chain ending in a Config method call: validate the base,
            # plus the literal key of .get(...)
            call = parent if isinstance(parent, ast.Call) and \
                parent.func is node else None
            if call is not None and chain[-1] in _CFG_METHODS:
                base = resolve(chain[:-1])
                if base is None:
                    continue
                report(base, node)
                if chain[-1] == "get" and call.args:
                    key = _const_str(call.args[0])
                    if key is not None:
                        report("%s.%s" % (base, key), node)
                continue
            path = resolve(chain)
            if path is not None:
                report(path, node)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("getattr", "setattr") and \
                len(node.args) >= 2:
            chain = _attr_chain(node.args[0]) \
                if isinstance(node.args[0], ast.Attribute) else (
                    [node.args[0].id]
                    if isinstance(node.args[0], ast.Name) else None)
            if not chain:
                continue
            base = resolve(chain) if len(chain) > 1 else (
                "common" if chain == ["root"] else
                aliases.get(chain[0]))
            if chain == ["root"]:
                base = None   # root.<x> only matters under common
            if base is None and chain[:1] == ["root"]:
                continue
            if base is None:
                continue
            key = _const_str(node.args[1])
            if key is not None:
                report("%s.%s" % (base, key), node)

# ---------------------------------------------------------------------------
# Telemetry series / label discipline
# ---------------------------------------------------------------------------

def _series_static_prefix(node, constants):
    """(full_name, prefix) for a statically-known series-name
    expression; (None, None) when dynamic.  ``full_name`` is set only
    for complete literals; templates yield just their static prefix."""
    s = _const_str(node)
    if s is not None:
        return s, s
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        left = _const_str(node.left)
        if left is not None:
            return None, left.split("%")[0]
    if isinstance(node, ast.JoinedStr) and node.values:
        head = _const_str(node.values[0])
        if head is not None:
            return None, head
    if isinstance(node, ast.Name) and node.id in constants:
        s = constants[node.id]
        return s, s
    return None, None


def _check_series_name(node, call, rel, pragmas, findings):
    """Validate one series-name expression; returns True if it was
    statically checkable."""
    # module-level string constants are resolved by the caller's
    # ``constants`` map threaded through check_telemetry
    full, prefix = node._graftlint_resolved
    lineno = node.lineno
    if pragmas.allows_span("telemetry-series", call):
        return True
    if full is not None:
        if not _SERIES_RE.match(full) or \
                full.split(".")[0] not in SERIES_PREFIXES or \
                "." not in full:
            findings.append(Finding(
                rel, lineno, "telemetry-series",
                "series name %r is outside the bounded vocabulary "
                "(family prefixes: %s)"
                % (full, ", ".join(sorted(SERIES_PREFIXES))),
                token=full))
        return True
    if prefix is not None:
        fam = prefix.split(".")[0]
        if "." not in prefix or fam not in SERIES_PREFIXES:
            findings.append(Finding(
                rel, lineno, "telemetry-series",
                "templated series name %r* does not start with a "
                "known family prefix" % prefix, token=prefix))
        return True
    findings.append(Finding(
        rel, lineno, "telemetry-series",
        "dynamic series name — metric names must be statically "
        "bounded (literal, literal template, or module constant)",
        token="<dynamic>"))
    return False


def _check_labels(call, rel, pragmas, findings):
    for kw in call.keywords:
        lineno = getattr(kw.value, "lineno", call.lineno)
        if kw.arg is None:
            if not pragmas.allows_span("telemetry-cardinality", call):
                findings.append(Finding(
                    rel, lineno, "telemetry-cardinality",
                    "**labels unpacking is not statically checkable "
                    "— pass explicit label keys (or pragma a reviewed "
                    "wrapper)", token="**"))
            continue
        if kw.arg == "name":
            if not pragmas.allows_span("telemetry-collision", call):
                findings.append(Finding(
                    rel, lineno, "telemetry-collision",
                    "label key 'name' collides with labeled()'s "
                    "positional parameter — TypeError at runtime "
                    "; pick another key",
                    token="name"))
            continue
        if kw.arg not in LABEL_KEYS:
            if not pragmas.allows_span("telemetry-cardinality", call):
                findings.append(Finding(
                    rel, lineno, "telemetry-cardinality",
                    "unknown label key %r — extend the reviewed "
                    "LABEL_KEYS vocabulary (analysis/graftlint.py) "
                    "only for bounded label sets" % kw.arg,
                    token=kw.arg))
            continue
        tainted = _names_in(kw.value) & LABEL_VALUE_DENY
        if tainted and not pragmas.allows_span(
                "telemetry-cardinality", call):
            findings.append(Finding(
                rel, lineno, "telemetry-cardinality",
                "label %r value derives from request data (%s) — "
                "unbounded cardinality mints one series per request"
                % (kw.arg, ", ".join(sorted(tainted))),
                token="%s=%s" % (kw.arg, ",".join(sorted(tainted)))))


def check_telemetry(tree, rel, pragmas, findings):
    in_telemetry = rel.replace(os.sep, "/").endswith(
        "znicz_tpu_torch/core/telemetry.py")
    constants = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            s = _const_str(node.value)
            if s is not None:
                constants[node.targets[0].id] = s

    def api_name(func):
        if isinstance(func, ast.Attribute):
            chain = _attr_chain(func)
            if chain and len(chain) >= 2 and \
                    chain[-2] == "telemetry" and \
                    chain[-1] in ("counter", "gauge", "histogram",
                                  "labeled"):
                return chain[-1]
            return None
        if in_telemetry and isinstance(func, ast.Name) and \
                func.id in ("counter", "gauge", "histogram",
                            "labeled"):
            return func.id
        return None

    def resolve_mark(expr):
        expr._graftlint_resolved = _series_static_prefix(expr,
                                                         constants)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        api = api_name(node.func)
        if api is None:
            continue
        name_arg = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "name":
                name_arg = kw.value if api != "labeled" else name_arg
        if api == "labeled":
            if name_arg is not None:
                resolve_mark(name_arg)
                _check_series_name(name_arg, node, rel, pragmas,
                                   findings)
            _check_labels(node, rel, pragmas, findings)
            continue
        # counter/gauge/histogram
        if name_arg is None:
            continue
        if isinstance(name_arg, ast.Call):
            inner_api = api_name(name_arg.func)
            if inner_api == "labeled":
                continue   # the labeled() call is checked on its own
            # wrapper pattern (engine._label(series, **labels)): the
            # first argument must be a checkable series name and the
            # keywords are labels
            if name_arg.args:
                resolve_mark(name_arg.args[0])
                _check_series_name(name_arg.args[0], name_arg, rel,
                                   pragmas, findings)
                _check_labels(name_arg, rel, pragmas, findings)
                continue
            if not pragmas.allows_span("telemetry-series", node):
                findings.append(Finding(
                    rel, name_arg.lineno, "telemetry-series",
                    "series name computed by an opaque call — not "
                    "statically bounded", token="<call>"))
            continue
        resolve_mark(name_arg)
        _check_series_name(name_arg, node, rel, pragmas, findings)

# ---------------------------------------------------------------------------
# Lock-guard discipline
# ---------------------------------------------------------------------------

_LOCK_FACTORIES = {
    ("threading", "Lock"), ("threading", "RLock"),
    ("threading", "Condition"),
    ("locksmith", "lock"), ("locksmith", "rlock"),
    ("locksmith", "condition"),
}


def _is_lock_factory(node):
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return bool(chain) and len(chain) >= 2 and \
        (chain[-2], chain[-1]) in _LOCK_FACTORIES


def _self_attr_target(node):
    """'self.X' / 'self.X[...]' -> 'X' (write target extraction)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == "self":
        return node.attr
    return None


def check_lock_guard(tree, rel, pragmas, findings):
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        lock_attrs = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and \
                        _is_lock_factory(node.value):
                    for t in node.targets:
                        attr = _self_attr_target(t)
                        if attr is not None:
                            lock_attrs.add(attr)
        if not lock_attrs:
            continue
        writes = []   # (attr, lineno, held frozenset, method name)

        def visit(node, held, init):
            if isinstance(node, ast.With):
                extra = set()
                for item in node.items:
                    attr = _self_attr_target(item.context_expr)
                    if attr in lock_attrs:
                        extra.add(attr)
                inner = held | extra
                for child in node.body:
                    visit(child, inner, init)
                return
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                # a nested function runs LATER, not under the lock
                body = node.body if not isinstance(node, ast.Lambda) \
                    else [node.body]
                nested_held = frozenset()
                g = pragmas.guarded.get(node.lineno)
                if g in lock_attrs:
                    nested_held = frozenset((g,))
                for child in body:
                    visit(child, set(nested_held), init)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    elts = t.elts if isinstance(t, (ast.Tuple,
                                                    ast.List)) else [t]
                    for e in elts:
                        attr = _self_attr_target(e)
                        if attr is not None and not init:
                            writes.append((attr, node.lineno,
                                           frozenset(held)))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                attr = _self_attr_target(node.func.value)
                if attr is not None and not init:
                    writes.append((attr, node.lineno, frozenset(held)))
            for child in ast.iter_child_nodes(node):
                visit(child, held, init)

        for m in methods:
            init = m.name in ("__init__", "__new__")
            held = set()
            g = pragmas.guarded.get(m.lineno)
            if g in lock_attrs:
                held.add(g)
            for child in m.body:
                visit(child, held, init)

        guarded_by = {}   # attr -> set of locks it is written under
        for attr, _, held in writes:
            if held:
                guarded_by.setdefault(attr, set()).update(held)
        for attr, lineno, held in writes:
            locks = guarded_by.get(attr)
            if not locks or held & locks:
                continue
            if attr in lock_attrs:
                continue
            if pragmas.allows("lock-guard", lineno):
                continue
            findings.append(Finding(
                rel, lineno, "lock-guard",
                "%s.%s is written under %s elsewhere but unguarded "
                "here — take the lock, or mark the method "
                "'# graftlint: guarded-by(self.%s)' if the caller "
                "already holds it"
                % (cls.name, attr,
                   "/".join("self.%s" % x for x in sorted(locks)),
                   sorted(locks)[0]),
                token="%s.%s" % (cls.name, attr)))


# ---------------------------------------------------------------------------
# Host syncs and host RNG in the device bodies
# ---------------------------------------------------------------------------

#: tensor methods that read the card back to the host
_SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))
#: tensor metadata: ``int(x.shape[0])`` and the like read no device
#: memory
_META_ATTRS = frozenset(("shape", "ndim", "size", "numel", "dim",
                         "dtype", "device", "element_size"))
#: ``torch.<draw>(...)`` calls that take a ``generator=``
_TORCH_DRAWS = frozenset((
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like"))
#: in-place tensor draws that take a ``generator=``
_TENSOR_DRAWS = frozenset((
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_"))


def _traced_defs(tree, names):
    """``(qualified name, def)`` of each function of ``names`` defined
    in ``tree`` (``Outer.inner`` for a method or a nested function)."""
    found = []

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = prefix + child.name
                if qual in names and not isinstance(child, ast.ClassDef):
                    found.append((qual, child))
                visit(child, qual + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return found


def _fn_params(fn):
    args = fn.args
    names = [a.arg for a in args.args + args.posonlyargs +
             args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    return set(n for n in names if n != "self")


def check_torch(tree, rel, pragmas, findings):
    """The device bodies :data:`TRACED_BODIES` declares for ``rel``."""
    rel_posix = rel.replace(os.sep, "/")
    declared = None
    for suffix, bodies in TRACED_BODIES.items():
        if rel_posix.endswith(suffix):
            declared = bodies
            break
    if declared is None:
        return
    for qual, fn in _traced_defs(tree, declared):
        _scan_device_body(fn, qual, frozenset(declared[qual]), rel,
                          pragmas, findings)


def _scan_device_body(fn, qual, host, rel, pragmas, findings):
    params = _fn_params(fn) - host
    for stmt in fn.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            lineno = node.lineno
            chain = _attr_chain(node.func) or []
            attr = node.func.attr \
                if isinstance(node.func, ast.Attribute) else None
            kws = set(k.arg for k in node.keywords)
            sync = rng = None
            if isinstance(node.func, ast.Name) and \
                    node.func.id in ("float", "int", "bool") and \
                    node.args and (_names_in(node.args[0]) & params) \
                    and not any(
                        isinstance(n, ast.Attribute)
                        and n.attr in _META_ATTRS
                        for n in ast.walk(node.args[0])):
                sync = ("%s() of a tensor parameter" % node.func.id,
                        node.func.id)
            elif attr in _SYNC_METHODS:
                sync = (".%s()" % attr, attr)
            elif len(chain) >= 2 and chain[0] in ("numpy", "np") and \
                    chain[1] in ("asarray", "array") and node.args \
                    and (_names_in(node.args[0]) & params):
                sync = ("%s of a tensor parameter" % ".".join(chain[:2]),
                        ".".join(chain[:2]))
            elif chain[-2:] == ["cuda", "synchronize"]:
                sync = ("torch.cuda.synchronize()",
                        "torch.cuda.synchronize")
            elif (chain[:1] == ["random"] and len(chain) >= 2) or (
                    len(chain) >= 3 and chain[0] in ("numpy", "np")
                    and chain[1] == "random"):
                rng = ("a host draw (%s) differs from the device "
                       "generator's stream and reseeds nothing"
                       % ".".join(chain), ".".join(chain[:2]))
            elif ((chain[:1] == ["torch"] and len(chain) == 2
                   and chain[1] in _TORCH_DRAWS)
                  or attr in _TENSOR_DRAWS) and \
                    "generator" not in kws and None not in kws:
                rng = ("%s without generator= draws from the global "
                       "stream" % (".".join(chain) or "." + attr),
                       chain[-1] if chain else attr)
            if sync is not None and \
                    not pragmas.allows("torch-host-sync", lineno):
                findings.append(Finding(
                    rel, lineno, "torch-host-sync",
                    "%s inside the device body %s waits for the card "
                    "(a readback)" % (sync[0], qual),
                    token="%s:%s" % (qual, sync[1])))
            if rng is not None and \
                    not pragmas.allows("torch-rng", lineno):
                findings.append(Finding(
                    rel, lineno, "torch-rng",
                    "%s inside the device body %s — draw on the net's "
                    "torch.Generator" % (rng[0], qual),
                    token="%s:%s" % (qual, rng[1])))


# ---------------------------------------------------------------------------
# Gate discipline
# ---------------------------------------------------------------------------

def check_gate_order(tree, rel, pragmas, findings):
    spec = None
    rel_posix = rel.replace(os.sep, "/")
    for suffix, s in GATED_MODULES.items():
        if rel_posix.endswith(suffix):
            spec = s
            break
    if spec is None:
        return
    gates = set(spec["gates"])
    required = set(spec["required"])

    for fn in tree.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name.startswith("_") and fn.name not in required:
            continue
        if fn.name in gates or fn.name in ("enable", "disable",
                                           "reset"):
            continue
        if pragmas.allows("gate-order", fn.lineno):
            continue
        gate_line = None
        hot = None   # (lineno, what) of the first hot touch
        for node in _walk(fn):
            if node is fn:
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in gates:
                gate_line = node.lineno
                break
            if hot is not None:
                continue
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", None) or ",".join(
                    a.name for a in node.names)
                if mod.startswith("torch.cuda"):
                    hot = (node.lineno, "torch.cuda import")
            elif isinstance(node, ast.Attribute):
                chain = _attr_chain(node)
                if not chain:
                    continue
                if chain[:2] == ["torch", "cuda"]:
                    hot = (node.lineno, "torch.cuda touch")
                elif chain[:2] == ["root", "common"]:
                    if chain[-1] == "enabled":
                        continue   # the gate's own knob
                    hot = (node.lineno,
                           "config walk root.%s" % ".".join(chain[1:]))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and node.args:
                key = _const_str(node.args[0])
                base = _attr_chain(node.func.value)
                if key not in (None, "enabled") and base and \
                        (base[0].endswith("cfg")
                         or base[:2] == ["root", "common"]):
                    hot = (node.lineno, "config read %r" % key)
        if fn.name in required and gate_line is None:
            findings.append(Finding(
                rel, fn.lineno, "gate-order",
                "%s() is a hot entry point of a disabled-by-default "
                "subsystem and never checks the %s gate"
                % (fn.name, "/".join(sorted(gates))), token=fn.name))
        elif gate_line is not None and hot is not None:
            findings.append(Finding(
                rel, hot[0], "gate-order",
                "%s() does %s before the gate at line %d — the "
                "disabled path must be ONE predicate"
                % (fn.name, hot[1], gate_line), token=fn.name))

def check_thread_name(tree, rel, pragmas, findings):
    """Every thread the port starts carries a stable
    ``znicz:<component>`` name: the sampling profiler
    (``core/pyprof.py``) attributes stack samples BY THREAD NAME, so a
    thread made without one surfaces as ``Thread-12`` and its samples
    land in the ``unnamed`` bucket.  Flags ``threading.Thread(...)``
    without ``name=`` and ``ThreadPoolExecutor(...)`` without
    ``thread_name_prefix=`` (a ``**kwargs`` splat is trusted to carry
    the name)."""
    for node in _walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            fname = node.func.attr
        elif isinstance(node.func, ast.Name):
            fname = node.func.id
        else:
            continue
        if fname not in ("Thread", "ThreadPoolExecutor"):
            continue
        kw = "name" if fname == "Thread" else "thread_name_prefix"
        passed = {k.arg for k in node.keywords}
        if None in passed or kw in passed:
            continue
        if pragmas.allows("thread-name", node.lineno):
            continue
        findings.append(Finding(
            rel, node.lineno, "thread-name",
            "%s(...) constructed without %s= — every spawned thread "
            "needs a stable znicz:<component> name so pyprof sample "
            "attribution never reads Thread-N (core/pyprof.py "
            "thread_name())" % (fname, kw), token=fname))


# ---------------------------------------------------------------------------
# Style checks
# ---------------------------------------------------------------------------

def check_style(tree, lines, rel, pragmas, findings):
    rel_posix = rel.replace(os.sep, "/")
    for i, line in enumerate(lines, 1):
        stripped = line.rstrip("\n")
        indent = stripped[:len(stripped) - len(stripped.lstrip())]
        if "\t" in indent and not pragmas.allows("tabs", i):
            findings.append(Finding(rel, i, "tabs",
                                    "tab in indentation"))
        if stripped != stripped.rstrip() and \
                not pragmas.allows("trailing-whitespace", i):
            findings.append(Finding(rel, i, "trailing-whitespace",
                                    "trailing whitespace"))
        if len(stripped) > MAX_LINE and "noqa" not in stripped and \
                not pragmas.allows("line-length", i):
            findings.append(Finding(
                rel, i, "line-length",
                "line too long (%d > %d)" % (len(stripped),
                                             MAX_LINE)))
    findings.extend(_unused_imports(tree, lines, rel, pragmas))
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and not pragmas.allows("bare-except", node.lineno):
            findings.append(Finding(rel, node.lineno, "bare-except",
                                    "bare except"))
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
                and rel_posix.startswith(LIB_DIRS)
                and not any(p in rel_posix for p in PRINT_OK)
                and node.lineno <= len(lines)
                and "noqa" not in lines[node.lineno - 1]
                and not pragmas.allows("library-print", node.lineno)):
            findings.append(Finding(
                rel, node.lineno, "library-print",
                "print() in library code (use the logger)"))


def _unused_imports(tree, lines, rel, pragmas):
    imported = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "*":
                    continue
                imported[alias.asname or alias.name] = node.lineno
    if not imported:
        return []
    used = set()
    string_text = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str):
            string_text.append(node.value)
    # the legacy checker's blind spot: a name referenced only inside a
    # string constant — an f-string template kept as a plain string, a
    # docstring doctest (`>>> numpy.ones(...)`) — is still a use.
    # Only DOTTED usage (`name.attr`) or a doctest line mentioning the
    # name counts: a bare prose word ("baked in at trace time") must
    # not grandfather a dead `import time`
    blob = "\n".join(string_text)
    out = []
    for name, lineno in imported.items():
        if name in used:
            continue
        line = lines[lineno - 1] if lineno <= len(lines) else ""
        if "noqa" in line or pragmas.allows("unused-import", lineno):
            continue
        esc = re.escape(name)
        if blob and (re.search(r"\b%s\s*\.\s*\w" % esc, blob)
                     or re.search(r"^\s*>>>.*\b%s\b" % esc, blob,
                                  re.MULTILINE)):
            continue
        out.append(Finding(rel, lineno, "unused-import",
                           "unused import %r" % name, token=name))
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

#: the port's package: style and invariants
PACKAGE = "znicz_tpu_torch"
#: the port's tests (style only: they monkeypatch around every
#: invariant), by file name
TEST_RE = re.compile(r"^test_torch_\w*\.py$")
#: the port's tools: style and invariants
TOOL_FILES = ("tools/trace_records.py", "tools/graftlint_torch.py")
#: invariants only, as the JAX package's scan treats bench.py
INVARIANT_FILES = ("chip_smoke.py",)
SKIP_PARTS = ("__pycache__",)


def check_source(src, rel, vocab=None, style=True, invariants=True):
    """Run every applicable checker over one source blob; the unit of
    both the CLI and the selftest fixtures."""
    findings = []
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 0, "syntax",
                        "syntax error: %s" % e.msg)]
    pragmas = _Pragmas(lines)
    if style:
        check_style(tree, lines, rel, pragmas, findings)
    if invariants:
        if vocab is None:
            vocab = load_vocabulary()
        knobs, nodes = vocab
        check_knobs(tree, rel, pragmas, knobs, nodes, findings)
        check_telemetry(tree, rel, pragmas, findings)
        check_lock_guard(tree, rel, pragmas, findings)
        check_torch(tree, rel, pragmas, findings)
        check_gate_order(tree, rel, pragmas, findings)
        check_thread_name(tree, rel, pragmas, findings)
    return findings


def iter_py(root):
    """``(path, rel, style?, invariants?)`` over the scan scope."""
    top = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames.sort()
        if any(p in dirpath for p in SKIP_PARTS):
            continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield path, os.path.relpath(path, root), True, True
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        for fn in sorted(os.listdir(tests)):
            if TEST_RE.match(fn):
                yield (os.path.join(tests, fn), os.path.join("tests", fn),
                       True, False)
    for rel in TOOL_FILES:
        if os.path.exists(os.path.join(root, rel)):
            yield os.path.join(root, rel), rel, True, True
    for rel in INVARIANT_FILES:
        if os.path.exists(os.path.join(root, rel)):
            yield os.path.join(root, rel), rel, False, True


def run(root, vocab=None):
    """Scan the whole scope; returns the finding list."""
    if vocab is None:
        vocab = load_vocabulary()
    findings = []
    for path, rel, style, inv in iter_py(root):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        findings.extend(check_source(src, rel, vocab=vocab,
                                     style=style, invariants=inv))
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return findings


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path):
    """Fingerprints from the reviewed baseline file (``path :: check
    :: token`` lines; '#' comments and blanks ignored)."""
    entries = set()
    if not path or not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                entries.add(line)
    return entries


def apply_baseline(findings, baseline):
    """(kept, suppressed, stale-entries)."""
    kept, suppressed = [], []
    hit = set()
    for f in findings:
        if f.fingerprint in baseline:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            kept.append(f)
    return kept, suppressed, sorted(baseline - hit)


# ---------------------------------------------------------------------------
# Selftest — a seeded violation and a clean twin per checker: a run
# proves every checker can still reject before it trusts a clean scan
# ---------------------------------------------------------------------------

#: check id -> {rel, bad, clean}.  The violating line carries the word
#: "seeded"; the clean twin must produce ZERO findings of any kind.
FIXTURES = {
    "knob-vocabulary": {
        "rel": "znicz_tpu_torch/fixture_knob.py",
        "bad": '''\
from znicz_tpu_torch.core.config import root

limit = root.common.serving.breaker_treshold  # seeded typo
''',
        "clean": '''\
from znicz_tpu_torch.core.config import root

limit = root.common.serving.get("breaker_threshold", 5)
''',
    },
    "telemetry-series": {
        "rel": "znicz_tpu_torch/fixture_series.py",
        "bad": '''\
from znicz_tpu_torch.core import telemetry

telemetry.counter("oops.requests").inc()  # seeded bad family
''',
        "clean": '''\
from znicz_tpu_torch.core import telemetry

telemetry.counter("serving.predictions").inc()
''',
    },
    "telemetry-collision": {
        "rel": "znicz_tpu_torch/fixture_collision.py",
        "bad": '''\
from znicz_tpu_torch.core import telemetry


def note(which):
    telemetry.gauge(telemetry.labeled(
        "serving.breaker_open", name=which)).set(1)  # seeded
''',
        "clean": '''\
from znicz_tpu_torch.core import telemetry


def note(which):
    telemetry.gauge(telemetry.labeled(
        "serving.breaker_open", breaker=which)).set(1)
''',
    },
    "telemetry-cardinality": {
        "rel": "znicz_tpu_torch/fixture_cardinality.py",
        "bad": '''\
from znicz_tpu_torch.core import telemetry


def note(request_id):
    telemetry.counter(telemetry.labeled(
        "serving.rejected", model=request_id)).inc()  # seeded
''',
        "clean": '''\
from znicz_tpu_torch.core import telemetry


def note(model):
    telemetry.counter(telemetry.labeled(
        "serving.rejected", model=model)).inc()
''',
    },
    "lock-guard": {
        "rel": "znicz_tpu_torch/fixture_lock.py",
        "bad": '''\
import threading


class Box(object):
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def put(self, x):
        with self._lock:
            self.items.append(x)

    def drop(self):
        self.items = []  # seeded unguarded write
''',
        "clean": '''\
import threading


class Box(object):
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def put(self, x):
        with self._lock:
            self.items.append(x)

    def drop(self):
        with self._lock:
            self.items = []
''',
    },
    "torch-host-sync": {
        "rel": "znicz_tpu_torch/ops/gd_math.py",
        "bad": '''\
def update(w, grad):
    scale = float(grad.abs().max())  # seeded host sync
    return w - grad / scale
''',
        "clean": '''\
def update(w, grad):
    return w - grad / grad.abs().max()


def norm(w):
    return float(w.norm())
''',
    },
    "torch-rng": {
        "rel": "znicz_tpu_torch/ops/gd_math.py",
        "bad": '''\
import numpy


def update(w, grad):
    noise = numpy.random.random()  # seeded host draw
    return w - grad * noise
''',
        "clean": '''\
import torch


def update(w, grad, generator):
    noise = torch.rand((), generator=generator)
    return w - grad * noise
''',
    },
    "gate-order": {
        "rel": "znicz_tpu_torch/core/health.py",
        "bad": '''\
from znicz_tpu_torch.core.config import root


def enabled():
    return bool(root.common.health.get("enabled", False))


def observe_loss(value):
    interval = root.common.health.get("interval", 1)  # seeded
    if not enabled():
        return None
    return interval + value
''',
        "clean": '''\
from znicz_tpu_torch.core.config import root


def enabled():
    return bool(root.common.health.get("enabled", False))


def observe_loss(value):
    if not enabled():
        return None
    return root.common.health.get("interval", 1) + value


def check_training_step(steps=1):
    if not enabled():
        return None
    return steps


def check_gd_unit(unit):
    if not enabled():
        return None
    return unit
''',
    },
    "thread-name": {
        "rel": "znicz_tpu_torch/fixture_thread.py",
        "bad": '''\
import threading


def start(worker):
    t = threading.Thread(target=worker, daemon=True)  # seeded
    t.start()
    return t
''',
        "clean": '''\
import threading


def start(worker):
    t = threading.Thread(target=worker, name="znicz:worker",
                         daemon=True)
    t.start()
    return t
''',
    },
    "syntax": {
        "rel": "znicz_tpu_torch/fixture_syntax.py",
        "bad": "def broken(:\n",
        "clean": "X = 1\n",
    },
    "tabs": {
        "rel": "znicz_tpu_torch/fixture_tabs.py",
        "bad": "def f():\n\treturn 1  # seeded tab indent\n",
        "clean": "def f():\n    return 1\n",
    },
    "trailing-whitespace": {
        "rel": "znicz_tpu_torch/fixture_ws.py",
        "bad": "X = 1  # seeded trailing blanks   \n",
        "clean": "X = 1\n",
    },
    "line-length": {
        "rel": "znicz_tpu_torch/fixture_len.py",
        "bad": ("X = 1  # seeded: " + "x" * 70 + "\n"),
        "clean": "X = 1\n",
    },
    "unused-import": {
        "rel": "znicz_tpu_torch/fixture_imports.py",
        "bad": '''\
import os  # seeded: never referenced anywhere
import math

S = f"pi is {math.pi}"
''',
        # the legacy checker's blind spot: names used only inside a
        # docstring doctest (plain string constants) were flagged
        "clean": '''\
"""Helpers.

>>> import znicz_tpu_torch.fixture_imports
>>> math.floor(1.5)
1
"""
import math

S = f"pi is {math.pi}"
''',
    },
    "bare-except": {
        "rel": "znicz_tpu_torch/fixture_except.py",
        "bad": '''\
try:
    X = 1
except:  # seeded
    X = 2
''',
        "clean": '''\
try:
    X = 1
except ValueError:
    X = 2
''',
    },
    "library-print": {
        "rel": "znicz_tpu_torch/fixture_print.py",
        "bad": '''\
def report(x):
    print(x)  # seeded stdout in library code
''',
        "clean": '''\
import logging


def report(x):
    logging.getLogger("fixture").info("%s", x)
''',
    },
}


def selftest(vocab=None):
    """Prove every checker still rejects its seeded violation (with
    the right check id and line) and passes the clean twin.  Returns a
    list of problem strings — empty means the selftest passed."""
    if vocab is None:
        vocab = load_vocabulary()
    problems = []
    for check, fx in sorted(FIXTURES.items()):
        bad = check_source(fx["bad"], fx["rel"], vocab=vocab)
        hits = [f for f in bad if f.check == check]
        if not hits:
            problems.append(
                "%s: seeded violation NOT rejected (findings: %s)"
                % (check, [str(f) for f in bad]))
        elif check != "syntax":
            expected = next(
                (i for i, line in
                 enumerate(fx["bad"].splitlines(), 1)
                 if "seeded" in line), None)
            if expected is not None and \
                    not any(f.line == expected for f in hits):
                problems.append(
                    "%s: rejected at line(s) %s, expected %d"
                    % (check, sorted(f.line for f in hits), expected))
        clean = check_source(fx["clean"], fx["rel"], vocab=vocab)
        if clean:
            problems.append(
                "%s: clean twin produced findings: %s"
                % (check, [str(f) for f in clean]))
    return problems
