"""The port's static checkers (``znicz_tpu_torch.analysis.graftlint``)
against the JAX package's.

* Every checker rejects its seeded fixture at the seeded line and
  passes its clean twin; ``selftest()`` passes.
* The checks the port carries over as they are (knob vocabulary,
  telemetry, lock guard, gate order, thread names, style) give the
  same check ids and lines as the JAX package's ``check_source`` on
  the shared fixture sources (JAX's, with the package renamed).
* ``torch-host-sync`` and ``torch-rng`` on more than their fixtures;
  the JAX package's ``jax-time`` and ``jax-donation`` have no
  counterpart in eager PyTorch.
* Every function the JAX package jits or scans, in a module the port
  has ported, has its entry in the port's ``TRACED_BODIES`` or a
  reason here; every entry names a function that exists.
* The baseline round-trips, the CLI runs, and the port's tree is
  findings-clean against the empty baseline.
"""

import ast
import os
import subprocess
import sys

import pytest

from znicz_tpu.analysis import graftlint as jax_graftlint
from znicz_tpu_torch.analysis import graftlint
from znicz_tpu_torch.core import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = graftlint.load_vocabulary()
JAX_VOCAB = jax_graftlint.load_vocabulary()


def _check(src, rel="znicz_tpu_torch/fixture_mod.py"):
    return graftlint.check_source(src, rel, vocab=VOCAB)


def _ids(findings):
    return sorted(set(f.check for f in findings))


# ---------------------------------------------------------------------------
# The fixture pairs and the selftest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", sorted(graftlint.FIXTURES))
def test_fixture_pair(check):
    fx = graftlint.FIXTURES[check]
    bad = graftlint.check_source(fx["bad"], fx["rel"], vocab=VOCAB)
    hits = [f for f in bad if f.check == check]
    assert hits, "seeded %s violation not rejected: %s" % (
        check, [str(f) for f in bad])
    if check != "syntax":
        expected = next(i for i, line in
                        enumerate(fx["bad"].splitlines(), 1)
                        if "seeded" in line)
        assert any(f.line == expected for f in hits)
    clean = graftlint.check_source(fx["clean"], fx["rel"], vocab=VOCAB)
    assert clean == [], [str(f) for f in clean]


def test_selftest_passes():
    assert graftlint.selftest(vocab=VOCAB) == []


#: the checks the port carries over as they are
SHARED = ("knob-vocabulary", "telemetry-series", "telemetry-collision",
          "telemetry-cardinality", "lock-guard", "gate-order",
          "thread-name", "syntax", "tabs", "trailing-whitespace",
          "line-length", "unused-import", "bare-except", "library-print")


def _renamed(text):
    return text.replace("znicz_tpu", "znicz_tpu_torch")


@pytest.mark.parametrize("check", SHARED)
@pytest.mark.parametrize("twin", ["bad", "clean"])
def test_shared_checks_match_the_jax_package(check, twin):
    jfx, pfx = jax_graftlint.FIXTURES[check], graftlint.FIXTURES[check]
    assert pfx[twin] == _renamed(jfx[twin])
    assert pfx["rel"] == _renamed(jfx["rel"])
    want = jax_graftlint.check_source(jfx[twin], jfx["rel"],
                                      vocab=JAX_VOCAB)
    got = graftlint.check_source(pfx[twin], pfx["rel"], vocab=VOCAB)
    assert sorted((f.check, f.line) for f in got) == \
        sorted((f.check, f.line) for f in want)


def test_check_ids_are_the_jax_packages_less_jit_more_torch():
    ported = set(graftlint.FIXTURES)
    jax_ids = set(jax_graftlint.FIXTURES)
    assert ported - jax_ids == {"torch-host-sync", "torch-rng"}
    assert jax_ids - ported == {"jax-host-sync", "jax-rng", "jax-time",
                                "jax-donation"}


def test_no_time_or_donation_check_in_eager_bodies():
    """``jax-time`` and ``jax-donation`` have no meaning in eager
    PyTorch: a clock read in an eager body is read at every call (not
    baked in once at trace time), and nothing is donated (an update
    writes its buffers in place).  So a device body reading the clock
    and taking an accumulator is clean."""
    src = (
        "import time\n"
        "\n"
        "\n"
        "def update(acc, grad):\n"
        "    t0 = time.perf_counter()\n"
        "    return acc + grad, time.perf_counter() - t0\n"
    )
    assert _check(src, "znicz_tpu_torch/ops/gd_math.py") == []


# ---------------------------------------------------------------------------
# The device-body checks beyond their fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line,token", [
    ("    return w.sum().item()", "update:item"),
    ("    return w.tolist()", "update:tolist"),
    ("    return w.cpu()", "update:cpu"),
    ("    return w.detach().numpy()", "update:numpy"),
    ("    return bool(w)", "update:bool"),
    ("    return int(grad.argmax())", "update:int"),
    ("    return numpy.asarray(grad)", "update:numpy.asarray"),
    ("    return torch.cuda.synchronize()",
     "update:torch.cuda.synchronize"),
])
def test_host_syncs_in_a_device_body(line, token):
    src = ("import numpy\nimport torch\n\nX = (numpy, torch)\n\n\n"
           "def update(w, grad):\n%s\n" % line)
    fs = _check(src, "znicz_tpu_torch/ops/gd_math.py")
    assert [(f.check, f.line, f.token) for f in fs] == [
        ("torch-host-sync", 8, token)]
    # the same function outside the table is host code: clean
    assert _check(src, "znicz_tpu_torch/ops/other.py") == []


@pytest.mark.parametrize("line,token", [
    ("    return w * torch.rand(w.shape)", "update:rand"),
    ("    return w * torch.randn_like(w)", "update:randn_like"),
    ("    return w.uniform_(0.0, 1.0)", "update:uniform_"),
    ("    return w * random.random()", "update:random.random"),
    ("    return w * numpy.random.rand()", "update:numpy.random"),
])
def test_host_and_global_draws_in_a_device_body(line, token):
    src = ("import random\n\nimport numpy\nimport torch\n\n"
           "X = (numpy, random, torch)\n\n\n"
           "def update(w, grad):\n%s\n" % line)
    fs = _check(src, "znicz_tpu_torch/ops/gd_math.py")
    assert [(f.check, f.line, f.token) for f in fs] == [
        ("torch-rng", 10, token)]


def test_draws_on_a_generator_and_host_parameters_are_clean():
    src = (
        "import torch\n"
        "\n"
        "\n"
        "def update(w, grad, generator):\n"
        "    noise = torch.rand(w.shape, generator=generator)\n"
        "    w.uniform_(0.0, 1.0, generator=generator)\n"
        "    return w * noise + int(w.shape[0]) + int(w.numel())\n"
        "\n"
        "\n"
        "def max_pooling_train(x, ky, kx, sliding, use_abs=False):\n"
        "    return x, int(ky), int(kx), tuple(sliding), bool(use_abs)\n"
    )
    assert _check(src, "znicz_tpu_torch/ops/gd_math.py") == []
    assert _check(src, "znicz_tpu_torch/ops/pooling.py") == []


def test_methods_and_nested_functions_resolve_by_qualified_name():
    src = (
        "class FusedNet(object):\n"
        "    def _window_steps(self, n_steps, batch_sizes):\n"
        "        def inner(t):\n"
        "            return t.item()\n"
        "        return inner(n_steps) + int(batch_sizes[0])\n"
        "\n"
        "    def host_fetch(self, tree):\n"
        "        return tree.cpu()\n"
    )
    fs = _check(src, "znicz_tpu_torch/parallel/fused.py")
    assert [(f.check, f.line, f.token) for f in fs] == [
        ("torch-host-sync", 4, "FusedNet._window_steps:item")]


def test_gate_order_counts_a_torch_cuda_touch():
    src = (
        "import torch\n"
        "\n"
        "from znicz_tpu_torch.core.config import root\n"
        "\n"
        "\n"
        "def enabled():\n"
        "    return bool(root.common.health.get(\"enabled\", False))\n"
        "\n"
        "\n"
        "def observe_loss(value):\n"
        "    torch.cuda.synchronize()\n"
        "    if not enabled():\n"
        "        return None\n"
        "    return value\n"
        "\n"
        "\n"
        "def check_training_step(steps=1):\n"
        "    return steps if enabled() else None\n"
        "\n"
        "\n"
        "def check_gd_unit(unit):\n"
        "    return unit if enabled() else None\n"
    )
    fs = _check(src, "znicz_tpu_torch/core/health.py")
    assert [(f.check, f.line) for f in fs] == [("gate-order", 11)]


def test_lock_sanitizer_knob_is_declared():
    assert config.knob_declared("common.analysis.lock_sanitizer")
    src = (
        "from znicz_tpu_torch.core.config import root\n"
        "\n"
        "A = root.common.analysis.get(\"lock_sanitizer\", False)\n"
        "B = root.common.analysis.lock_sanitiser\n"
    )
    fs = _check(src)
    assert [(f.check, f.line) for f in fs] == [("knob-vocabulary", 4)]


def test_locksmith_factories_count_for_lock_guard():
    src = (
        "from znicz_tpu_torch.analysis import locksmith\n"
        "\n"
        "\n"
        "class Box(object):\n"
        "    def __init__(self):\n"
        "        self._lock = locksmith.lock(\"box\")\n"
        "        self.items = []\n"
        "\n"
        "    def put(self, x):\n"
        "        with self._lock:\n"
        "            self.items.append(x)\n"
        "\n"
        "    def drop(self):\n"
        "        self.items = []\n"
    )
    assert [(f.check, f.line) for f in _check(src)] == [("lock-guard", 14)]


# ---------------------------------------------------------------------------
# The traced-body table against the JAX package's jits and scans
# ---------------------------------------------------------------------------

#: JAX modules with jitted or scanned functions and no port module of
#: that name, each with its reason
NOT_PORTED = {
    "ops/pallas_pooling.py": "the Pallas kernel's port is the CUDA "
                             "kernel of ops/cuda_pooling.py; its wrapper "
                             "plans and launches on the host",
}

#: (JAX module, traced function) -> the port's TRACED_BODIES entries of
#: the same module, or the reason there is none; a lambda is keyed by
#: its line
JAX_TO_PORT = {
    ("core/health.py", "kernel"): ("_leaf_norms",),
    ("core/profiler.py", "<lambda>:633"):
        "the capture's heartbeat jit under jax.profiler; the port's "
        "capture runs one small op before the body, no body of its own",
    ("ops/conv.py", "forward_jax"): ("forward",),
    ("ops/conv.py", "backward_jax"): ("backward",),
    ("ops/conv.py", "deconv_forward_jax"): ("deconv_forward",),
    ("ops/conv.py", "deconv_hits_jax"): ("deconv_hits",),
    ("ops/conv.py", "deconv_backward_jax"): ("deconv_backward",),
    ("ops/dense.py", "forward_jax"): ("forward",),
    ("ops/dense.py", "softmax_jax"): ("softmax",),
    ("ops/dense.py", "backward_jax"): ("backward",),
    ("ops/evaluator.py", "softmax_ce_jax"): ("softmax_ce", "eval_stats"),
    ("ops/evaluator.py", "mse_jax"): ("mse",),
    ("ops/gd_math.py", "_update_jax"): ("update", "_gradient_step"),
    ("ops/kohonen.py", "winners_jax"): ("winners",),
    ("ops/kohonen.py", "train_step_jax"): ("train_step",),
    ("ops/normalization.py", "lrn_forward_jax"): ("lrn_forward",),
    ("ops/normalization.py", "lrn_backward_jax"): ("lrn_backward",),
    ("ops/pooling.py", "max_pooling_gather_jax"): ("max_pooling_gather",),
    ("ops/pooling.py", "avg_pooling_reshape_jax"):
        ("avg_pooling_reshape",),
    ("ops/pooling.py", "pooling_fwd_jax"): ("pooling_reduce_window",),
    ("ops/pooling.py", "avg_pooling_jax"): ("avg_pooling",),
    ("ops/pooling.py", "stochastic_pooling_jax"): ("stochastic_pooling",),
    ("ops/pooling.py", "stochastic_pool_depool_jax"):
        ("stochastic_pool_depool",),
    ("ops/pooling.py", "max_pooling_backward_jax"):
        ("max_pooling_backward_plain", "max_pooling_backward"),
    ("ops/pooling.py", "avg_pooling_backward_jax"):
        ("avg_pooling_backward",),
    ("ops/recurrent.py", "lstm_scan_jax"): ("lstm_scan",),
    ("ops/recurrent.py", "body"): ("lstm_cell",),
    ("parallel/fused.py", "<lambda>:1165"): ("FusedNet._forward_eval",
                                             "FusedNet.predict"),
    ("parallel/fused.py", "<lambda>:2181"):
        "a mesh's per-leaf replicated readback: the port folds the "
        "ranks' partials in FusedNet.fold_shards (one all-reduce) and "
        "reads once in memory.host_fetch, with no jit per leaf",
    ("parallel/fused.py", "<lambda>:2197"):
        "FusedNet.params_finite: the reduction and its one readback, "
        "the rollback's probe, a readback by design",
    ("parallel/fused.py", "fwd_idx"): ("FusedNet.predict_with_idx",),
    ("parallel/fused.py", "step_fn"): ("_train_step", "_train_step_mse",
                                       "_grad_step", "FusedNet.step",
                                       "FusedNet.step_mse"),
    ("parallel/fused.py", "scan_fn"): ("FusedNet.run_steps",),
    ("parallel/fused.py", "body"): ("FusedNet.run_steps",
                                    "FusedNet._window_steps",
                                    "FusedNet._window_steps_mse"),
    ("parallel/fused.py", "window_fn"): ("FusedNet._window_steps",
                                         "FusedNet._window_steps_mse"),
    ("parallel/fused.py", "scan_body"): ("FusedNet._window_steps",
                                         "FusedNet._window_steps_mse"),
    ("parallel/fused.py", "materialize"): ("FusedNet.set_epoch_perm",),
    ("parallel/population.py", "train_eval"):
        ("make_population_evaluator.train",
         "make_population_evaluator.fitness"),
    ("parallel/population.py", "epoch"):
        ("make_population_evaluator.train",),
    ("parallel/population.py", "step"): ("_train_step",),
    ("serving/engine.py", "forward"): ("forward", "apply_layer"),
    ("units/lstm_scan.py", "bwd"): ("GDLSTMScan.run",),
    ("parallel/sequence.py", "fwd"): ("_ring_local", "_ring_body"),
    ("samples/research/long_context.py", "<lambda>:112"): ("loss_fn",
                                                           "forward"),
}


def _traced_name(arg):
    """The name of a function handed to jit / scan (through a vmap), a
    lambda as ``<lambda>:<line>``."""
    if isinstance(arg, ast.Lambda):
        return "<lambda>:%d" % arg.lineno
    if isinstance(arg, ast.Name):
        return arg.id
    if isinstance(arg, ast.Call) and arg.args:
        return _traced_name(arg.args[0])
    return None


def _jax_traced():
    """``{(module, name)}`` of every function the JAX package jits or
    scans, found as its graftlint finds them."""
    out = set()
    top = os.path.join(REPO, "znicz_tpu")
    for dirpath, _, files in os.walk(top):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, top).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef):
                    for dec in node.decorator_list:
                        call = dec if isinstance(dec, ast.Call) else None
                        if jax_graftlint._is_jax_jit(dec) or (
                                call is not None and (
                                    jax_graftlint._is_jax_jit(call.func)
                                    or any(jax_graftlint._is_jax_jit(a)
                                           for a in call.args))):
                            out.add((rel, node.name))
                elif isinstance(node, ast.Call) and node.args and (
                        jax_graftlint._is_jax_jit(node.func)
                        or jax_graftlint._is_lax_scan(node.func)):
                    name = _traced_name(node.args[0])
                    if name is not None:
                        out.add((rel, name))
    return out


def test_every_jax_traced_function_has_a_port_body_or_a_reason():
    traced = _jax_traced()
    assert len(traced) == 45
    ported = {(m, n) for m, n in traced
              if os.path.exists(os.path.join(REPO, "znicz_tpu_torch", m))}
    assert {m for m, _ in traced - ported} == set(NOT_PORTED)
    assert ported == set(JAX_TO_PORT), (
        sorted(ported - set(JAX_TO_PORT)),
        sorted(set(JAX_TO_PORT) - ported))
    for (module, name), target in JAX_TO_PORT.items():
        if isinstance(target, str):
            assert target
            continue
        bodies = graftlint.TRACED_BODIES["znicz_tpu_torch/" + module]
        assert set(target) <= set(bodies), (module, name, target)


def test_every_table_entry_names_a_function():
    for rel, bodies in graftlint.TRACED_BODIES.items():
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        found = {q for q, _ in graftlint._traced_defs(tree, set(bodies))}
        assert found == set(bodies), (rel, set(bodies) - found)
        args = {q: graftlint._fn_params(fn)
                for q, fn in graftlint._traced_defs(tree, set(bodies))}
        for qual, host in bodies.items():
            assert set(host) <= args[qual], (rel, qual, host)


def test_gated_modules_exist_with_their_entry_points():
    for rel, spec in graftlint.GATED_MODULES.items():
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            names = {n.name for n in ast.parse(f.read()).body
                     if isinstance(n, ast.FunctionDef)}
        assert set(spec["gates"]) | set(spec["required"]) <= names, rel
    assert len(graftlint.GATED_MODULES) == len(jax_graftlint.GATED_MODULES)


# ---------------------------------------------------------------------------
# Baseline, CLI, the tree
# ---------------------------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    f = graftlint.Finding("a/b.py", 3, "knob-vocabulary", "m",
                          token="common.x")
    path = tmp_path / "baseline.txt"
    path.write_text("# comment\n%s\nstale :: entry :: here\n"
                    % f.fingerprint)
    baseline = graftlint.load_baseline(str(path))
    kept, suppressed, stale = graftlint.apply_baseline([f], baseline)
    assert kept == [] and suppressed == [f]
    assert stale == ["stale :: entry :: here"]


def test_cli_selftest_and_scan():
    tool = os.path.join(REPO, "tools", "graftlint_torch.py")
    for args, said in ((["--selftest"], "graftlint selftest: 16"),
                       ([], "graftlint clean")):
        out = subprocess.run([sys.executable, tool] + args, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert said in out.stdout


def test_the_ports_tree_is_findings_clean():
    """The acceptance pin: the port's tree has no finding, and its
    reviewed baseline is empty."""
    findings = graftlint.run(REPO, vocab=VOCAB)
    baseline = graftlint.load_baseline(
        os.path.join(REPO, "tools", "graftlint_torch_baseline.txt"))
    assert baseline == set()
    assert findings == [], [str(f) for f in findings]
    scanned = {rel for _, rel, _, _ in graftlint.iter_py(REPO)}
    assert {"chip_smoke.py", "tools/graftlint_torch.py",
            "tools/trace_records.py",
            "znicz_tpu_torch/analysis/locksmith.py",
            "tests/test_torch_graftlint.py"} <= scanned
    assert not any(rel.startswith(("znicz_tpu/", "tests/unit"))
                   for rel in scanned)
