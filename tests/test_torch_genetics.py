"""The port's genetic optimizer (``core/genetics.py``) and the GA's
config mapping (``parallel/population.config_values_to_hypers``)
against the JAX package's, on the CPU, and ``--optimize`` through the
CLI (the twins of ``tests/functional/test_cli.py``'s optimize tests).

* ``Range``, ``fix_config``, ``enumerate_ranges`` and ``apply_values``
  over the port's config tree, as in ``tests/functional/
  test_genetics.py``;
* one fitness function through both optimizers, serial and batched:
  the same individuals in the same order, the same history and the
  same best (the GA runs on the host, from ``RandomState(0xEE07)``);
* ``config_values_to_hypers``: the JAX package's hyper pytrees for
  per-layer and global sites, and None for a site that is no hyper
  slot (then ``wine.population_evaluator`` answers None too);
* the CLI: ``--optimize`` runs the GA on Wine, takes the generic
  population path on ``yale_faces`` (printing JAX's "fused GA:
  vmapping each generation over root.yalefaces"), falls back to serial
  runs with ``--fused`` on ``approximator`` (printing the reason), and
  refuses a bad ``GENSxPOP``, an empty generation, ``--dry-run`` and
  ``--max-restarts``.
"""

import os
import subprocess
import sys

import numpy
import pytest

from znicz_tpu.core import genetics as jax_genetics
from znicz_tpu.core.config import Config as JaxConfig
from znicz_tpu.parallel import fused as jax_fused
from znicz_tpu.parallel import population as jax_population
from znicz_tpu_torch.core import genetics
from znicz_tpu_torch.core.config import Config
from znicz_tpu_torch.parallel import fused, population

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(config_cls, range_cls):
    cfg = config_cls("ga")
    cfg.update({
        "learning_rate": range_cls(0.002, 0.001, 0.5),
        "layers": [{"type": "all2all_tanh",
                    "->": {"output_sample_shape": range_cls(8, 4, 16)}},
                   {"type": "softmax", "<-": {
                       "weights_decay": range_cls(0.0, 0.0, 0.01)}}],
        "plain": 42,
    })
    return cfg


def test_range_validation_and_sampling():
    rng = genetics.Range(0.03, 0.0001, 0.9)
    assert rng.clip(5.0) == 0.9 and not rng.is_integer
    assert genetics.Range(100, 10, 500).is_integer
    assert genetics.Range(100, 10, 500).clip(77.6) == 78
    with pytest.raises(ValueError, match="outside"):
        genetics.Range(2.0, 0.0, 1.0)
    r1, r2 = numpy.random.RandomState(1), numpy.random.RandomState(1)
    assert rng.sample(r1) == jax_genetics.Range(0.03, 0.0001, 0.9).sample(r2)
    assert repr(rng) == "Range(0.03, 0.0001, 0.9)"


def test_fix_and_apply_config():
    cfg = _cfg(Config, genetics.Range)
    sites = genetics.enumerate_ranges(cfg)
    jsites = jax_genetics.enumerate_ranges(_cfg(JaxConfig,
                                                jax_genetics.Range))
    assert [k for _, k, _ in sites] == [k for _, k, _ in jsites] == [
        "learning_rate", "output_sample_shape", "weights_decay"]
    genetics.apply_values(cfg, [0.1, 12, 0.003])
    assert cfg.learning_rate == 0.1
    assert cfg.layers[0]["->"]["output_sample_shape"] == 12
    with pytest.raises(ValueError, match="values for"):
        genetics.apply_values(_cfg(Config, genetics.Range), [0.1])
    cfg = genetics.fix_config(_cfg(Config, genetics.Range))
    assert cfg.learning_rate == 0.002 and cfg.plain == 42
    assert cfg.layers[1]["<-"]["weights_decay"] == 0.0
    assert not genetics.enumerate_ranges(cfg)
    with pytest.raises(ValueError, match="no Range"):
        genetics.GeneticsOptimizer(lambda c: 0.0, cfg)


def _fitness(values):
    lr, width, wd = values
    return -(lr - 0.31) ** 2 - 0.01 * abs(width - 11) - 30.0 * wd


@pytest.mark.parametrize("batched", [False, True])
def test_same_individuals_history_and_best_as_jax(batched):
    runs = []
    for config_cls, mod in ((Config, genetics), (JaxConfig, jax_genetics)):
        cfg = _cfg(config_cls, mod.Range)
        seen = []

        def evaluate(c, cfg=cfg, seen=seen):
            values = [c.learning_rate, c.layers[0]["->"][
                "output_sample_shape"], c.layers[1]["<-"]["weights_decay"]]
            seen.append(values)
            return _fitness(values)

        def evaluate_population(vectors, seen=seen):
            seen.append([list(v) for v in vectors])
            return [_fitness(v) for v in vectors]
        opt = mod.GeneticsOptimizer(
            evaluate, cfg, population_size=6, generations=4,
            evaluate_population=evaluate_population if batched else None)
        best = opt.run()
        runs.append((seen, opt.history, best, cfg.learning_rate,
                     cfg.layers[0]["->"]["output_sample_shape"]))
    assert runs[0] == runs[1]
    seen, history, (values, fitness), lr, width = runs[0]
    assert len(history) == 4 and values == [lr, width, values[2]]
    assert fitness == max(h[0] for h in history)


def test_config_values_to_hypers_per_layer_and_global():
    layers = [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 6},
         "<-": {"learning_rate": 0.1, "learning_rate_bias": 0.2}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.3}},
    ]
    specs = tuple(fused.build_specs(layers, 4, None))
    jspecs = tuple(jax_fused.build_specs(layers, 4, None))
    for sites, values in (
            ([(layers[0]["<-"], "learning_rate", None),
              (None, "weights_decay", None)], [0.7, 0.005]),
            ([(layers[1]["<-"], "gradient_moment", None),
              (None, "learning_rate_bias", None),
              (None, "factor_ortho", None)], [0.9, 0.04, 0.001]),
            ([(None, "learning_rate", None)], [0.25])):
        got = population.config_values_to_hypers(sites, layers, specs)
        want = jax_population.config_values_to_hypers(sites, layers, jspecs)
        assert got(values, specs) == want(values, jspecs)
    hypers = population.config_values_to_hypers(
        [(layers[0]["<-"], "learning_rate", None),
         (None, "weights_decay", None)], layers, specs)([0.7, 0.005], specs)
    assert hypers[0]["w"]["lr"] == 0.7 and hypers[0]["b"]["lr"] == 0.2
    assert hypers[1]["w"]["lr"] == 0.3
    assert hypers[1]["w"]["wd"] == 0.005 and hypers[1]["b"]["wd"] == 0.0
    assert population.uniform_lr_hypers([0.5], specs) == \
        jax_population.uniform_lr_hypers([0.5], jspecs)
    for sites in ([(None, "minibatch_size", None)],
                  [(layers[0], "kx", None)]):
        assert population.config_values_to_hypers(
            sites, layers, specs) is None
    pool_layers = [{"type": "max_pooling", "kx": 2, "ky": 2,
                    "<-": {"learning_rate": 0.1}}] + layers
    pspecs = tuple(fused.build_specs(pool_layers, (4, 4, 1), None))
    assert population.config_values_to_hypers(
        [(pool_layers[0]["<-"], "learning_rate", None)], pool_layers,
        pspecs) is None


def test_population_evaluator_rejects_unknown_sites():
    from znicz_tpu_torch.samples import wine
    assert wine.population_evaluator(
        [(None, "minibatch_size", None), (None, "learning_rate", None)],
        device="cpu") is None


def _cli(tmp_path, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch"] + list(args) +
        ["--device", "cpu"], cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT, HOME=str(tmp_path),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=timeout)


def test_cli_optimize_runs_ga(tmp_path):
    script = tmp_path / "wine_ga.py"
    script.write_text("""
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.genetics import Range
import znicz_tpu_torch.samples.wine

root.wine.decision.max_epochs = 3
root.wine.snapshotter.directory = %r
root.wine.learning_rate = Range(0.3, 0.05, 0.6)
from znicz_tpu_torch.samples.wine import run  # noqa: F401,E402
""" % str(tmp_path))
    out = _cli(tmp_path, str(script), "--optimize", "2x3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "best fitness" in out.stdout
    assert "learning_rate" in out.stdout


def test_cli_optimize_generic_vmapped(tmp_path):
    script = tmp_path / "yale_ga.py"
    script.write_text("""
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.genetics import Range
import znicz_tpu_torch.samples.yale_faces

root.yalefaces.decision.max_epochs = 2
root.yalefaces.loader.minibatch_size = 20
root.yalefaces.snapshotter.directory = %r
root.yalefaces.learning_rate = Range(0.05, 0.01, 0.1)
from znicz_tpu_torch.samples.yale_faces import run  # noqa: F401,E402
""" % str(tmp_path))
    out = _cli(tmp_path, str(script), "--optimize", "2x3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fused GA: vmapping each generation over root.yalefaces" \
        in out.stdout, out.stdout[-2000:]
    assert "best fitness" in out.stdout


def test_cli_optimize_serial_fallback_trains_fused(tmp_path):
    script = tmp_path / "approx_ga.py"
    script.write_text("""
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.genetics import Range
import znicz_tpu_torch.samples.approximator

root.approximator.decision.max_epochs = 2
root.approximator.snapshotter.directory = %r
root.approximator.learning_rate = Range(0.02, 0.005, 0.05)
from znicz_tpu_torch.samples.approximator import run  # noqa: F401,E402
""" % str(tmp_path))
    out = _cli(tmp_path, str(script), "--optimize", "1x2", "--fused")
    assert out.returncode == 0, out.stderr[-2000:]
    combined = out.stdout + out.stderr
    assert "fused GA unavailable" in combined, combined[-2000:]
    assert "evaluating serially" in combined
    assert "best fitness" in out.stdout


@pytest.mark.parametrize("args,needle", [
    (["wine", "--optimize", "abc"], "GENSxPOP"),
    (["wine", "--optimize", "0x8"], "at least 1"),
    (["wine", "--optimize", "2x3", "--dry-run"], "cannot be combined"),
    (["wine", "--optimize", "2", "--max-restarts", "1"],
     "cannot be combined")])
def test_cli_optimize_validation(tmp_path, args, needle):
    out = _cli(tmp_path, *args, timeout=120)
    assert out.returncode != 0
    assert needle in out.stderr, (args, out.stderr[-500:])
