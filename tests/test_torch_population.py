"""The population path of ``--optimize`` (``parallel/population.py``): a
whole GA generation trained as one batched computation a step, against
the JAX package's vmapped ``make_population_evaluator`` and against
serial ``FusedNet`` runs, on the CPU in float64.

* Wine (the sample's topology and rows, one site on the learning rate)
  and a small conv / max-pool / LRN / FC net on synthetic rows (two
  sites at once, the learning rate and the weight decay): the
  population's fitnesses equal JAX's, and each individual's final
  parameters and velocities agree with a JAX twin of the evaluator's
  vmapped training within 1e-10 of the tensor's largest magnitude;
  ``wine.population_evaluator`` itself gives JAX's fitnesses too;
* each individual equals a serial ``FusedNet`` run from the same draw
  over the same minibatches with its hypers (taken in float32, as the
  population stacks them): the same fitness, parameters within 1e-10;
* one step of a population of 5 makes the calls a population of 2
  makes: no loop over individuals;
* a GA over two sites runs through the population evaluator alone and
  keeps the JAX run's individuals and best;
* sites that map onto no hyper slot fall back to serial, the reason
  printed.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

from test_torch_fused import _conv, _fc
from test_torch_workflow import _restored
from znicz_tpu.core import genetics as jax_genetics
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.config import Config as JaxConfig
from znicz_tpu.parallel import fused as jax_fused
from znicz_tpu.parallel import population as jax_population
from znicz_tpu.samples import wine as jax_wine
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import genetics, prng
from znicz_tpu_torch.core.config import Config, root
from znicz_tpu_torch.parallel import fused, population
from znicz_tpu_torch.samples import wine

RTOL = 1e-10
SEED = 12


def _conv_layers():
    pool = {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                         "sliding": (2, 2)}}
    lrn = {"type": "norm", "n": 3, "alpha": 0.0001, "beta": 0.75, "k": 1}
    conv = _conv("conv_str", 6, 3, 1, 1, 0.1,
                 {"learning_rate": 0.02, "weights_decay": 0.0005,
                  "gradient_moment": 0.9, "factor_ortho": 0.001})
    # the LRN's input (6, 6, 6) would hide a channel axis taken for
    # another: one LRN sits where height, width and channels differ
    return [conv, lrn, pool, lrn, _conv("conv_tanh", 5, 3, 0, 1, 0.1), pool,
            _fc("softmax", 4, 0)]


def _conv_data():
    r = numpy.random.RandomState(2)
    x = r.uniform(-1, 1, (48, 13, 13, 3))
    y = r.randint(0, 4, 48).astype(numpy.int32)
    return x[:36], y[:36], x[36:], y[36:]


def _wine_case():
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
              {"type": "softmax", "->": {"output_sample_shape": 3}}]
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.loader.loader_wine import WineLoader
    loader = WineLoader(Workflow(None), minibatch_size=10)
    loader.initialize()
    x = numpy.array(loader.original_data.mem)
    y = numpy.array(loader.original_labels, dtype=numpy.int32)
    return layers, 13, (x, y, x, y), {"wd": 0.0, "lr": 0.3}, 10


def _conv_case():
    return _conv_layers(), (13, 13, 3), _conv_data(), None, 6


#: a config node that is none of the layers': its sites are global
GLOBAL = {}


def _sites(layers, two):
    if not two:
        return [(GLOBAL, "learning_rate", None)]
    return [(GLOBAL, "learning_rate", None), (GLOBAL, "weights_decay", None)]


def _jax_train(layers, shape, data, defaults, mb, mapper, vectors, epochs):
    """The JAX evaluator's vmapped training (``population.py:42-85``),
    returning the final parameters and optimizer state."""
    specs = tuple(jax_fused.build_specs(layers, shape, defaults))
    params0 = jax_fused.init_params(
        specs, jax_prng.RandomGenerator().seed(SEED), numpy.float64)
    state0 = jax_fused.init_opt_state(specs, params0)
    train_x = numpy.asarray(data[0], numpy.float64)
    train_y = numpy.asarray(data[1], numpy.int32)
    perm = numpy.random.RandomState(0x5EED).permutation(len(train_x))
    train_x, train_y = train_x[perm], train_y[perm]
    steps = max(1, len(train_x) // mb)
    xs = jnp.asarray(train_x[:steps * mb].reshape(
        (steps, mb) + train_x.shape[1:]))
    ys = jnp.asarray(train_y[:steps * mb].reshape(steps, mb))

    def train(hypers):
        def epoch(carry, _):
            def step(carry, batch):
                p, s = carry
                p, s, m = jax_fused._train_step(p, s, batch[0], batch[1],
                                                specs, hypers=hypers)
                return (p, s), m["loss"]
            return jax.lax.scan(step, carry, (xs, ys))[0], None
        return jax.lax.scan(epoch, (params0, state0), None,
                            length=epochs)[0]
    hypers = [mapper(list(v), specs) for v in vectors]
    stacked = jax.tree.map(lambda *leaves: jnp.stack(
        [jnp.asarray(v, jnp.float32) for v in leaves]), *hypers)
    return jax.jit(jax.vmap(train))(stacked)


def _evaluators(case, two, epochs):
    layers, shape, data, defaults, mb = case
    specs = tuple(fused.build_specs(layers, shape, defaults))
    jspecs = tuple(jax_fused.build_specs(layers, shape, defaults))
    sites = _sites(layers, two)
    mapper = population.config_values_to_hypers(sites, layers, specs)
    jmapper = jax_population.config_values_to_hypers(sites, layers, jspecs)
    port = population.make_population_evaluator(
        layers, shape, *data, mapper, epochs=epochs, minibatch_size=mb,
        rand=prng.RandomGenerator().seed(SEED), dtype=numpy.float64,
        defaults=defaults, device="cpu")
    jax_ev = jax_population.make_population_evaluator(
        layers, shape, *data, jmapper, epochs=epochs, minibatch_size=mb,
        rand=jax_prng.RandomGenerator().seed(SEED), dtype=numpy.float64,
        defaults=defaults)
    return port, jax_ev, mapper, jmapper


def _close(got, want):
    want = numpy.asarray(want)
    assert got.shape == want.shape
    assert numpy.abs(got - want).max() <= RTOL * numpy.abs(want).max()


@pytest.mark.parametrize("case,two,vectors", [
    ("wine", False, [[0.3], [0.05], [0.6], [0.17]]),
    ("conv", True, [[0.02, 0.0005], [0.1, 0.0], [0.05, 0.004]])])
def test_population_matches_jax_f64(case, two, vectors):
    case = {"wine": _wine_case, "conv": _conv_case}[case]()
    port, jax_ev, mapper, jmapper = _evaluators(case, two, 3)
    assert port(vectors) == jax_ev(vectors)
    params = port.train([mapper(v, port.specs) for v in vectors])
    jparams, _ = _jax_train(*case, jmapper, vectors, 3)
    for p, jp in zip(params, jparams):
        for k in p:
            _close(p[k].numpy(), jp[k])


def test_wine_population_evaluator_gives_jax_fitnesses():
    with _restored(root.wine):
        sites = [(None, "learning_rate", None),
                 (None, "weights_decay", None)]
        got = wine.population_evaluator(sites, epochs=6, device="cpu")
        want = jax_wine.population_evaluator(sites, epochs=6)
        vectors = [[0.3, 0.0], [0.05, 0.001], [0.6, 0.0003]]
        assert got(vectors) == want(vectors)


def _serial(case, hypers, epochs):
    """A serial FusedNet run of one individual over the evaluator's
    minibatches: ``(fitness, params)``."""
    layers, shape, data, defaults, mb = case
    net = fused.FusedNet(layers, shape, rand=prng.RandomGenerator().seed(
        SEED), dtype=numpy.float64, defaults=defaults, device="cpu")
    x, y = numpy.asarray(data[0]), numpy.asarray(data[1], numpy.int32)
    perm = numpy.random.RandomState(0x5EED).permutation(len(x))
    x, y = x[perm], y[perm]
    f32 = fused.tree_map(lambda v: float(numpy.float32(v)), hypers)
    for _ in range(epochs):
        for s in range(len(x) // mb):
            net.step(x[s * mb:(s + 1) * mb], y[s * mb:(s + 1) * mb],
                     hypers=f32)
    _, idx = net.predict_with_idx(data[2])
    n_err = int((idx.numpy() != data[3]).sum())
    fitness = float(numpy.float32(n_err) * (numpy.float32(-100.0) * (
        numpy.float32(1.0) / numpy.float32(len(data[3])))))
    return fitness, net.params


def test_population_equals_serial_fused_runs():
    case = _conv_case()
    vectors = [[0.02, 0.0005], [0.07, 0.002], [0.0, 0.0]]
    port, _, mapper, _ = _evaluators(case, True, 2)
    hypers = [mapper(v, port.specs) for v in vectors]
    fitnesses = port(vectors)
    params = port.train(hypers)
    for i, hy in enumerate(hypers):
        fitness, serial = _serial(case, hy, 2)
        assert fitness == fitnesses[i]
        for p, sp in zip(params, serial):
            for k in p:
                _close(p[k][i].numpy(), sp[k].numpy())


def test_one_computation_a_step_for_the_whole_generation(monkeypatch):
    port, _, mapper, _ = _evaluators(_conv_case(), True, 1)
    calls = {}

    def counted(name, real):
        def fn(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)
        return fn
    for mod, name in ((population.F, "conv2d"), (population.torch, "matmul"),
                      (population.pool_ops, "pooling_reduce_window"),
                      (population.gd_math, "update")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    counts = []
    for n in (2, 5):
        calls.clear()
        port.train([mapper([0.01 * (i + 1), 0.0], port.specs)
                    for i in range(n)])
        counts.append(dict(calls))
    assert counts[0] == counts[1]
    assert counts[0]["conv2d"] == 2 * 6   # two convs, 6 steps an epoch


def test_ga_over_two_sites_through_the_population_alone():
    case = _conv_case()
    port, jax_ev, _, _ = _evaluators(case, True, 1)
    runs = []
    for mod, config_cls, ev in ((genetics, Config, port),
                                (jax_genetics, JaxConfig, jax_ev)):
        cfg = config_cls("ga2")
        cfg.update({"learning_rate": mod.Range(0.02, 0.001, 0.2),
                    "weights_decay": mod.Range(0.0, 0.0, 0.01)})
        opt = mod.GeneticsOptimizer(
            lambda c: pytest.fail("the serial evaluate ran"), cfg,
            population_size=4, generations=2, evaluate_population=ev)
        best = opt.run()
        runs.append((best, opt.history))
    assert runs[0] == runs[1]
    assert len(runs[0][0][0]) == 2


def test_unmappable_sites_fall_back_to_serial(capsys):
    import znicz_tpu_torch.samples.yale_faces  # noqa: F401
    with _restored(root.yalefaces, root.yalefaces.loader):
        root.yalefaces.loader.minibatch_size = 20
        root.yalefaces.layers[0]["->"]["output_sample_shape"] = \
            genetics.Range(100, 50, 200)
        sites = genetics.enumerate_ranges(root.yalefaces)
        assert cli._generic_population_evaluator(sites, "cpu") is None
        out = capsys.readouterr().out
        assert "fused GA unavailable: a Range site does not map onto " \
            "fused hyper slots; evaluating serially" in out
        root.yalefaces.layers[0]["->"]["output_sample_shape"] = 100
        root.yalefaces.learning_rate = genetics.Range(0.05, 0.01, 0.1)
        other = Config("elsewhere")
        other.update({"lr": genetics.Range(0.1, 0.0, 1.0)})
        assert cli._generic_population_evaluator(
            genetics.enumerate_ranges(root.yalefaces) +
            genetics.enumerate_ranges(other), "cpu") is None
        assert "no single sample namespace holds all Range sites" in \
            capsys.readouterr().out
