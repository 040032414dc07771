"""``research.long_context`` over gloo gangs against the JAX package's.

20 float64 steps of ``run_sample`` on 4 ranks (the sequence axis split
four ways) hold every parameter within 1e-10 of the same 20 steps of
JAX's sample (its ``make_batch``, ``loss_fn`` and ``jax.grad`` through
its ring) on its 4-device mesh, from the same draws; the published
800-step run on 4 ranks in float32 retrieves the needle above JAX's
0.95 pin (``tests/functional/test_research_models.py``).
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_gang
from znicz_tpu.parallel import make_mesh as jax_make_mesh
from znicz_tpu.samples.research import long_context as jax_lc
from znicz_tpu_torch import launcher, testing
from znicz_tpu_torch.samples.research import long_context as lc

F64_TOL = 1e-10
STEPS = 20


def _jax_steps(steps, seed=0x10C):
    """JAX's training loop (``run_sample``'s) in float64 on its 4-device
    mesh: its sample's init draws cast to float32, so the float64
    parameters come from the same draws through the port's numpy
    ``init_params``."""
    cfg = jax_lc.root.long_context
    rand = numpy.random.RandomState(seed)
    params = {k: jnp.asarray(v, jnp.float64) for k, v in
              lc.init_params(rand, cfg.vocab, cfg.embed, cfg.heads).items()}
    mesh = jax_make_mesh(4, model_parallel=1)
    grad = jax.jit(jax.grad(
        lambda p, x, y: jax_lc.loss_fn(p, x, y, mesh, cfg.heads)))
    for _ in range(steps):
        x, y = jax_lc.make_batch(rand, cfg.batch, cfg.seq_len, cfg.vocab)
        g = grad(params, x, y)
        params = jax.tree.map(lambda p, gg: p - cfg.learning_rate * gg,
                              params, g)
    return {k: numpy.asarray(v) for k, v in params.items()}


def test_config_and_draws_are_jax_s():
    """The published config, and the batches and initial parameters of
    JAX's sample from one RandomState."""
    assert dict(lc.root.long_context.as_dict()) == \
        dict(jax_lc.root.long_context.as_dict())
    ra, rb = numpy.random.RandomState(5), numpy.random.RandomState(5)
    pa = lc.init_params(ra, 16, 32, 2)
    pb = jax_lc.init_params(rb, 16, 32, 2)
    for k in lc.PARAM_NAMES:
        numpy.testing.assert_array_equal(pa[k].astype(numpy.float32),
                                         numpy.asarray(pb[k]))
    for a, b in zip(lc.make_batch(ra, 32, 64, 16),
                    jax_lc.make_batch(rb, 32, 64, 16)):
        numpy.testing.assert_array_equal(a, b)


def test_twenty_f64_steps_on_four_ranks_equal_jax():
    out = testing.run_gang(torch_gang.long_context, 4,
                           args=(STEPS, "float64"), timeout_s=240)
    want = _jax_steps(STEPS)
    for _, params in out:
        for k in lc.PARAM_NAMES:
            assert params[k].dtype == numpy.float64
            scale = float(numpy.abs(want[k]).max()) or 1.0
            assert numpy.abs(params[k] - want[k]).max() <= F64_TOL * scale, k


def test_one_rank_steps_equal_the_four_rank_ring():
    """The same 20 float64 steps in one process (a one-rank mesh, no
    collective) land on JAX's parameters too."""
    _, params, mesh = lc.run_sample(steps=STEPS, device="cpu",
                                    dtype=torch.float64)
    want = _jax_steps(STEPS)
    for k in lc.PARAM_NAMES:
        got = params[k].numpy()
        scale = float(numpy.abs(want[k]).max()) or 1.0
        assert numpy.abs(got - want[k]).max() <= F64_TOL * scale, k
    assert not mesh.counts


def test_published_run_on_four_ranks_retrieves_the_needle():
    """800 float32 steps on 4 ranks: every rank evaluates the same
    parameters to the same accuracy, above JAX's 0.95 pin."""
    out = testing.run_gang(torch_gang.long_context, 4,
                           args=(None, "float32"), timeout_s=600)
    accs = [acc for acc, _ in out]
    assert len(set(accs)) == 1, accs
    assert accs[0] > 0.95, accs


def test_the_launcher_runs_it_on_its_device(capsys, monkeypatch):
    """``python -m znicz_tpu_torch research.long_context --device cpu``
    trains on the CPU (a short run here) and prints the accuracy; it is
    among the 22 samples."""
    assert "research.long_context" in launcher.list_samples()
    monkeypatch.setitem(lc.root.long_context.__dict__, "steps", 2)
    launcher.run_workflow("research.long_context", device="cpu")
    assert "needle-retrieval accuracy:" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        launcher.run_workflow("research.long_context")
