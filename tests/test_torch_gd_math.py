"""The port's update algebra (znicz_tpu_torch.ops.gd_math) against the
JAX package's ``gd_math.update`` / ``init_state`` in float64, for every
combination of the flags and solvers, rtol 1e-12: the same elementwise
operations in the same order, so only a fused multiply-add on either
side could part them."""

import itertools

import jax.numpy as jnp
import numpy
import pytest
import torch

from znicz_tpu.ops import gd_math as jax_gd
from znicz_tpu_torch.ops import gd_math

HYPER = dict(lr=0.03, wd=0.0005, l1_vs_l2=0.25, moment=0.9, acc_alpha=0.4,
             acc_beta=0.7, gd_alpha=0.2, gd_beta=0.9, factor_ortho=0.001,
             adagrad_eps=1e-6, adadelta_eps=1e-7, adadelta_adom=0.35,
             fast_lr=0.05)
SOLVERS = [(), ("adagrad",), ("adadelta",), ("fast",)]
FLAGS = [dict(accumulate=acc, variant_moment=vm, ortho=ortho,
              solvers=frozenset(sol), apply=apply)
         for acc, vm, ortho, sol, apply in itertools.product(
             (False, True), (True, False), (False, True), SOLVERS,
             (True, False))]


def _ids(flags):
    return "-".join("%s=%s" % (k, "+".join(sorted(v)) if isinstance(
        v, frozenset) else int(v)) for k, v in sorted(flags.items()))


def _state(flags, shape, r):
    """Non-zero optimizer slots (positive where a solver takes a root)."""
    st = jax_gd.init_state(numpy.zeros(shape), dict(flags, need_vel=True))
    return {k: r.uniform(0.01, 1, shape) if k in (
        "adagrad", "adadelta_v", "adadelta_gv") else r.uniform(-1, 1, shape)
        for k in st}


@pytest.mark.parametrize("flags", FLAGS, ids=_ids)
def test_update_matches_jax(flags):
    r = numpy.random.RandomState(7)
    w = r.uniform(-1, 1, (5, 6))
    w[0, 0] = 0.0  # sign(0) in the l1 term
    grad = r.uniform(-1, 1, (5, 6))
    state = _state(flags, w.shape, r)
    want_w, want_st, want_g = jax_gd.update(jnp, w, grad, state, HYPER,
                                            flags)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    got_w, got_st, got_g = gd_math.update(
        torch.from_numpy(w), torch.from_numpy(grad), tstate, HYPER, flags)
    assert sorted(got_st) == sorted(want_st)
    for got, want in [(got_w, want_w), (got_g, want_g)] + [
            (got_st[k], want_st[k]) for k in want_st]:
        assert got.dtype == torch.float64
        numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                      rtol=1e-12, atol=0)
    # the inputs are not written
    assert all(torch.equal(tstate[k], torch.from_numpy(v))
               for k, v in state.items())


@pytest.mark.parametrize("flags", FLAGS[::2] + [dict(need_vel=False)],
                         ids=_ids)
def test_init_state_matches_jax(flags):
    w = numpy.ones((3, 4))
    want = jax_gd.init_state(w, flags)
    got = gd_math.init_state(torch.from_numpy(w), flags)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and not got[k].any()
        assert got[k].dtype == torch.float64
