"""Ring attention over gloo gangs against the JAX package's.

The cases of ``tests/unit/test_sequence_parallel.py`` on 8 ranks and on
a 4x2 mesh (the ring along its data axis, the model axis idle), each
held against JAX's ``ring_attention`` on the conftest's 8 virtual
devices: causal and full, the long causal sequence whose first
positions attend to tiny prefixes, the divisibility and shape errors,
and the gradient through the ring, in float64 within 1e-10 of
``jax.grad`` of JAX's ring.  One gang of 8 ranks runs every case
(``torch_gang.ring_cases``); with one rank the ring is a local loop
that runs no collective.
"""

import numpy
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_gang
from znicz_tpu.parallel import make_mesh as jax_make_mesh
from znicz_tpu.parallel.sequence import ring_attention as jax_ring
from znicz_tpu_torch import testing
from znicz_tpu_torch.parallel.mesh import make_mesh
from znicz_tpu_torch.parallel.sequence import (attention_reference,
                                               ring_attention)

#: float32 forward agreement, JAX's own pin against its reference
F32_TOL = 2e-5
#: float64 gradient agreement with jax.grad of JAX's ring
F64_TOL = 1e-10
MESHES = {"8": 1, "4x2": 2}


def _qkv(b=2, t=32, h=4, d=16, seed=0, dtype=numpy.float32):
    r = numpy.random.RandomState(seed)
    return tuple(r.uniform(-1, 1, (b, t, h, d)).astype(dtype)
                 for _ in range(3))


def _cases():
    """(name, model_parallel, q, k, v, causal, grad) of every case."""
    cases = []
    for mesh, mp in MESHES.items():
        for causal in (False, True):
            cases.append(("match-%s-%s" % (mesh, causal), mp) + _qkv() +
                         (causal, False))
        cases.append(("2d-%s" % mesh, mp) + _qkv(t=16, seed=3) +
                     (False, False))
        cases.append(("div-%s" % mesh, mp) + _qkv(t=30) + (False, False))
        cases.append(("long-%s" % mesh, mp) +
                     _qkv(b=1, t=256, h=2, d=8, seed=7) + (True, False))
        q, k, v = _qkv(t=16, seed=9)
        cases.append(("shape-%s" % mesh, mp, q, k[:, :8], v, False, False))
        cases.append(("grad-%s" % mesh, mp) +
                     _qkv(b=1, t=16, h=2, d=8, seed=4,
                          dtype=numpy.float64) + (True, True))
    return cases


@pytest.fixture(scope="module")
def gang():
    """Every case's result on each of 8 ranks."""
    return testing.run_gang(torch_gang.ring_cases, 8, args=(_cases(),),
                            timeout_s=240)


def _case(name):
    return next(c for c in _cases() if c[0] == name)


def _jax_ring(mesh, q, k, v, causal):
    return numpy.asarray(jax_ring(q, k, v, jax_make_mesh(
        8, model_parallel=MESHES[mesh]), axis="data", causal=causal))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(gang, mesh, causal):
    """Every rank returns the global result, equal to JAX's ring and to
    the port's single-device attention."""
    _, _, q, k, v, _, _ = _case("match-%s-%s" % (mesh, causal))
    want = _jax_ring(mesh, q, k, v, causal)
    ref = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    assert numpy.abs(ref - want).max() < F32_TOL
    for out in gang:
        got = out["match-%s-%s" % (mesh, causal)]
        assert got.shape == q.shape
        assert numpy.abs(got - want).max() < F32_TOL


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_on_2d_mesh_data_axis(gang, mesh):
    """The ring along the data axis of an 8 or a (4, 2) mesh."""
    _, _, q, k, v, _, _ = _case("2d-%s" % mesh)
    want = _jax_ring(mesh, q, k, v, False)
    for out in gang:
        assert numpy.abs(out["2d-%s" % mesh] - want).max() < F32_TOL


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_validates_divisibility(gang, mesh):
    _, mp, q, k, v, _, _ = _case("div-%s" % mesh)
    with pytest.raises(ValueError) as jax_err:
        jax_ring(q, k, v, jax_make_mesh(8, model_parallel=mp))
    for out in gang:
        assert out["div-%s" % mesh] == str(jax_err.value)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_long_context_stability(gang, mesh):
    _, _, q, k, v, _, _ = _case("long-%s" % mesh)
    want = _jax_ring(mesh, q, k, v, True)
    for out in gang:
        got = out["long-%s" % mesh]
        assert numpy.isfinite(got).all()
        assert numpy.abs(got - want).max() < F32_TOL


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_validates_shapes(gang, mesh):
    """Cross-attention shapes raise JAX's error (JAX's compile-cache
    half of this case has no counterpart: nothing is compiled)."""
    _, mp, q, k, v, _, _ = _case("shape-%s" % mesh)
    with pytest.raises(ValueError) as jax_err:
        jax_ring(q, k, v, jax_make_mesh(8, model_parallel=mp))
    for out in gang:
        assert out["shape-%s" % mesh] == str(jax_err.value)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_attention_differentiates(gang, mesh):
    """The gradient through the ring (the rotation's backward is the
    reverse rotation) equals jax.grad of JAX's ring in float64, on
    every rank."""
    _, mp, q, k, v, _, _ = _case("grad-%s" % mesh)
    jmesh = jax_make_mesh(8, model_parallel=mp)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jax_ring(q, k, v, jmesh, axis="data", causal=True) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for out in gang:
        for got, w in zip(out["grad-%s" % mesh], want):
            assert got.dtype == numpy.float64
            assert numpy.abs(got - numpy.asarray(w)).max() < F64_TOL


def test_ring_collectives_are_counted(gang):
    """A ring of n ranks rotates n - 1 times (one send/recv for K and V
    each time) and the reverse in its backward; the split and gather
    are all-gathers."""
    for out in gang:
        assert out["counts"][1]["send_recv"] > 0
        assert out["counts"][2]["all_gather"] > 0


def test_one_rank_ring_is_local_and_runs_no_collective():
    """A one-rank mesh (no ``torch.distributed`` world): the rotation is
    the identity, the result is the attention's, and no collective
    runs."""
    mesh = make_mesh(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=16, seed=5,
                                                 dtype=numpy.float64))
    for causal in (False, True):
        got = ring_attention(q, k, v, mesh, causal=causal)
        want = attention_reference(q, k, v, causal=causal)
        assert float((got - want).abs().max()) < F64_TOL
    assert not mesh.counts
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_attention(*_qkv(t=16), mesh)
