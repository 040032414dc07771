"""The port's data normalizers (``znicz_tpu_torch.core.normalization``)
against the JAX package's (``znicz_tpu.core.normalization``), on the
CPU.

* Each of the six registered normalizers — "none", "pointwise",
  "linear", "range_linear", "internal_mean" and "mean_disp" — fit on
  the same seeded rows (a feature that never varies included) in
  float32 and float64: the fitted state, ``normalize``'s output and
  ``denormalize``'s output equal the JAX module's bit for bit.
* "linear" and "range_linear" over a given interval, and "mean_disp"
  from a given mean and reciprocal dispersion (the state it then keeps
  instead of fitting), likewise.
* An unknown name raises ``KeyError`` naming the known ones.
"""

import numpy
import pytest

from znicz_tpu.core import normalization as jax_norm
from znicz_tpu_torch.core import normalization

NAMES = ("none", "pointwise", "linear", "range_linear", "internal_mean",
         "mean_disp")
DTYPES = (numpy.float32, numpy.float64)


def _rows(dtype, n=37, features=23):
    rng = numpy.random.RandomState(20260730)
    data = rng.uniform(-40.0, 255.0, (n, features)).astype(dtype)
    data[:, 5] = 7.0     # a constant feature: a zero span and range
    return data


def _bits(a):
    a = numpy.asarray(a)
    return a.view(numpy.uint8) if a.dtype.kind == "f" else a


def _assert_same_bits(got, want):
    got, want = numpy.asarray(got), numpy.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert numpy.array_equal(_bits(got), _bits(want))


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], numpy.ndarray):
            _assert_same_bits(got[key], want[key])
        else:
            assert type(got[key]) is type(want[key])
            assert got[key] == want[key]


def _fit_apply(module, name, data, **kwargs):
    """Fit on the first rows (the "training set"), normalize all the
    rows, then denormalize them; returns (state, normalized,
    denormalized)."""
    norm = module.create(name, **kwargs)
    assert norm.NAME == name
    norm.analyze(data[:29].copy())
    normalized = norm.normalize(data.copy())
    denormalized = norm.denormalize(normalized.copy())
    return norm.state, normalized, denormalized


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", NAMES)
def test_normalizer_matches_jax(name, dtype):
    data = _rows(dtype)
    got = _fit_apply(normalization, name, data)
    want = _fit_apply(jax_norm, name, data)
    _assert_same_state(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _assert_same_bits(g, w)
    if name != "none":
        assert not numpy.array_equal(got[1], data)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,kwargs", [
    ("linear", {"interval": (0, 1)}),
    ("range_linear", {"interval": (-0.5, 2.0)}),
    ("mean_disp", "given")])
def test_normalizer_options_match_jax(name, kwargs, dtype):
    data = _rows(dtype)
    if kwargs == "given":
        rng = numpy.random.RandomState(7)
        kwargs = {"mean": rng.uniform(0, 100, data.shape[1]).astype(dtype),
                  "rdisp": rng.uniform(0.01, 1, data.shape[1]).astype(dtype)}
    got = _fit_apply(normalization, name, data, **kwargs)
    want = _fit_apply(jax_norm, name, data, **kwargs)
    _assert_same_state(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _assert_same_bits(g, w)
    if "mean" in kwargs:
        _assert_same_bits(got[0]["mean"], kwargs["mean"])


def test_unknown_normalizer_raises():
    with pytest.raises(KeyError, match="internal_mean"):
        normalization.create("external_mean")
