"""The wine and approximator workflows of
``tests/functional/test_mesh_training.py`` trained data-parallel over a
gloo gang of 4 ranks, and JAX's kill-and-resume pin on a mesh of 2.

Every rank runs the workflow on the same loader stream; the fused
trainer's net trains on its rows of each minibatch (wine at minibatch
16, 4 rows a rank) and the segment's readback folds the ranks' window
partials in one all-reduce.  Against the port's single-device run:

* integer aggregates (n_err, confusion) and ``max_err_sum`` exact;
* float32 parameters within JAX's pin ``MESH_PARAM_TOL`` (1e-5) and
  the MSE metrics within ``MESH_MSE_RTOL`` (1e-6).  JAX's own async
  pins fail in the recorded runs of the JAX tests (ROADMAP.md, queue
  3): the port's float32 wine run holds them, its MSE run holds the
  sum and the max but reads the min 1.35e-7 apart, so the same async
  runs are held in float64 within 1e-10 of the single-device runs as
  well;
* async equals sync windows and host-stacked windows equal the device
  path on the mesh, bit for bit;
* one readback a segment: ``transfer.d2h_calls`` and
  ``trainer.readbacks`` per epoch equal the segments, the summary
  carries the mesh's extents, and ``telemetry.merged_snapshot`` sums
  the ranks' counters;
* ``mesh=None`` keeps the single-device accumulator layout.
"""

import os

import numpy
import pytest

import torch_gang
from znicz_tpu_torch import testing

MESH_MSE_RTOL = 1e-6
MESH_PARAM_TOL = 1e-5
F64_TOL = 1e-10

RUNS = [
    ("async", "wine", {"window": 4, "mesh": 4}, None),
    ("sync", "wine", {"window": 4, "mesh": 4, "async_windows": False},
     None),
    ("stacked", "wine", {"window": 4, "mesh": 4, "device_data": False},
     None),
    ("async64", "wine", {"window": 4, "mesh": 4}, "float64"),
    ("telemetry", "telemetry", {"window": 4, "mesh": 4}, None),
    ("mse", "approximator", {"window": 4, "mesh": 4}, None),
    ("mse_stacked", "approximator",
     {"window": 4, "mesh": 4, "device_data": False}, None),
    ("mse64", "approximator", {"window": 4, "mesh": 4}, "float64"),
    ("hybrid", "wine", {"window": 4, "mesh": "hybrid"}, None),
]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every run of ``RUNS`` on each of 4 ranks, and the single-device
    runs they are held against (in this process)."""
    d = str(tmp_path_factory.mktemp("mesh_training"))
    ranks = testing.run_gang(torch_gang.mesh_workflows, 4, args=(d, RUNS),
                             timeout_s=300)
    single = {
        "async": torch_gang.facts(torch_gang.wine({"window": 4}, d, "s1")),
        "async64": torch_gang.facts(torch_gang.wine(
            {"window": 4}, d, "s64", dtype="float64")),
        "mse": torch_gang.facts(torch_gang.approximator({"window": 4}, d,
                                                        "smse")),
        "mse64": torch_gang.facts(torch_gang.approximator(
            {"window": 4}, d, "smse64", dtype="float64")),
    }
    return ranks, single


def _aggregates_equal(a, b):
    assert a["n_err"] == b["n_err"]
    for ca, cb in zip(a["confusion"], b["confusion"]):
        if ca is None or cb is None:
            assert ca is None and cb is None
            continue
        numpy.testing.assert_array_equal(ca, cb)
    # a max is reduction-order independent: exact across the fold
    assert a["max_err"] == b["max_err"], (a["max_err"], b["max_err"])


def _params_close(a, b, tol, relative=False):
    for i, (la, lb) in enumerate(zip(a["params"], b["params"])):
        assert set(la) == set(lb)
        for k in la:
            scale = float(numpy.abs(lb[k]).max()) if relative else 1.0
            diff = numpy.abs(la[k] - lb[k]).max()
            assert diff <= tol * scale, "layer %d %s diff %g" % (i, k, diff)


def _params_equal(a, b):
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            numpy.testing.assert_array_equal(la[k], lb[k])


def test_mesh_async_equals_single_device(gang):
    """4-way data mesh against one device, async windows: integer
    aggregates and max_err_sum exact; float32 parameters within JAX's
    pin (the gradient all-reduce reassociates the batch sum)."""
    ranks, single = gang
    for out in ranks:
        got = out["async"]
        assert got["data_shards"] == 4 and got["device_data"]
        _aggregates_equal(got, single["async"])
        _params_close(got, single["async"], MESH_PARAM_TOL)


def test_mesh_async_equals_single_device_in_float64(gang):
    """The same run in float64: parameters within 1e-10 of the single
    device's, aggregates exact."""
    ranks, single = gang
    for out in ranks:
        got = out["async64"]
        assert got["params"][0]["w"].dtype == numpy.float64
        _aggregates_equal(got, single["async64"])
        _params_close(got, single["async64"], F64_TOL, relative=True)


def test_mesh_async_equals_mesh_sync(gang):
    """On the same mesh, async (the fold at the segment's readback)
    equals sync (a fold at every window) bit for bit."""
    for out in gang[0]:
        _aggregates_equal(out["async"], out["sync"])
        _params_equal(out["async"], out["sync"])


def test_mesh_host_stacked_equals_device_path(gang):
    for out in gang[0]:
        assert not out["stacked"]["device_data"]
        _aggregates_equal(out["stacked"], out["async"])
        _params_equal(out["stacked"], out["async"])


def test_hybrid_mesh_is_the_world_s_mesh_on_one_host(gang):
    """``fused={"mesh": "hybrid"}`` (``multihost.make_hybrid_mesh``):
    on one host the mesh over the whole world, the same run as
    ``mesh=4``."""
    for out in gang[0]:
        assert out["hybrid"]["data_shards"] == 4
        _aggregates_equal(out["hybrid"], out["async"])
        _params_equal(out["hybrid"], out["async"])


def test_ranks_agree(gang):
    """Every rank ends with the same parameters and aggregates."""
    ranks = gang[0]
    for out in ranks[1:]:
        for name in ("async", "mse"):
            _params_equal(out[name], ranks[0][name])


def test_mesh_zero_mid_epoch_d2h(gang):
    """One readback a segment under the mesh (wine has no VALID split:
    one TRAIN segment an epoch), the summary's extents, and the merged
    view over the 4 ranks."""
    for out in gang[0]:
        got = out["telemetry"]
        d2h, readbacks = zip(*got["at_epoch"])
        assert readbacks == (1, 2, 3), readbacks
        assert d2h == (1, 2, 3), d2h
        assert got["summary"] == {"data_shards": 4, "model_shards": 1}
        assert got["hosts"] == 4
        assert got["readbacks"] == 4 * 3


def _metrics_close(got, want, rtol):
    for ma, mb in zip(got["metrics"], want["metrics"]):
        if ma is None or mb is None:
            assert ma is None and mb is None
            continue
        for a, b in zip(ma, mb):
            assert abs(a - b) <= rtol * abs(b), (ma, mb)


def test_mesh_mse_async_equals_single_device(gang):
    """MSE (approximator, sliced device path) on the mesh.  JAX's pin
    (the max and min metrics exact) fails in the recorded runs of the
    JAX test; in float32 the port reads the sum within the
    reassociation pin and the max exact, but the min 1.35e-7 apart
    relative (0.027590585872530937 against 0.027590589597821236): the
    minimum is taken over outputs of parameters that drifted within
    their pin.  So the float32 metrics are held within
    ``MESH_MSE_RTOL`` and the parameters within JAX's pin, and the same
    run in float64 holds every metric and parameter within 1e-10."""
    ranks, single = gang
    for out in ranks:
        got = out["mse"]
        assert got["data_shards"] == 4 and got["sliced"] is False
        _metrics_close(got, single["mse"], MESH_MSE_RTOL)
        _params_close(got, single["mse"], MESH_PARAM_TOL)
        _metrics_close(out["mse64"], single["mse64"], F64_TOL)
        _params_close(out["mse64"], single["mse64"], F64_TOL, relative=True)


def test_mesh_mse_host_stacked_matches_device_path(gang):
    for out in gang[0]:
        assert not out["mse_stacked"]["device_data"]
        assert out["mse_stacked"]["metrics"] == out["mse"]["metrics"]
        _params_equal(out["mse_stacked"], out["mse"])


def test_mesh_none_keeps_the_single_device_layout(gang):
    """Without a mesh the net has one shard and the accumulator the
    single-device shapes, which the mesh run's match too: the fold
    leaves no shard axis."""
    ranks, single = gang
    assert single["async"]["data_shards"] == 1
    assert ranks[0]["async"]["acc_shapes"] == single["async"]["acc_shapes"]


def test_kill_resume_equivalence_mesh2(tmp_path):
    """JAX's pin over a mesh of 2 (wine at minibatch 10: 18 TRAIN
    minibatches in windows of 4 are 5 dispatches an epoch): a crash at
    the 8th fused dispatch, epoch 2's third window, and the supervised
    restart resuming from the mid-epoch snapshot rank 0 wrote after its
    second, ends bit-equal to the uninterrupted mesh run, on both
    ranks."""
    ref, chaos = str(tmp_path / "ref"), str(tmp_path / "chaos")
    os.makedirs(ref)
    os.makedirs(chaos)
    out = testing.run_gang(torch_gang.kill_and_resume, 2,
                           args=(ref, chaos, {"window": 4, "mesh": 2}),
                           timeout_s=300)
    for got in out:
        assert got["injected"] == 1
        assert got["restored"] == ["midepoch"]
        _aggregates_equal(got["chaos"], got["ref"])
        _params_equal(got["chaos"], got["ref"])
        # one writer: every file is rank 0's
        pids = {f.rsplit(".", 2)[-2] for f in got["files"]
                if f.endswith(".pickle")}
        assert len(pids) == 1, got["files"]
