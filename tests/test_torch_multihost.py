"""``parallel.multihost`` of the port against the JAX package's
(``tests/unit/test_multihost.py``, ``tests/unit/test_telemetry.py``'s
merge), in one process and over a gloo gang of 2 ranks.

* ``initialize`` is a no-op in a single process, idempotent in a world,
  brings a world up from a managed cluster's markers, and an explicit
  torchrun configuration whose ``init_process_group`` fails is fatal to
  the launcher (an autodetected one degrades with a warning);
* ``host_shard``'s math and errors, by default over the world's ranks;
* ``global_batch`` assembles the ranks' rows into the global batch that
  feeds a ``FusedNet`` step, equal to the single-device step;
* ``merge_telemetry_snapshots``' math, ``aggregate_telemetry`` over 2
  ranks (its two collectives) and its refusal of mismatched key sets
  (``aggregated=False``), ``telemetry.merged_snapshot`` over the world,
  and the rank as the trace events' ``pid``;
* ``make_hybrid_mesh`` keeps the model axis inside one host.
"""

import numpy
import pytest
import torch

import torch_gang
from znicz_tpu.parallel import multihost as jax_multihost
from znicz_tpu_torch import launcher as port_launcher
from znicz_tpu_torch import testing
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.parallel import FusedNet, multihost

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 4},
     "<-": {"learning_rate": 0.1}},
]


@pytest.fixture
def no_world(monkeypatch):
    """No torchrun variables or cluster markers, and a fresh module
    flag."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK") + multihost._CLUSTER_ENV_VARS + (
                    "TPU_WORKER_HOSTNAMES", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_initialized", False)


def test_initialize_is_noop_single_process(no_world):
    assert multihost.initialize() is False
    assert multihost.initialize(device="cpu") is False
    assert jax_multihost.initialize() is False


def test_initialize_detects_cluster_env(no_world, monkeypatch):
    """Cluster markers bring the world up from the environment, with
    gloo for the CPU; torchrun's variables become the init method."""
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("SLURM_JOB_ID", "1234")
    assert multihost.initialize(device="cpu") is True
    assert calls[0]["backend"] == "gloo"
    assert calls[0]["init_method"] == "env://"
    assert multihost.initialize(device="cpu") is True   # idempotent
    assert len(calls) == 1
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.delenv("SLURM_JOB_ID")
    for var, value in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "29500"),
                       ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(var, value)
    assert multihost.initialize(device="cpu") is True
    assert (calls[1]["init_method"], calls[1]["world_size"],
            calls[1]["rank"]) == ("tcp://10.0.0.1:29500", 4, 3)
    assert jax_multihost._CLUSTER_ENV_VARS == multihost._CLUSTER_ENV_VARS


def _refuse(**kwargs):
    raise RuntimeError("connection refused")


def test_explicit_config_failure_is_fatal(no_world, monkeypatch):
    """JAX's rule (``znicz_tpu/launcher.py:54-70``): with MASTER_ADDR
    or WORLD_SIZE set a failed bring-up raises from the launcher (and
    without CUDA the card's backend cannot even be chosen); an
    autodetected marker's failure continues in one process."""
    monkeypatch.setattr(multihost.dist, "init_process_group", _refuse)
    monkeypatch.setenv("SLURM_JOB_ID", "1234")
    launcher = port_launcher.Launcher(device="cpu")
    assert launcher.is_standalone and not launcher.is_master
    assert not launcher.is_slave
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="connection refused"):
        port_launcher.Launcher(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_launcher.Launcher()


def test_host_shard_math():
    for args in ((100, 0, 4), (100, 3, 4), (12, 1, 3)):
        assert multihost.host_shard(*args) == \
            jax_multihost.host_shard(*args)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        multihost.host_shard(10, 0, 4)
    assert multihost.host_shard(10) == (0, 10)


def test_make_hybrid_mesh_single_process():
    assert multihost.make_hybrid_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        multihost.make_hybrid_mesh(model_parallel=2)


def test_merge_telemetry_snapshots_math():
    s1 = {"counters": {"steps": 10, "bytes": 100},
          "gauges": {"epoch": 3},
          "histograms": {"t": {"count": 4, "sum": 2.0, "p50": 0.5}}}
    s2 = {"counters": {"steps": 12, "bytes": 50},
          "gauges": {"epoch": 2},
          "histograms": {"t": {"count": 6, "sum": 3.0, "p50": 0.7}}}
    m = multihost.merge_telemetry_snapshots([s1, s2])
    assert m == jax_multihost.merge_telemetry_snapshots([s1, s2])
    assert m["counters"] == {"steps": 22, "bytes": 150}
    assert m["gauges"] == {"epoch": 3}
    assert m["histograms"]["t"]["p50"] == 0.5
    assert m["histograms"]["t"]["percentiles_local_host_only"] is True
    assert m["hosts"] == 2
    assert multihost.merge_telemetry_snapshots([]) == {}
    assert multihost.aggregate_telemetry(s1) is s1


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    r = numpy.random.RandomState(0)
    local_x = r.uniform(-1, 1, (2, 8, 10))
    local_l = r.randint(0, 4, (2, 8)).astype(numpy.int32)
    directory = str(tmp_path_factory.mktemp("agree"))
    out = testing.run_gang(torch_gang.multihost_gang, 2,
                           args=(local_x, local_l, LAYERS, directory),
                           timeout_s=120)
    return out, local_x, local_l


def test_initialize_is_idempotent_in_a_world(gang):
    for rank, out in enumerate(gang[0]):
        assert out["initialize"] is True
        assert out["world"] == (rank, 2)
        assert out["shard"] == ((0, 5) if rank == 0 else (5, 10))


def test_global_batch_feeds_fused_step(gang):
    """The ranks' rows in rank order; the step on them equals the
    single-device step on the whole batch."""
    outs, local_x, local_l = gang
    x = numpy.concatenate(list(local_x))
    labels = numpy.concatenate(list(local_l))
    net = FusedNet(LAYERS, 10, device="cpu", dtype=numpy.float64,
                   rand=prng.RandomGenerator().seed(7))
    loss = float(net.step(x, labels)["loss"])
    for out in outs:
        numpy.testing.assert_array_equal(out["global"][0], x)
        numpy.testing.assert_array_equal(out["global"][1], labels)
        assert abs(out["loss"] - loss) < 1e-12
        for pa, pb in zip(out["params"], net.host_params()):
            for k in pa:
                assert numpy.abs(pa[k] - pb[k]).max() < 1e-12


def test_aggregate_telemetry_over_two_ranks(gang):
    """Counters and histogram counts and sums summed, gauges maxed,
    this rank's percentiles first; a rank-0-only series leaves every
    rank its local view, flagged."""
    snaps = [{"counters": {"steps": 10 + r, "bytes": 100 * (r + 1)},
              "gauges": {"epoch": 3 + r},
              "histograms": {"t": {"count": 4, "sum": 2.0 + r,
                                   "p50": 0.5 + r}}} for r in (0, 1)]
    for rank, out in enumerate(gang[0]):
        agg = out["aggregate"]
        assert agg["counters"] == {"steps": 21, "bytes": 300}
        assert agg["gauges"] == {"epoch": 4.0}
        assert agg["histograms"]["t"]["count"] == 8
        assert agg["histograms"]["t"]["sum"] == pytest.approx(5.0)
        assert agg["histograms"]["t"]["p50"] == 0.5 + rank
        assert agg["hosts"] == 2
        mis = out["mismatch"]
        assert mis["aggregated"] is False
        assert mis["counters"]["steps"] == snaps[rank]["counters"]["steps"]


def test_merged_snapshot_and_trace_pids(gang):
    for rank, out in enumerate(gang[0]):
        assert out["merged"]["counters"]["gang.steps"] == 1 + 2
        assert out["merged"]["hosts"] == 2
        assert out["pids"] == [rank]
        assert out["agree"] is True


def test_a_time_triggered_snapshot_is_rank_0_s_decision(gang):
    """Known difference: the snapshotter's time trigger is rank 0's
    (``multihost.agree``), so a snapshot due on rank 0 only is taken by
    both ranks (its collection may hold collectives) and written by
    rank 0 alone, once."""
    outs = gang[0]
    for out in outs:
        destination, since_fire, files = out["snapshot"]
        assert since_fire == 0
        assert len([f for f in files if f.startswith("agree")]) == 1
    assert outs[0]["snapshot"][0] is not None
    assert outs[1]["snapshot"][0] is None


def test_make_hybrid_mesh_keeps_the_model_axis_in_a_host(gang):
    for out in gang[0]:
        assert out["hybrid"] == {"data": 1, "model": 2}
        assert "must not cross DCN" in out["hybrid_error"]


def test_cli_mesh_of_another_size_than_the_world_raises(tmp_path):
    """``--fused mesh=2`` in a process without a world raises and says
    how to launch."""
    from znicz_tpu_torch import __main__ as cli
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(["research.wine_relu", "--device", "cpu", "--fused",
                  "mesh=2",
                  "--config", "common.dirs.snapshots=%s" % tmp_path])


def test_torchrun_trains_a_gang_through_the_cli(tmp_path):
    """The README's recipe: ``torchrun --nproc-per-node 2 -m
    znicz_tpu_torch research.wine_relu --device cpu --fused mesh=2``
    brings up a gloo world of 2, both ranks train the same epochs, and
    rank 0 alone writes the snapshots."""
    import os
    import re
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "znicz_tpu_torch",
         "research.wine_relu", "--device", "cpu", "--fused", "mesh=2",
         "--config", "wine_relu.decision.max_epochs=2",
         "--config", "common.dirs.snapshots=%s" % tmp_path],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert sorted(re.findall(r"torch.distributed up: rank (\d) of 2",
                             out)) == ["0", "1"], out[-3000:]
    errs = re.findall(r"Epoch 2 class train n_err (\d+) of 178", out)
    assert len(errs) == 2 and errs[0] == errs[1], out[-3000:]
    pids = {f.rsplit(".", 2)[-2] for f in os.listdir(str(tmp_path))
            if f.endswith(".pickle")}
    assert len(pids) == 1, os.listdir(str(tmp_path))
