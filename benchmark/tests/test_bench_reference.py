"""The harness's whole run on the CPU at tiny sizes: the program's
timed path against the plain reference (the only place that imports
both is a test)."""

import math

import pytest
import torch

import run
from harness import inputs, layers as L
from reference import znicz_plain

from conftest import TINY

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_cell_runs_correct(workload, tiny_cell):
    r = tiny_cell(workload)
    res = run.run_cell(r, SEED, 0.4, 0, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in r["end_to_end"]}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_reference_forward_matches_the_ports_net(tiny_cell):
    """The plain forward against ``FusedNet.predict`` on the same
    weights (the port's masks folded in by the port itself)."""
    from znicz_tpu_torch.parallel import fused
    cfg = tiny_cell("alexnet.train.b128")["config"]
    dev = torch.device("cpu")
    items = L.walk(cfg["layers"], cfg["input_sample_shape"])
    weights = inputs.make_weights(torch, items, SEED, dev)
    x, _ = inputs.make_images(torch, cfg, SEED, 6, dev)
    net = fused.FusedNet(cfg["layers"], tuple(cfg["input_sample_shape"]),
                         device="cpu")
    state = net.device_state()
    mine = iter(weights)
    state["params"] = [dict(next(mine)) if "w" in p else p
                       for p in state["params"]]
    net.load_device_state(state)
    got = torch.log(net.predict(x))
    want = znicz_plain.Plain(cfg["layers"], cfg["input_sample_shape"],
                             weights).log_probs(x)
    assert float((got - want).abs().max()) < 1e-5


def test_the_control_rounds_to_tf32():
    t = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    r = znicz_plain._round_tf32(t)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 3.0]
