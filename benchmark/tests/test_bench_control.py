"""The check fails what it must: the control (the reference one
precision below, in the program's place) and each fault the cells can
have, with the timed path broken underneath a whole run.  The CPU runs
them at tiny sizes; the card test reads the control at each cell's own
size."""

import json

import pytest
import torch

import run
from harness import compare, train as TR

from conftest import BENCH_DIR, CHECKOUT

SEEDS = (2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7)
TRAIN = ("alexnet.train.b128",)


def _run(r, seed=SEEDS[0]):
    return run.run_cell(r, seed, 0.3, 0, device="cpu")


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_a_training_cell(workload, seed, tiny_cell):
    r = tiny_cell(workload)
    dev = torch.device("cpu")
    ref = TR.reference_readings(torch, r["config"], r["traffic"], seed, dev)
    ctl = TR.reference_readings(torch, r["config"], r["traffic"], seed, dev,
                                "tf32")
    ok, checks = compare.judge(compare.train_numbers(ctl, ref), r["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(workload, tiny_cell,
                                                monkeypatch):
    from znicz_tpu_torch.parallel import fused
    real = fused._train_step

    def unchanged(params, state, *a, **kw):
        _, _, metrics = real(params, state, *a, **kw)
        return params, state, metrics
    monkeypatch.setattr(fused, "_train_step", unchanged)
    res = _run(tiny_cell(workload))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] >= 1.0 - 1e-6


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out_of_the_mean(workload, tiny_cell,
                                             monkeypatch):
    from znicz_tpu_torch.parallel import fused
    real = fused._loss_and_stats

    def half(params, x, labels, *a, **kw):
        # the second half's labels masked out: the mean over the first
        left = torch.arange(labels.shape[0]) >= labels.shape[0] // 2
        return real(params, x, torch.where(left.to(labels.device), -1,
                                           labels), *a, **kw)
    monkeypatch.setattr(fused, "_loss_and_stats", half)
    assert not _run(tiny_cell(workload))["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_a_window_whose_later_steps_reuse_its_first_slice(
        workload, tiny_cell, monkeypatch):
    """A fault in how a window's later steps find their rows: the check
    reads a whole window of the traffic's length."""
    from znicz_tpu_torch.parallel import fused
    real = fused.FusedNet.run_window_sliced

    def stuck(self, starts, *a, **kw):
        return real(self, [starts[0]] * len(starts), *a, **kw)
    monkeypatch.setattr(fused.FusedNet, "run_window_sliced", stuck)
    res = _run(tiny_cell(workload))
    assert not res["correct"]
    assert res["checks"]["loss_gap"]["value"] > \
        res["checks"]["loss_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_fails_each_cell_at_its_size(workload, card):
    """At the cell's own size on the card, on three seeds: the control
    fails one of the cell's numbers (``tools/calibrate.py`` reads the
    same at more seeds, with the faults)."""
    from harness import cells
    r = cells.resolve(cells.benchmark(CHECKOUT), workload, CHECKOUT,
                      BENCH_DIR)
    for seed in SEEDS:
        ref = TR.reference_readings(torch, r["config"], r["traffic"], seed,
                                    card)
        ctl = TR.reference_readings(torch, r["config"], r["traffic"], seed,
                                    card, "tf32")
        ok, checks = compare.judge(compare.train_numbers(ctl, ref),
                                   r["limits"])
        assert not ok, json.dumps(checks)
