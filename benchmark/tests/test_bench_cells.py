"""A cell is found from added files alone, and the harness refuses a
host without a card."""

import json
import os
import shutil

import pytest

import run
from harness import cells

from conftest import BENCH_DIR, CHECKOUT


def test_every_cell_of_the_benchmark_resolves():
    bench = cells.benchmark(CHECKOUT)
    for w in bench["workloads"]:
        r = cells.resolve(bench, w["name"], CHECKOUT, BENCH_DIR)
        names = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert r["per_layer"]
        for m in r["per_layer"]:
            assert m["moves"] in names
            assert callable(cells.reader(m["name"]))
        assert r["limits"]["numbers"]


def test_a_cell_from_added_files(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric,
    each a file of its own, and entries in BENCHMARK.json: no code
    changes."""
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = cells.benchmark(CHECKOUT)
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs",
                                      "alexnet.json")))
    cfg["name"] = "alexnet_wide"
    json.dump(cfg, open(bench_dir / "configs" / "alexnet_wide.json", "w"))
    json.dump({"driver": "train", "batch": 24, "window": 4, "rows": 96},
              open(bench_dir / "traffic" / "train.b24.json", "w"))
    json.dump({"numbers": {"loss_gap": {"limit": 1e-5}}},
              open(bench_dir / "limits" / "alexnet_wide.train.b24.json", "w"))
    (bench_dir / "metrics" / "train.steps.py").write_text(
        "def read(ctx):\n    return ctx.layer['window']['steps']\n")
    bench["configs"].append({"name": "alexnet_wide", "source": "x",
                             "file": "benchmark/configs/alexnet_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "alexnet_wide.train.b24",
                               "config": "alexnet_wide",
                               "traffic": "train.b24", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("alexnet_wide.train.b24")
    bench["per_layer"].append({"name": "train.steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer",
                               "moves": "train_images_per_s",
                               "workloads": ["alexnet_wide.train.b24"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    r = cells.resolve(cells.benchmark(str(root)), "alexnet_wide.train.b24",
                      str(root), str(bench_dir))
    assert r["config"]["name"] == "alexnet_wide"
    assert r["traffic"]["batch"] == 24
    assert [m["name"] for m in r["per_layer"]] == ["train.steps"]
    assert {m["name"] for m in r["end_to_end"]} == {"train_images_per_s",
                                                    "setup_s"}
    read = cells.reader("train.steps", str(bench_dir))
    assert read(type("V", (), {"layer": {"window": {"steps": 9}}})) == 9


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve(cells.benchmark(CHECKOUT), "nope", CHECKOUT,
                      BENCH_DIR)


def test_the_harness_refuses_a_host_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "alexnet.train.b128", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_the_harness_refuses_fewer_cards_than_asked(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "alexnet.train.b128", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
