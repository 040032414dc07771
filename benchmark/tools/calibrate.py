"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

* the program's sound readings over many seeds: its checked steps (a
  one-step window, then a window of the traffic's length), which need
  no measured window;
* the control: the reference put in the program's place one precision
  below the configuration's (TF32 on both switches for float32 with
  TF32 off);
* the faults a cell can have, planted in the reference put in the
  program's place: half of the batch left out of the loss.  A state
  left unchanged reads 1 on the change and needs no run.

    python3 benchmark/tools/calibrate.py --workload NAME --out FILE \\
        --seeds 1,2,3 [--control-seeds 1,2,3]
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))

import run  # noqa: E402
from harness import cells, compare  # noqa: E402
from harness import train as TR  # noqa: E402


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def train_readings(torch, resolved, seed, control):
    ctx = run.Context(torch, resolved, seed, 0, False, "cuda",
                      time.perf_counter())
    out = {}
    prog = TR.Program(ctx)
    readings = prog.first_steps()
    prog.close()
    del prog
    _free(torch)
    cfg, tr = resolved["config"], resolved["traffic"]
    ref = TR.reference_readings(torch, cfg, tr, seed, ctx.device)
    out["program"] = compare.train_numbers(readings, ref)
    out["program_loss_gaps"] = [abs(p - r) / abs(r) for p, r in zip(
        readings["losses"], ref["losses"])]
    if control:
        tf32 = TR.reference_readings(torch, cfg, tr, seed, ctx.device,
                                     "tf32")
        out["control_tf32"] = compare.train_numbers(tf32, ref)
        half = TR.reference_readings(torch, cfg, tr, seed, ctx.device,
                                     rows=int(tr["batch"]) // 2)
        out["fault_half_batch"] = compare.train_numbers(half, ref)
        out["fault_unchanged"] = {"change_gap": 1.0}
    _free(torch)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    run.cache_env(os.path.dirname(BENCH_DIR))
    import torch
    resolved = cells.resolve(cells.benchmark(os.path.dirname(BENCH_DIR)),
                             args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        t = time.perf_counter()
        out = train_readings(torch, resolved, seed, seed in control)
        out.update(workload=args.workload, seed=seed,
                   wall_s=time.perf_counter() - t,
                   card=torch.cuda.get_device_name(0))
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
