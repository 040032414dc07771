#!/usr/bin/env python3
"""Count the traced runs whose device trace lost a kernel record.

Run from the repository root on a machine with a CUDA card::

    python3 tools/trace_records.py [--runs 10] [--cudart static|shared] \
        [--module-loading lazy|eager] [--after]
    python3 tools/trace_records.py --all [--runs 10] [--after]

One configuration: the kernel libraries built with ``nvcc -cudart
static`` (each library with its own copy of the CUDA runtime) or
``-cudart shared`` (bound to the process's ``libcudart``), and CUDA's
module loading lazy or eager (``CUDA_MODULE_LOADING``, set in this
process before CUDA starts).  An untraced fused AlexNet run comes
first, then ``--runs`` pairs of ``chip_smoke.py``'s profiled runs
(``python -m znicz_tpu_torch profile alexnet``, full width, batch 128):
the fused graph (512 / 128 rows) and the unit graph (384 / 128), each
in one ``torch.profiler`` trace whose kernel events are held against
the kernels' launch counters, as the ``profile`` phase does.  With
``--after``, ``chip_smoke.py``'s workflow and resilience phases run
first, as they run before ``profile`` in the whole script, and the fused
traces take the profile phase's 2,048 / 256 rows.  A launch without its
kernel record is named (its place, its stream, why).
``--all`` runs the three configurations of the search in child
processes: static and lazy (before), shared and lazy, static and
eager.  The last line is one JSON object: for each configuration, the
traced runs of each graph and how many lost a record.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "znicz_tpu_torch", "trace_records")
CONFIGS = (("static", "lazy"), ("shared", "lazy"), ("static", "eager"))
FUSED_ROWS, UNITS_ROWS, VALID_ROWS, BATCH = 512, 384, 128, 128


def _flags(cudart):
    from znicz_tpu_torch.ops import cuda_build
    flags = [f for f in cuda_build.NVCC_FLAGS]
    if "-cudart" in flags:
        i = flags.index("-cudart")
        del flags[i:i + 2]
    cuda_build.NVCC_FLAGS = tuple(flags + ["-cudart", cudart])


def _traced(torch, cli, profiler, smoke, argv, steps, valid_mbs):
    """One profiled CLI run: (lost records, launches, the unmatched
    launches' descriptions)."""
    out = argv[argv.index("--out") + 1]
    profiler.reset()
    smoke._zero_counts()
    with profiler.launch_log() as log:
        cli.main(argv)
    launches = smoke._counts()
    with open(os.path.join(out, "profiler_report.json")) as f:
        table = json.load(f)["device_ops"]
    fwd = profiler.kernel_events(table, "max_pooling_offsets_kernel")[0]
    bwd = profiler.kernel_events(table, "max_pooling_backward_kernel")[0]
    want = (3 * (steps + valid_mbs), 3 * steps)
    if (launches["forward"], launches["backward"]) != want:
        raise RuntimeError("launches %s, not %s" % (launches, want))
    lost = (launches["forward"] - fwd) + (launches["backward"] - bwd)
    missing = []
    if lost:
        missing = ["launch %d of %d (%s): %s" % (
            m["index"], len(log), m["kernel"], m["why"])
            for m in profiler.unmatched_launches(
                os.path.join(out, "trace.json"), log)]
    profiler.reset()
    profiler.disable()
    return lost, missing


def run_one(runs, cudart, loading, after=False):
    os.environ["CUDA_MODULE_LOADING"] = loading.upper()
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from znicz_tpu_torch import __main__ as cli
    from znicz_tpu_torch.core import profiler
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.ops import cuda_build, cuda_pooling
    from znicz_tpu_torch.ops import cuda_pooling_backward
    from znicz_tpu_torch.samples import alexnet
    if not torch.cuda.is_available():
        raise SystemExit("trace_records: CUDA is not available")
    _, smi = smoke.phase_device(torch)
    card = "[%s]" % smi
    _flags(cudart)
    t0 = time.perf_counter()
    cuda_build.build_all()
    cuda_pooling.load()
    cuda_pooling_backward.load()
    smoke.say("== %s cudart, %s module loading: built in %.1f s (%s)" % (
        cudart, loading, time.perf_counter() - t0,
        " ".join(cuda_build.NVCC_FLAGS)))
    smoke._profiler_first_start(torch)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fused_rows, fused_valid = (smoke.PROFILE_TRAIN, smoke.WORKFLOW_VALID) \
        if after else (FUSED_ROWS, VALID_ROWS)
    draw = smoke._Prototypes(alexnet,
                             smoke.WORKFLOW_TRAIN + smoke.WORKFLOW_VALID)
    counts = {"fused": [0, 0], "units": [0, 0]}
    with draw, smoke._ConfigRestored(root.alexnet, root.common.profiler):
        if after:
            _, _, reference = smoke.phase_workflow(torch, card)
            smoke.phase_resilience(torch, card, reference)
            del reference
        else:
            cli.main(smoke._one_epoch_argv(
                os.path.join(OUT, "plain"), FUSED_ROWS, VALID_ROWS,
                "--fused", "pool_impl=offsets"))
        for i in range(runs):
            for kind, rows, valid, extra in (
                    ("fused", fused_rows, fused_valid,
                     ("--fused", "pool_impl=offsets")),
                    ("units", UNITS_ROWS, VALID_ROWS, ())):
                argv = smoke._profile_argv(os.path.join(OUT, kind), rows,
                                           valid, *extra)
                lost, missing = _traced(
                    torch, cli, profiler, smoke, argv, -(-rows // BATCH),
                    -(-valid // BATCH))
                counts[kind][0] += 1
                counts[kind][1] += bool(lost)
                smoke.say("   run %d, %s: %s" % (
                    i, kind, "%d record(s) lost: %s" % (
                        lost, "; ".join(missing)) if lost
                    else "every launch has its kernel record"))
    result = {"cudart": cudart, "module_loading": loading, "after": after,
              "traced": {k: v[0] for k, v in counts.items()},
              "lost": {k: v[1] for k, v in counts.items()}}
    smoke.say(json.dumps(result))
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--cudart", choices=("static", "shared"),
                        default="static")
    parser.add_argument("--module-loading", choices=("lazy", "eager"),
                        default="lazy")
    parser.add_argument("--after", action="store_true")
    parser.add_argument("--all", action="store_true")
    args = parser.parse_args()
    if not args.all:
        run_one(args.runs, args.cudart, args.module_loading, args.after)
        return 0
    results = []
    for cudart, loading in CONFIGS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--runs",
             str(args.runs), "--cudart", cudart, "--module-loading",
             loading] + (["--after"] if args.after else []), cwd=HERE,
            stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
        if proc.returncode != 0:
            raise SystemExit("trace_records: %s / %s exited %d"
                             % (cudart, loading, proc.returncode))
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"configurations": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
