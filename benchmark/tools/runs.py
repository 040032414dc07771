"""Runs of benchmark cells one after another, each a fresh process as
the benchmark's check makes them, with each run's result line, the end
of its standard error, its exit code and its seconds appended to a JSON
lines file.

    python3 benchmark/tools/runs.py --out FILE --seconds S \\
        WORKLOAD:SEED[:TRACE] ...

Run from the root of a checkout.  The spread of each metric over the
runs of each workload (first to third quartile over the median, as
``statistics.quantiles`` gives them) is printed at the end.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness.stats import spread  # noqa: E402


def one(workload, seed, seconds, trace, timeout):
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        if isinstance(out, bytes):
            out, err = out.decode(), (err or b"").decode()
    wall = time.perf_counter() - t
    result = None
    lines = out.strip().splitlines()
    if lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "seconds": seconds, "rc": rc, "wall_s": wall,
            "result": result, "stderr_tail": err[-3000:]}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("runs", nargs="+")
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    values = {}
    for spec in args.runs:
        parts = spec.split(":")
        workload, seed = parts[0], int(parts[1])
        trace = int(parts[2]) if len(parts) > 2 else 0
        rec = one(workload, seed, args.seconds, trace, args.timeout)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec["result"] or {}
        brief = {k: round(v["value"], 4)
                 for k, v in res.get("metrics", {}).items()}
        print("%s seed %d trace %d rc %d wall %.1f s correct %s %s %s"
              % (workload, seed, trace, rec["rc"], rec["wall_s"],
                 res.get("correct"), brief,
                 {k: v["value"] for k, v in res.get("checks", {}).items()}),
              flush=True)
        if rec["rc"] != 0 or not res:
            print(rec["stderr_tail"][-1500:], flush=True)
        if not trace:
            for k, v in res.get("metrics", {}).items():
                values.setdefault((workload, k), []).append(v["value"])
    for (workload, k), vs in sorted(values.items()):
        if len(vs) >= 3:
            print("spread %s %s: %.5f over %d runs, median %.6g"
                  % (workload, k, spread(vs), len(vs),
                     statistics.median(vs)))


if __name__ == "__main__":
    main()
