#!/usr/bin/env python3
"""graftlint over the PyTorch/CUDA port — the counterpart of
``tools/graftlint.py`` for ``znicz_tpu_torch``.

The checkers and their reasons live in
:mod:`znicz_tpu_torch.analysis.graftlint`; the scan covers
``znicz_tpu_torch/`` (style and invariants), ``tests/test_torch_*.py``
(style), ``tools/trace_records.py`` and this file (both), and
``chip_smoke.py`` (invariants).

Usage::

    python tools/graftlint_torch.py              # scan; exit 1 on
                                                 # findings outside the
                                                 # baseline
    python tools/graftlint_torch.py --selftest   # every checker must
                                                 # reject its seeded
                                                 # violation and pass
                                                 # its clean twin
    python tools/graftlint_torch.py --write-baseline   # regenerate
                                                 # the reviewed
                                                 # exception file

The baseline (``tools/graftlint_torch_baseline.txt``) holds reviewed
``path :: check :: token`` fingerprints; a finding matching one is
suppressed, and stale entries are reported so the file stays honest.
It imports only the port's analysis and config modules.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from znicz_tpu_torch.analysis import graftlint  # noqa: E402

DEFAULT_BASELINE = os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "graftlint_torch_baseline.txt")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--selftest", action="store_true",
                        help="prove each checker rejects its seeded "
                             "violation and passes its clean twin")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="reviewed-exception fingerprint file "
                             "(default: %(default)s)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from the current "
                             "findings (review the diff!)")
    args = parser.parse_args(argv)

    if args.selftest:
        problems = graftlint.selftest()
        for p in problems:
            print("SELFTEST FAIL: %s" % p)
        if problems:
            return 1
        print("graftlint selftest: %d checkers rejected their seeded "
              "violation and passed their clean twin"
              % len(graftlint.FIXTURES))
        return 0

    top = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = graftlint.run(top)

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as f:
            f.write("# graftlint (the port's) reviewed exceptions — "
                    "one\n# 'path :: check :: token' fingerprint per "
                    "line.\n# Regenerate with --write-baseline; every "
                    "entry needs a review.\n")
            for fp in sorted(set(x.fingerprint for x in findings)):
                f.write(fp + "\n")
        print("baseline: %d entr%s -> %s"
              % (len(findings), "y" if len(findings) == 1 else "ies",
                 args.baseline))
        return 0

    baseline = graftlint.load_baseline(args.baseline)
    kept, suppressed, stale = graftlint.apply_baseline(findings,
                                                       baseline)
    for f in kept:
        print(f)
    for fp in stale:
        print("stale baseline entry (no longer matches — remove it): "
              "%s" % fp)
    if kept:
        print("%d problem(s)%s" % (
            len(kept),
            " (+%d baselined)" % len(suppressed)
            if suppressed else ""))
        return 1
    print("graftlint clean%s%s" % (
        " (%d baselined exception%s)" % (
            len(suppressed), "" if len(suppressed) == 1 else "s")
        if suppressed else "",
        "; %d stale baseline entr%s" % (
            len(stale), "y" if len(stale) == 1 else "ies")
        if stale else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
