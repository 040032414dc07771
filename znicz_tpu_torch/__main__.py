"""``python -m znicz_tpu_torch`` — the workflow CLI, and ``serve``.

Counterpart of ``znicz_tpu/__main__.py``.  Without ``--fused`` a
workflow trains through the unit-at-a-time graph (one unit a layer,
one minibatch at a time), with it through the fused trainer.
Examples::

    python -m znicz_tpu_torch mnist --config mnistr.decision.max_epochs=5
    python -m znicz_tpu_torch alexnet --fused pool_impl=offsets \\
        --config alexnet.decision.max_epochs=3
    python -m znicz_tpu_torch alexnet --fused --snapshot SNAP.pickle
    python -m znicz_tpu_torch research.stl10 --fused pool_impl=offsets
    python -m znicz_tpu_torch wine --config wine.decision.max_epochs=10
    python -m znicz_tpu_torch --list
    python -m znicz_tpu_torch serve PKG.zip --port 8899
    python -m znicz_tpu_torch serve --latest cifar_caffe --dtype bf16
    python -m znicz_tpu_torch serve a=PKG.zip@int8 b=SNAP.pickle

A workflow runs on the card unless ``--device cpu``, and without CUDA
it raises instead of carrying on on the CPU.  ``--optimize``,
``--parity``, ``--max-restarts``, ``--auto-resume``, ``--testing``,
``--dump-graph`` and the ``profile`` and ``obs`` subcommands are not
in this slice of the port (``ROADMAP.md``).
"""

import argparse
import ast
import sys

_LATER = "is not in this slice of the port (see ROADMAP.md)"


def parse_fused(value):
    """``--fused``: None, True, or a dict from ``K=V[,K=V...]`` with
    Python-literal values (strings otherwise)."""
    if not isinstance(value, str):
        return value
    cfg = {}
    for pair in value.split(","):
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit("--fused wants K=V pairs, got %r" % pair)
        try:
            cfg[key.strip()] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            cfg[key.strip()] = raw
    return cfg


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from znicz_tpu_torch.serving.server import main as serve_main
        return serve_main(argv[1:])
    if argv and argv[0] in ("profile", "obs"):
        raise NotImplementedError("the %s subcommand %s" % (argv[0], _LATER))
    parser = argparse.ArgumentParser(
        prog="python -m znicz_tpu_torch",
        description="Train a znicz_tpu_torch workflow (sample name, "
                    "dotted module or .py file) on the GPU unless "
                    "--device cpu; 'python -m znicz_tpu_torch serve ...' "
                    "starts the inference server instead.")
    parser.add_argument("workflow", nargs="?",
                        help="dotted module, .py file, or sample name")
    parser.add_argument("--config", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="config-root override, e.g. "
                             "alexnet.decision.max_epochs=5")
    parser.add_argument("--fused", nargs="?", const=True, default=None,
                        metavar="K=V[,K=V...]",
                        help="fused execution mode and its config, e.g. "
                             "--fused pool_impl=offsets,window=8")
    parser.add_argument("--snapshot", help="snapshot file to resume from")
    parser.add_argument("--dry-run", action="store_true",
                        help="build and initialize only")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--list", action="store_true",
                        help="list the samples and exit")
    for flag, kwargs in (("--optimize", {}), ("--parity", {"action":
                                                            "store_true"}),
                         ("--max-restarts", {"type": int}),
                         ("--auto-resume", {"action": "store_true"}),
                         ("--testing", {"action": "store_true"}),
                         ("--dump-graph", {})):
        parser.add_argument(flag, help=argparse.SUPPRESS, **kwargs)
    args = parser.parse_args(argv)
    for flag in ("optimize", "parity", "max_restarts", "auto_resume",
                 "testing", "dump_graph"):
        if getattr(args, flag):
            raise NotImplementedError(
                "--%s %s" % (flag.replace("_", "-"), _LATER))

    from znicz_tpu_torch.core.config import apply_override
    from znicz_tpu_torch.launcher import (list_samples,
                                          resolve_workflow_module,
                                          run_workflow)
    if args.list:
        for name in list_samples():
            print(name)
        return 0
    if not args.workflow:
        parser.error("workflow required (or --list)")
    # import first: a sample installs its root.<ns> defaults at import,
    # which would clobber an override applied before it
    module = resolve_workflow_module(args.workflow)
    for assignment in args.config:
        apply_override(assignment)
    wf = run_workflow(module, snapshot=args.snapshot, dry_run=args.dry_run,
                      device=args.device, fused=parse_fused(args.fused))
    decision = getattr(wf, "decision", None)
    if decision is not None and hasattr(decision, "best_n_err_pt"):
        print("best val/train err%%: %s" % (decision.best_n_err_pt,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
