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
    python -m znicz_tpu_torch alexnet --fused pool_impl=offsets \
        --max-restarts 2 --config alexnet.snapshotter.window_interval=1

A workflow runs on the card unless ``--device cpu``, and without CUDA
it raises instead of carrying on on the CPU.  ``--auto-resume``
restores the newest resumable snapshot of the workflow's snapshotter;
``--max-restarts N`` supervises the run (``launcher.run_supervised``):
a crash is backed off (``--restart-backoff-ms``, doubling, capped at
30 s) and the run re-entered with auto-resume up to N times;
``--testing`` sets ``testing`` on the units after ``initialize``, as
the JAX launcher does.  ``--dump-graph FILE.dot`` writes the workflow's
control graph as Graphviz DOT; as in the JAX CLI, it skips training
unless ``--testing`` is given too.  The observability plane::

    python -m znicz_tpu_torch profile alexnet --fused pool_impl=offsets \
        --out DIR               # the run under the profiler and a trace
    python -m znicz_tpu_torch profile http://127.0.0.1:PORT --seconds 2
    python -m znicz_tpu_torch obs --dir DIR [--postmortem train]

``profile`` runs a workflow (its arguments as above) with telemetry and
the profiler armed under one device trace and writes ``trace.json`` and
``profiler_report.json`` into ``--out`` (:mod:`znicz_tpu_torch.core.
profiler`), or captures a running server's trace; ``obs`` reads the
durable blackbox (:mod:`znicz_tpu_torch.core.blackbox`), which a run
arms with ``--config common.telemetry.blackbox.enabled=True`` (role
"train"); ``obs --rid`` follows one request's persisted trace trees.
``--parity`` runs :func:`znicz_tpu_torch.parity.run_parity` for the
sample (the real dataset, fetched where absent: the network is
required then).  ``--optimize`` is not in this slice of the port
(``ROADMAP.md``).
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
    if argv and argv[0] == "profile":
        # a workflow under the profiler and one device trace, or a
        # running server's capture (core/profiler.py)
        from znicz_tpu_torch.core.profiler import cli_main as profile_main
        return profile_main(argv[1:])
    if argv and argv[0] == "obs":
        # the durable blackbox's queries (core/blackbox.py)
        from znicz_tpu_torch.core.blackbox import cli_main as obs_main
        return obs_main(argv[1:])
    wf = run_workflow_cli(argv)
    decision = getattr(wf, "decision", None)
    if decision is not None and hasattr(decision, "best_n_err_pt"):
        print("best val/train err%%: %s" % (decision.best_n_err_pt,))
    return 0


def run_workflow_cli(argv):
    """Build and run the workflow ``argv`` names (the workflow CLI's
    arguments, without a subcommand); returns the workflow (None after
    ``--list``)."""
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
    parser.add_argument("--auto-resume", action="store_true",
                        help="restore the newest resumable snapshot of "
                             "the workflow's snapshotter, if there is "
                             "one, and continue")
    parser.add_argument("--max-restarts", type=int, default=0,
                        metavar="N",
                        help="supervised mode: catch a crashed run, back "
                             "off and re-enter it with auto-resume up to "
                             "N times (the snapshotter's window_interval "
                             "makes the re-entry resume mid-epoch)")
    parser.add_argument("--restart-backoff-ms", type=float, default=1000.0,
                        metavar="MS",
                        help="supervised restart backoff base (doubles "
                             "a restart, capped at 30 s)")
    parser.add_argument("--testing", action="store_true",
                        help="set testing on the units after initialize "
                             "(the decision then stops after one epoch)")
    parser.add_argument("--dry-run", action="store_true",
                        help="build and initialize only")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    parser.add_argument("--list", action="store_true",
                        help="list the samples and exit")
    parser.add_argument("--dump-graph", metavar="FILE.dot",
                        help="write the workflow's control graph as DOT; "
                             "skips training unless --testing is given")
    parser.add_argument("--parity", action="store_true",
                        help="real-data accuracy parity run: provision "
                             "the dataset (network required where it is "
                             "absent), train the published config, print "
                             "the comparison row")
    parser.add_argument("--optimize", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.optimize:
        raise NotImplementedError("--optimize %s" % _LATER)

    from znicz_tpu_torch.core import blackbox
    from znicz_tpu_torch.core.config import apply_override
    from znicz_tpu_torch.launcher import (list_samples,
                                          resolve_workflow_module,
                                          run_supervised, run_workflow)
    if args.list:
        for name in list_samples():
            print(name)
        return None
    if not args.workflow:
        parser.error("workflow required (or --list)")
    # import first: a sample installs its root.<ns> defaults at import,
    # which would clobber an override applied before it
    module = resolve_workflow_module(args.workflow)
    for assignment in args.config:
        apply_override(assignment)
    if args.parity:
        if args.snapshot or args.testing or args.dry_run or \
                args.dump_graph or args.max_restarts > 0:
            parser.error("--parity runs the published training config "
                         "standalone")
        from znicz_tpu_torch import parity
        fused = parse_fused(args.fused)
        parity.run_parity(module.__name__.rsplit(".", 1)[-1],
                          device=args.device,
                          fused=fused if fused is not None else "auto")
        return 0
    # the durable blackbox, when its knob is on (one config read off)
    blackbox.maybe_arm("train")
    run_args = dict(snapshot=args.snapshot, testing=args.testing,
                    dry_run=args.dry_run or (bool(args.dump_graph)
                                             and not args.testing),
                    device=args.device, fused=parse_fused(args.fused),
                    auto_resume=args.auto_resume)
    if args.max_restarts > 0:
        wf = run_supervised(module, max_restarts=args.max_restarts,
                            restart_backoff_ms=args.restart_backoff_ms,
                            **run_args)
    else:
        wf = run_workflow(module, **run_args)
    if args.dump_graph:
        wf.dump_graph(args.dump_graph)
    return wf


if __name__ == "__main__":
    sys.exit(main())
