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
    torchrun --nproc-per-node 4 -m znicz_tpu_torch mnist --device cpu \
        --fused mesh=4,model_parallel=2

Under ``torchrun`` the launcher brings the ``torch.distributed`` world
up from its variables (NCCL on the card, gloo under ``--device cpu``),
and ``--fused mesh=N[,model_parallel=M]`` trains data-parallel (and
model-parallel over M) over the world's N ranks, each on its rows of
every minibatch; a ``mesh`` of another size than the world raises and
says how to launch.
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
required then).  ``--optimize GENSxPOP`` evolves the ``Range`` values
of the config (:mod:`znicz_tpu_torch.core.genetics`)::

    python -m znicz_tpu_torch WF.py --optimize 4x8 [--device cpu]

Each generation trains as one batched computation a step
(:mod:`znicz_tpu_torch.parallel.population`) where the sites map onto
the fused trainer's hyper slots: the sample's ``population_evaluator``
where it has one, else the namespace of ``root`` that holds every
site; otherwise each individual is a full run of the workflow, fused
when ``--fused`` is given.
"""

import argparse
import ast
import sys

from znicz_tpu_torch.core.config import root


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


def _generic_population_evaluator(sites, device=None):
    """The population evaluator of the one namespace of ``root`` (a
    StandardWorkflow sample's, with ``layers`` and ``loader_name``)
    whose Range sites are exactly ``sites``; None, the reason printed,
    where there is none or it does not fit (JAX ``__main__.py:41``)."""
    from znicz_tpu_torch.core.genetics import enumerate_ranges
    from znicz_tpu_torch.parallel.population import \
        workflow_population_evaluator
    want = {(id(c), k) for c, k, _ in sites}
    try:
        for name, node in root.items():
            if not isinstance(node, type(root)):
                continue
            if "layers" not in node or "loader_name" not in node:
                continue
            found = {(id(c), k) for c, k, _ in enumerate_ranges(node)}
            if found and found == want:
                ev = workflow_population_evaluator(node, sites,
                                                   verbose=True,
                                                   device=device)
                if ev is not None:
                    print("fused GA: vmapping each generation over "
                          "root.%s (generic Range-site mapping)" % name)
                return ev
    except Exception as e:   # the serial path is the promised fallback
        print("fused GA unavailable (%s); evaluating serially" % e)
        return None
    print("fused GA unavailable: no single sample namespace holds all "
          "Range sites; evaluating serially")
    return None


def run_genetics(module, spec, fused=None, device=None):
    """``--optimize GENSxPOP``: evolve the Range values under ``root``
    (JAX ``__main__.py:74``).  A generation trains at once where the
    sites map onto the fused trainer's hyper slots (the module's
    ``population_evaluator(sites)`` where it has one, else
    :func:`_generic_population_evaluator`); otherwise each fitness is a
    full run of the workflow, fused when ``fused`` is given.  Prints
    the best fitness and values; returns 0."""
    from znicz_tpu_torch.core.genetics import (GeneticsOptimizer,
                                               enumerate_ranges)
    from znicz_tpu_torch.launcher import run_workflow
    gens_s, _, pop_s = spec.partition("x")
    try:
        gens = int(gens_s or 4)
        pop = int(pop_s or 8)
    except ValueError:
        raise SystemExit("--optimize wants GENSxPOP (e.g. 4x8), got %r"
                         % spec)
    if gens < 1 or pop < 1:
        raise SystemExit("--optimize needs at least 1 generation and 1 "
                         "individual, got %r" % spec)
    if not enumerate_ranges(root):
        raise SystemExit(
            "--optimize needs Range(...) values in the config; e.g. "
            'root.myns.learning_rate = Range(0.01, 0.001, 0.1)')
    evaluate_population = None
    factory = getattr(module, "population_evaluator", None)
    if factory is not None:
        # a factory that answers None has probed its namespace already
        try:
            evaluate_population = factory(enumerate_ranges(root),
                                          device=device)
        except Exception as e:
            print("sample population evaluator unavailable (%s); "
                  "evaluating serially" % e)
    else:
        evaluate_population = _generic_population_evaluator(
            enumerate_ranges(root), device)
    if evaluate_population is not None and fused:
        print("note: --fused K=V settings do not apply to the vmapped "
              "population path (it is already fused; pass a "
              "population_evaluator for custom control)")
    metric = {"label": "-err%"}

    def evaluate(_cfg):
        wf = run_workflow(module, fused=fused, device=device)
        decision = getattr(wf, "decision", None)
        err = None
        if decision is not None:
            pts = getattr(decision, "best_n_err_pt", None)
            if pts is not None:
                err = pts[1] if pts[1] is not None else pts[2]
            if err is None:
                # an MSE decision: the best (VALID, else TRAIN) mean
                bm = getattr(decision, "best_metrics", None)
                if bm is not None:
                    for clazz in (1, 2):
                        if bm[clazz] is not None:
                            err = bm[clazz][0]
                            metric["label"] = "-avg_mse"
                            break
        if err is None:
            raise SystemExit("workflow exposes no error metric to "
                             "optimize against")
        return -float(err)

    opt = GeneticsOptimizer(evaluate, root, generations=gens,
                            population_size=pop,
                            evaluate_population=evaluate_population)
    values, fitness = opt.run()
    print("best fitness (%s): %.4f" % (metric["label"], fitness))
    for (_, key, rng), value in zip(opt.sites, values):
        print("  %s = %s  (range %s..%s)" % (key, value, rng.min_value,
                                             rng.max_value))
    return 0


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
                             "--fused pool_impl=offsets,window=8 or, "
                             "under torchrun, --fused "
                             "mesh=8,model_parallel=2")
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
    parser.add_argument("--optimize", metavar="GENSxPOP",
                        help="genetic hyperparameter search over the "
                             "Range values of the config (e.g. 4x8: 4 "
                             "generations of 8); fitness is -validation "
                             "error")
    args = parser.parse_args(argv)

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
        if args.optimize or args.snapshot or args.testing or \
                args.dry_run or args.dump_graph or args.max_restarts > 0:
            parser.error("--parity runs the published training config "
                         "standalone")
        from znicz_tpu_torch import parity
        fused = parse_fused(args.fused)
        parity.run_parity(module.__name__.rsplit(".", 1)[-1],
                          device=args.device,
                          fused=fused if fused is not None else "auto")
        return 0
    if args.optimize:
        if args.snapshot or args.testing or args.dry_run or \
                args.dump_graph:
            parser.error("--optimize cannot be combined with --snapshot/"
                         "--testing/--dry-run/--dump-graph")
        if args.max_restarts > 0:
            parser.error("--optimize cannot be combined with "
                         "--max-restarts")
        run_genetics(module, args.optimize, fused=parse_fused(args.fused),
                     device=args.device)
        return None
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
