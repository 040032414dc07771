"""What the port's multi-process tests run in each rank of a gloo gang
(:func:`znicz_tpu_torch.testing.run_gang`).

The ranks are fresh processes that import this module by name, so it
imports torch, numpy and the port only, never jax or the JAX package
(``tests/test_torch_imports.py`` checks that a rank holds neither).
Each body returns host values that the test process holds against the
JAX package and the port's single-device runs.
"""

import os
import sys

import numpy
import torch


def _host(tree):
    """Tensors of a pytree as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _error(fn):
    """The message of the ``ValueError`` ``fn()`` raises (None if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def suite(rank, calls):
    """Several bodies in one gang: ``calls`` is ``[(key, body name,
    args)]``; returns ``{key: body(rank, *args)}``."""
    return {key: globals()[name](rank, *args) for key, name, args in calls}


def imported(rank):
    """The modules of jax and of the JAX package in a rank that imported
    every multi-process module of the port."""
    import znicz_tpu_torch.ops.kohonen  # noqa: F401
    import znicz_tpu_torch.parallel  # noqa: F401
    import znicz_tpu_torch.parallel.multihost  # noqa: F401
    import znicz_tpu_torch.parallel.sequence  # noqa: F401
    import znicz_tpu_torch.samples.research.long_context  # noqa: F401
    import znicz_tpu_torch.testing  # noqa: F401
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "znicz_tpu"))


# -- the mesh ----------------------------------------------------------------

def mesh_layouts(rank):
    """Shapes, coordinates and lines of the meshes over 8 ranks, and the
    errors of the sizes that do not fit."""
    from znicz_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for mp in (1, 2, 4):
        m = make_mesh(8, model_parallel=mp)
        out[mp] = (dict(m.shape), dict(m.coords), m.axis_ranks("data"),
                   m.axis_ranks("model"))
    out["mp3"] = _error(lambda: make_mesh(8, model_parallel=3))
    out["n4"] = _error(lambda: make_mesh(4))
    out["n16"] = _error(lambda: make_mesh(16))
    return out


def mlp_memorizes(rank, layers, x, labels, steps):
    """``FusedMLP`` trained over 8 ranks at model_parallel 1 and 2:
    (first loss, last loss, last n_err, split layers) of each."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import FusedMLP, make_mesh
    out = {}
    for mp in (1, 2):
        net = FusedMLP(layers, x.shape[1], mesh=make_mesh(8, mp),
                       rand=prng.RandomGenerator().seed(42), device="cpu")
        first = None
        for _ in range(steps):
            m = net.step(x, labels)
            if first is None:
                first = float(m["loss"])
        out[mp] = (first, float(m["loss"]), int(m["n_err"]),
                   [getattr(s, "rows", None) for s in net.specs])
    return out


def fused_steps(rank, layers, shape, xs, ls, mp, dropout_seed=0):
    """f64 ``FusedNet`` steps over a mesh of the world with
    ``model_parallel`` ``mp``: the host parameters after each step, the
    losses and n_err, the last step's output, a predict, ``run_steps``
    from the same start and the mesh's collective counts."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.parallel import FusedNet, make_mesh
    import torch.distributed as dist
    mesh = make_mesh(dist.get_world_size(), model_parallel=mp)

    def make():
        return FusedNet(layers, shape, mesh=mesh, dtype=numpy.float64,
                        rand=prng.RandomGenerator().seed(7), device="cpu",
                        dropout_seed=dropout_seed, pool_impl="offsets")
    net = make()
    out = {"params": [], "loss": [], "n_err": []}
    for x, lbl in zip(xs, ls):
        m = net.step(x, lbl)
        out["params"].append(net.host_params())
        out["loss"].append(float(m["loss"]))
        out["n_err"].append(int(m["n_err"]))
    out["output"] = _host(m["output"])
    out["max_idx"] = _host(m["max_idx"])
    out["predict"] = _host(net.predict_with_idx(xs[0]))
    out["state"] = net.state_dict()
    other = make()
    rs = other.run_steps(xs, ls)
    out["run_steps"] = (other.host_params(), _host(rs))
    out["odd_batch"] = _error(lambda: net.step(xs[0][:-1], ls[0][:-1]))
    out["counts"] = dict(mesh.counts)
    out["split"] = [getattr(s, "rows", None) for s in net.specs]
    return out


def kohonen_step(rank, x, w, sigma, gmult):
    """:func:`ops.kohonen.train_step_sharded` over 8 ranks."""
    from znicz_tpu_torch.ops import kohonen
    from znicz_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(8)
    coords = kohonen.make_coords(w.shape[0])
    return _host(kohonen.train_step_sharded(mesh, x, w, coords, sigma,
                                            gmult, device="cpu"))


# -- sequence parallelism ----------------------------------------------------

def ring_cases(rank, cases):
    """Ring attention over the world, as a mesh of model_parallel ``mp``
    along "data", for each ``(name, mp, q, k, v, causal, grad)``: the
    output (with ``grad``, the f64 gradients of ``sum(out ** 2)`` in
    q, k and v), or the ``ValueError``'s message."""
    from znicz_tpu_torch.parallel.mesh import make_mesh
    from znicz_tpu_torch.parallel.sequence import ring_attention
    import torch.distributed as dist
    meshes, out = {}, {}
    for name, mp, q, k, v, causal, grad in cases:
        if mp not in meshes:
            meshes[mp] = make_mesh(dist.get_world_size(), model_parallel=mp)
        mesh = meshes[mp]
        q, k, v = (torch.tensor(a, requires_grad=grad) for a in (q, k, v))
        try:
            y = ring_attention(q, k, v, mesh, axis="data", causal=causal)
        except ValueError as e:
            out[name] = str(e)
            continue
        if grad:
            out[name] = _host(torch.autograd.grad((y ** 2).sum(),
                                                  (q, k, v)))
        else:
            out[name] = _host(y)
    out["counts"] = {mp: dict(m.counts) for mp, m in meshes.items()}
    return out


def long_context(rank, steps, dtype_name):
    """``research.long_context.run_sample`` over the world's ranks:
    (accuracy, host parameters)."""
    from znicz_tpu_torch.samples.research import long_context as lc
    acc, params, _ = lc.run_sample(steps=steps, device="cpu",
                                   dtype=getattr(torch, dtype_name))
    return acc, _host(params)


# -- workflows over a mesh ---------------------------------------------------

FC_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.1}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.1}},
]


def _seed():
    from znicz_tpu_torch.core import prng
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)


def _snapshotter(directory, prefix):
    return {"prefix": prefix, "interval": 10 ** 9, "time_interval": 1e9,
            "compression": "", "directory": directory}


def wine(fused, directory, prefix, mb=16, max_epochs=3, dtype=None):
    """The wine workflow of JAX's mesh training tests, fused by
    ``fused``: (aggregates, host parameters, trainer facts)."""
    import znicz_tpu_torch.loader.loader_wine  # noqa: F401 (registry)
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.standard_workflow import StandardWorkflow
    saved = root.common.engine.get("precision_dtype")
    if dtype is not None:
        root.common.engine.precision_dtype = numpy.dtype(dtype).type
    try:
        _seed()
        wf = StandardWorkflow(
            None, layers=[dict(layer) for layer in FC_LAYERS],
            loader_name="wine_loader",
            loader_config={"minibatch_size": mb},
            decision_config={"max_epochs": max_epochs,
                             "fail_iterations": 100},
            snapshotter_config=_snapshotter(directory, prefix),
            fused=dict(fused))
        wf.initialize(device="cpu")
        wf.run()
    finally:
        root.common.engine.precision_dtype = saved
    return wf


def approximator(fused, directory, prefix, dtype=None):
    """JAX's MSE mesh workflow (the approximator sample)."""
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.samples import approximator as sample
    saved = root.common.engine.get("precision_dtype")
    if dtype is not None:
        root.common.engine.precision_dtype = numpy.dtype(dtype).type
    try:
        _seed()
        wf = sample.build(
            loader_config={"minibatch_size": 64},
            decision_config={"max_epochs": 2, "fail_iterations": 100},
            snapshotter_config=_snapshotter(directory, prefix),
            fused=dict(fused))
        wf.initialize(device="cpu")
        wf.run()
    finally:
        root.common.engine.precision_dtype = saved
    return wf


def facts(wf):
    """What the mesh training tests compare of a finished workflow."""
    d, t = wf.decision, wf.fused_trainer
    out = {"params": t.host_params(),
           "data_shards": t.net.data_shards,
           "device_data": t._use_device_data, "sliced": t._use_sliced,
           "acc_shapes": {k: numpy.shape(v) for k, v in
                          t.net.window_acc_zeros().items()}}
    if hasattr(d, "epoch_metrics"):
        out["metrics"] = [None if m is None else tuple(m)
                          for m in d.epoch_metrics]
    else:
        out["n_err"] = list(d.epoch_n_err)
        out["confusion"] = [None if c is None else numpy.asarray(c)
                            for c in d.confusion_matrixes]
        out["max_err"] = list(d.max_err_y_sums)
    return out


def mesh_workflows(rank, directory, runs):
    """Each ``(name, kind, fused config, dtype)`` of ``runs`` trained on
    a mesh of the world: its :func:`facts` by name.  A "telemetry" run
    also records the d2h calls and readbacks at each epoch's end and
    the summary's shard extents."""
    from znicz_tpu_torch.core import telemetry
    from znicz_tpu_torch.core.config import root
    out = {}
    for name, kind, fused, dtype in runs:
        prefix = "%s_r%d" % (name, rank)
        if kind == "approximator":
            out[name] = facts(approximator(fused, directory, prefix, dtype))
            continue
        if kind != "telemetry":
            out[name] = facts(wine(fused, directory, prefix, dtype=dtype))
            continue
        root.common.telemetry.enabled = True
        telemetry.reset()
        at_epoch = []
        try:
            import znicz_tpu_torch.loader.loader_wine  # noqa: F401
            from znicz_tpu_torch.standard_workflow import StandardWorkflow
            _seed()
            wf = StandardWorkflow(
                None, layers=[dict(layer) for layer in FC_LAYERS],
                loader_name="wine_loader",
                loader_config={"minibatch_size": 16},
                decision_config={"max_epochs": 3, "fail_iterations": 100},
                snapshotter_config=_snapshotter(directory, prefix),
                fused=dict(fused))
            wf.initialize(device="cpu")
            hook = wf.decision.on_training_finished

            def record(hook=hook):
                at_epoch.append((
                    telemetry.counter("transfer.d2h_calls").value,
                    telemetry.counter("trainer.readbacks").value))
                hook()
            wf.decision.on_training_finished = record
            wf.run()
            summary = telemetry.summary()
            merged = telemetry.merged_snapshot()
        finally:
            root.common.telemetry.enabled = False
        out[name] = dict(facts(wf), at_epoch=at_epoch,
                         summary={k: summary.get(k) for k in
                                  ("data_shards", "model_shards")},
                         hosts=merged.get("hosts"),
                         readbacks=merged["counters"].get(
                             "trainer.readbacks"))
    return out


def kill_and_resume(rank, ref_dir, chaos_dir, fused):
    """JAX's kill-and-resume pin over a mesh of the world: the wine run
    uninterrupted, then under a crash at the 8th fused dispatch,
    supervised and resumed from the mid-epoch snapshot rank 0 wrote.
    Returns both runs' facts, the suffixes restored and the files each
    directory holds."""
    import types
    import znicz_tpu_torch.loader.loader_wine  # noqa: F401
    from znicz_tpu_torch import launcher
    from znicz_tpu_torch.core import faults
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    def module(directory):
        mod = types.ModuleType("wine_chaos")
        mod.__file__ = __file__

        def run(load, main):
            _seed()
            load(StandardWorkflow,
                 layers=[dict(layer) for layer in FC_LAYERS],
                 loader_name="wine_loader",
                 loader_config={"minibatch_size": 10},
                 loss_function="softmax",
                 decision_config={"max_epochs": 3, "fail_iterations": 100},
                 snapshotter_config={"prefix": "chaos", "interval": 1,
                                     "time_interval": 0, "compression": "",
                                     "directory": directory,
                                     "window_interval": 2},
                 fused=dict(fused))
            main()
        mod.run = run
        return mod
    ref = launcher.run_workflow(module(ref_dir), device="cpu")
    restored = []
    real = launcher.Launcher._find_resume_state

    def find(self, wf):
        state = real(self, wf)
        restored.append(None if state is None else state["suffix"])
        return state
    launcher.Launcher._find_resume_state = find
    faults.install("fused.dispatch", kind="crash", at=8)
    root.common.faults.enabled = True
    try:
        wf = launcher.run_supervised(module(chaos_dir), device="cpu",
                                     max_restarts=2, restart_backoff_ms=0.0)
        injected = faults.status()["sites"]["fused.dispatch"]["injected"]
    finally:
        root.common.faults.enabled = False
        faults.reset()
        launcher.Launcher._find_resume_state = real
    return {"ref": facts(ref), "chaos": facts(wf), "restored": restored,
            "injected": injected,
            "files": sorted(os.listdir(chaos_dir))}


# -- multihost ---------------------------------------------------------------

def multihost_gang(rank, local_x, local_labels, layers, directory):
    """The multihost functions in a world of 2: the default
    ``host_shard``, ``global_batch`` feeding a step, the telemetry
    aggregation (matched and mismatched key sets), ``agree`` and the
    idempotent ``initialize``."""
    import torch.distributed as dist
    from znicz_tpu_torch.core import prng, telemetry
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.parallel import FusedNet, make_mesh, multihost
    out = {"shard": multihost.host_shard(10),
           "initialize": multihost.initialize(device="cpu")}
    mesh = make_mesh()
    x, labels = multihost.global_batch(mesh, local_x[rank],
                                       local_labels[rank], device="cpu")
    out["global"] = (_host(x), _host(labels))
    net = FusedNet(layers, x.shape[1], mesh=mesh, device="cpu",
                   rand=prng.RandomGenerator().seed(7), dtype=numpy.float64)
    out["loss"] = float(net.step(x, labels)["loss"])
    out["params"] = net.host_params()
    snap = {"counters": {"steps": 10 + rank, "bytes": 100 * (rank + 1)},
            "gauges": {"epoch": 3 + rank},
            "histograms": {"t": {"count": 4, "sum": 2.0 + rank,
                                 "p50": 0.5 + rank}}}
    out["aggregate"] = multihost.aggregate_telemetry(snap)
    odd = dict(snap, counters=dict(snap["counters"]))
    if rank == 0:
        odd["counters"]["only_rank0"] = 1
    out["mismatch"] = multihost.aggregate_telemetry(odd)
    root.common.telemetry.enabled = True
    try:
        telemetry.reset()
        telemetry.counter("gang.steps").inc(rank + 1)
        out["merged"] = telemetry.merged_snapshot()
        telemetry.instant("gang.mark")
        out["pids"] = sorted({e["pid"] for e in telemetry.trace_events()})
    finally:
        root.common.telemetry.enabled = False
    out["agree"] = multihost.agree(rank == 0)
    # a time-triggered snapshot: due on rank 0 only, taken by both
    import time
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    from znicz_tpu_torch.core.workflow import Workflow
    snap = SnapshotterToFile(Workflow(None), prefix="agree",
                             directory=directory, interval=1,
                             time_interval=1000, compression="")
    snap._last_time = 0.0 if rank == 0 else time.time()
    snap.run()
    out["snapshot"] = (snap.destination, snap._since_fire,
                       sorted(os.listdir(directory)))
    out["world"] = (dist.get_rank(), dist.get_world_size())
    out["hybrid"] = dict(multihost.make_hybrid_mesh(model_parallel=2).shape)
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        out["hybrid_error"] = _error(
            lambda: multihost.make_hybrid_mesh(model_parallel=2))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out
