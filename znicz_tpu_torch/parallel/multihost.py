"""Multi-process (multi-host) distributed training.

Counterpart of ``znicz_tpu/parallel/multihost.py`` (:35-301).  Every
rank runs the same program on the same data; the mesh spans all ranks
(:func:`znicz_tpu_torch.parallel.mesh.make_mesh`), each rank trains on
its rows of every global minibatch and the gradient is all-reduced over
the data axis.  Recipe::

    from znicz_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op when single-process
    mesh = multihost.make_hybrid_mesh(model_parallel=2)
    net = FusedNet(layers, shape, mesh=mesh)
    for local_x, local_l in my_ranks_rows_of_the_data:
        x, l = multihost.global_batch(mesh, local_x, local_l)
        net.step(x, l)

What maps to what: ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group`` and JAX's variables
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``) become torchrun's (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  The
backend is NCCL when the ranks run on the card and gloo when the caller
asked for the CPU.  Host failure is handled by checkpoint-restart, as in
JAX: only rank 0 writes snapshots and every rank restores them.
"""

import datetime
import os
import zlib

import numpy
import torch
import torch.distributed as dist

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.parallel.mesh import make_mesh, world

_initialized = False

#: a collective that waits longer than this fails the run
DEFAULT_TIMEOUT_S = 600


def initialize(init_method=None, world_size=None, rank=None, device=None,
               timeout_s=DEFAULT_TIMEOUT_S):
    """Bring up ``torch.distributed`` across processes.

    A no-op for single-process runs, and idempotent: a second call in an
    initialized process returns True.  The arguments default from
    torchrun's variables (``MASTER_ADDR`` and ``MASTER_PORT`` make
    ``init_method`` ``tcp://ADDR:PORT``; ``WORLD_SIZE``; ``RANK``).
    Without them, a managed cluster's markers (:func:`_cluster_env_detected`)
    still bring the world up from the environment, since skipping it there
    would train every rank alone.  ``device`` is the ranks' device as
    :func:`default_device` reads it: NCCL on the card (this rank on
    ``cuda:LOCAL_RANK``), gloo on the CPU.  Returns whether a world is
    up."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
        "MASTER_PORT")
    if init_method is None and addr and port:
        init_method = "tcp://%s:%s" % (addr, port)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "0")) or None
    if rank is None and os.environ.get("RANK") is not None:
        rank = int(os.environ["RANK"])
    if init_method is None and world_size in (None, 1):
        if not _cluster_env_detected():
            return False  # genuinely single process
        init_method = "env://"
    dev = default_device(device)
    kwargs = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _initialized = True
    return True


#: env markers of the cluster runtimes JAX's distributed runtime
#: autodetects (JAX :103-108)
_CLUSTER_ENV_VARS = (
    "MEGASCALE_COORDINATOR_ADDRESS",   # multislice
    "COORDINATOR_ADDRESS",
    "SLURM_JOB_ID",                    # Slurm
    "JOB_COMPLETION_INDEX",            # GKE indexed jobs
)


def _cluster_env_detected():
    if any(os.environ.get(v) for v in _CLUSTER_ENV_VARS):
        return True
    # a pod slice: only a multi-worker hostname list means multi-host
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hostnames.split(",") if h.strip()]) > 1:
        return True
    try:
        if int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
            return True
    except ValueError:
        pass
    return False


def make_hybrid_mesh(model_parallel=1, devices=None):
    """A ``(data, model)`` mesh over all ranks with the model axis (the
    all-gather-heavy one) inside one host: torchrun numbers ranks host
    by host, so a model line stays on its host when the host's
    ``LOCAL_WORLD_SIZE`` divides by ``model_parallel``; otherwise it
    raises JAX's error."""
    _, size = world()
    if size % model_parallel:
        raise ValueError("%d devices not divisible by model_parallel %d"
                         % (size, model_parallel))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if size > per_host and per_host % model_parallel:
        raise ValueError(
            "model_parallel %d does not fit inside one DCN granule's %d "
            "devices — the model axis must not cross DCN"
            % (model_parallel, per_host))
    return make_mesh(model_parallel=model_parallel, devices=devices)


def global_batch(mesh, local_x, local_labels, device=None):
    """The global batch from each rank's rows: ``local_x`` and
    ``local_labels`` are this rank's data shard (the ranks of one model
    line pass the same rows), gathered over the data axis in rank order
    onto ``device`` (default: the mesh's, else the card)."""
    dev = default_device(device or mesh.device)
    x = torch.as_tensor(numpy.asarray(local_x)).to(dev)
    labels = torch.as_tensor(numpy.asarray(local_labels)).to(dev)
    return mesh.gather_rows(x), mesh.gather_rows(labels)


# -- telemetry aggregation ---------------------------------------------------

def _flatten_telemetry(snap):
    """Deterministic (kind, name) -> float flattening of the numeric
    parts of a telemetry snapshot (every rank runs the same program, so
    every rank produces the same key list; the caller checks it)."""
    items = []
    for kind in ("counters", "gauges"):
        for k in sorted(snap.get(kind, {})):
            items.append((kind, k, float(snap[kind][k])))
    for k in sorted(snap.get("histograms", {})):
        h = snap["histograms"][k]
        items.append(("hist_count", k, float(h.get("count", 0))))
        items.append(("hist_sum", k, float(h.get("sum", 0.0))))
    return items


def merge_telemetry_snapshots(snaps):
    """Merge per-rank telemetry snapshots into one view: counters and
    histogram count/sum are summed, gauges take the max.  Histogram
    percentiles are kept from the first snapshot (this rank) and
    flagged ``percentiles_local_host_only``."""
    if not snaps:
        return {}
    merged = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind, agg in (("counters", sum), ("gauges", max)):
        keys = set()
        for s in snaps:
            keys.update(s.get(kind, {}))
        for k in sorted(keys):
            vals = [s.get(kind, {}).get(k, 0) for s in snaps]
            v = agg(vals)
            merged[kind][k] = int(v) if kind == "counters" else v
    hkeys = set()
    for s in snaps:
        hkeys.update(s.get("histograms", {}))
    for k in sorted(hkeys):
        hs = [s.get("histograms", {}).get(k) or {} for s in snaps]
        h = dict(hs[0])
        h["count"] = int(sum(x.get("count", 0) for x in hs))
        h["sum"] = float(sum(x.get("sum", 0.0) for x in hs))
        if any(x.get("count") for x in hs[1:]):
            h["percentiles_local_host_only"] = True
        merged["histograms"][k] = h
    merged["hosts"] = len(snaps)
    return merged


def _gather_world(vec):
    """``(world, n)``: every rank's float64 vector ``vec`` (one
    ``all_gather`` over the world, on the card under NCCL)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.as_tensor(vec, dtype=torch.float64).to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def aggregate_telemetry(snap):
    """Reduce every rank's numeric telemetry into one merged view
    (collective: every rank of the world calls it, e.g. through
    ``telemetry.merged_snapshot()``); the identity single-process.  Two
    collectives, both of one shape on every rank: a ``(2,)`` signature
    exchange, then the vector.  Ranks whose key sets differ (a rank-0
    only series) return their local snapshot with ``aggregated=False``
    rather than sum misaligned columns."""
    rank, size = world()
    if size == 1:
        return snap
    items = _flatten_telemetry(snap)
    keys_sig = zlib.crc32("|".join(
        "%s:%s" % (kind, k) for kind, k, _ in items).encode())
    sigs = _gather_world([float(len(items)), float(keys_sig)])
    if not (sigs[:, 0] == len(items)).all() or \
            not (sigs[:, 1] == float(keys_sig)).all():
        snap = dict(snap)
        snap["aggregated"] = False
        return snap
    gathered = _gather_world([v for _, _, v in items])
    snaps = []
    for row in gathered:
        s = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, k, _), v in zip(items, row):
            if kind in ("counters", "gauges"):
                s[kind][k] = v
            elif kind == "hist_count":
                s["histograms"].setdefault(k, {})["count"] = v
            else:
                s["histograms"].setdefault(k, {})["sum"] = v
        snaps.append(s)
    # this rank's percentiles ride in its own row, merged first
    for k, h in snap.get("histograms", {}).items():
        snaps[rank]["histograms"][k] = dict(
            h, **snaps[rank]["histograms"].get(k, {}))
    local = snaps.pop(rank)
    merged = merge_telemetry_snapshots([local] + snaps)
    merged["hosts"] = size
    if "trace" in snap:
        merged["trace"] = snap["trace"]
    return merged


def agree(flag):
    """Rank 0's ``flag`` on every rank (one ``broadcast``): a decision
    the ranks must take together, such as a time-triggered snapshot."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())


def host_shard(global_size, process_index=None, process_count=None):
    """(start, stop) of this rank's contiguous slice of a global batch
    or dataset -- the per-rank data-loading contract."""
    rank, size = world()
    process_index = rank if process_index is None else process_index
    process_count = size if process_count is None else process_count
    if global_size % process_count:
        raise ValueError("global size %d not divisible by %d processes"
                         % (global_size, process_count))
    per = global_size // process_count
    return process_index * per, (process_index + 1) * per
