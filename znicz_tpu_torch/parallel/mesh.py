"""The device mesh of the port: a ``(data, model)`` grid of
``torch.distributed`` ranks.

Counterpart of ``znicz_tpu/parallel/mesh.py`` (:16-49).  JAX runs one
controller over many devices and lets GSPMD insert the collectives;
PyTorch runs one process a device, so a mesh here is the grid of the
initialized world's ranks, rank ``r`` at ``(r // model, r % model)`` as
JAX lays its device array out, with one process group per axis line:

* ``data`` -- the batch axis: each rank trains on its contiguous rows
  of every global minibatch, and the gradient is all-reduced over its
  data line;
* ``model`` -- the parameter axis: a wide FC layer keeps its share of
  the output rows, and its output is all-gathered over the model line.

The collectives are explicit calls of this module (``all_reduce``,
``all_gather``, ``batch_isend_irecv``), each counted in
:attr:`Mesh.counts` by kind, so that a run shows which ones it made.
The data axis needs only ``all_reduce`` and ``broadcast``, the two that
gloo also runs on CUDA tensors: :meth:`Mesh.gather_rows` gathers by a
sum over zeros.

``make_mesh(1)`` in a process that never called
``init_process_group`` has no groups and runs no collective; in an
initialized world every mesh builds its groups, one-rank lines too.
"""

import collections

import torch
import torch.distributed as dist

AXES = ("data", "model")


class Mesh(object):
    """A ``(data, model)`` grid over the world's ranks.

    ``shape`` is ``{"data": n // model, "model": model}`` as JAX's;
    ``coords`` this rank's ``{"data": d, "model": m}``; ``devices`` the
    ``torch.device`` of each rank (None: each entry point's own
    choice), :attr:`device` this rank's."""

    def __init__(self, n_data, n_model, rank=0, devices=None,
                 groups=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.size = self.shape["data"] * self.shape["model"]
        self.rank = int(rank)
        self.coords = {"data": self.rank // self.shape["model"],
                       "model": self.rank % self.shape["model"]}
        self.devices = None if devices is None else tuple(
            torch.device(d) for d in devices)
        #: the process group of this rank's line of each axis (None in a
        #: world that was never initialized)
        self.groups = dict(groups or {a: None for a in AXES})
        #: collectives made through this mesh, by kind
        self.counts = collections.Counter()

    def __repr__(self):
        return "Mesh(data=%d, model=%d, rank=%d)" % (
            self.shape["data"], self.shape["model"], self.rank)

    @property
    def device(self):
        """This rank's device, or None when the mesh maps none."""
        return None if self.devices is None else self.devices[self.rank]

    def axis_ranks(self, axis):
        """The global ranks of this rank's line along ``axis``."""
        return line_ranks(self.shape["data"], self.shape["model"], axis,
                          self.coords["model" if axis == "data"
                                      else "data"])

    def distributed(self, axis):
        """Whether a collective over ``axis`` runs (the world is
        initialized)."""
        return self.groups[axis] is not None

    # -- collectives --------------------------------------------------------
    def all_reduce(self, tensor, axis, op="sum"):
        """``tensor`` reduced in place over ``axis`` (``op`` "sum",
        "max" or "min"); returned for chaining."""
        if self.groups[axis] is not None:
            dist.all_reduce(tensor, op=_OPS[op], group=self.groups[axis])
            self.counts["all_reduce"] += 1
        return tensor

    def gather_rows(self, tensor, axis="data"):
        """The rows of every rank of ``axis``, in rank order, along dim
        0: each rank writes its block into zeros and one all-reduce sums
        them, which is exact (the other terms are zeros)."""
        n = self.shape[axis]
        if self.groups[axis] is None:
            return tensor
        b = tensor.shape[0]
        out = tensor.new_zeros((n * b,) + tuple(tensor.shape[1:]))
        i = self.coords[axis]
        out[i * b:(i + 1) * b] = tensor
        return self.all_reduce(out, axis)

    def all_gather(self, tensor, axis, dim=0):
        """The tensors of every rank of ``axis`` concatenated along
        ``dim`` (one ``all_gather``)."""
        if self.groups[axis] is None:
            return tensor
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.shape[axis])]
        dist.all_gather(parts, tensor, group=self.groups[axis])
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    def shift(self, tensors, axis, step=1):
        """Each tensor of this rank sent to its neighbour ``+step`` along
        ``axis`` (cyclic), and the neighbour ``-step``'s received, in one
        ``batch_isend_irecv``; returns the received tensors."""
        n = self.shape[axis]
        if n == 1 or self.groups[axis] is None:
            return list(tensors)
        ranks = self.axis_ranks(axis)
        i = self.coords[axis]
        dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
        group = self.groups[axis]
        tensors = [t.contiguous() for t in tensors]
        received = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, src, group) for r in received]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counts["send_recv"] += 1
        return received


class SplitAxis(torch.autograd.Function):
    """This rank's block of ``dim`` along a mesh axis; the gradient is
    gathered from every rank, so what comes before sees all of it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n, i = mesh.shape[axis], mesh.coords[axis]
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.all_gather(grad, ctx.axis, ctx.dim), None, None,
                None)


class GatherAxis(torch.autograd.Function):
    """The blocks of every rank of a mesh axis concatenated along
    ``dim``; the gradient keeps this rank's block (what comes after is
    the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.coords[ctx.axis]
        return (grad.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None)


class SumGradAxis(torch.autograd.Function):
    """The identity whose gradient is summed over a mesh axis: what
    comes before a layer split over the axis sees every rank's share of
    its input's gradient (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), ctx.axis), None, None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def line_ranks(n_data, n_model, axis, other):
    """The ranks of the line along ``axis`` at coordinate ``other`` of
    the other axis."""
    if axis == "data":
        return [d * n_model + other for d in range(n_data)]
    return [other * n_model + m for m in range(n_model)]


def world():
    """``(rank, size)`` of the initialized world, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """Build a ``(data, model)`` mesh over the initialized world.

    ``n_devices`` (default: the world's size) must be the world's size;
    ``model_parallel`` sets the model axis and the rest goes to data;
    ``devices`` maps ranks to devices (two ranks may share one).  Every
    rank must call it, in the same order as its other group creations:
    it makes the process group of every data line and every model
    line."""
    rank, size = world()
    n = int(n_devices or size)
    if n > size:
        raise ValueError("requested %d devices, have %d (launch %d ranks: "
                         "torchrun --nproc-per-node %d ...)"
                         % (n, size, n, n))
    if n < size:
        raise ValueError("requested %d devices in a world of %d ranks: a "
                         "mesh spans the whole world" % (n, size))
    if n % model_parallel:
        raise ValueError("n_devices %d not divisible by model_parallel %d"
                         % (n, model_parallel))
    if devices is not None and len(devices) < n:
        raise ValueError("devices maps %d ranks, the mesh has %d"
                         % (len(devices), n))
    n_data, n_model = n // model_parallel, int(model_parallel)
    groups = {a: None for a in AXES}
    if dist.is_available() and dist.is_initialized():
        for axis, other_n in (("data", n_model), ("model", n_data)):
            for other in range(other_n):
                ranks = line_ranks(n_data, n_model, axis, other)
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(n_data, n_model, rank,
                None if devices is None else list(devices)[:n], groups)


def data_parallel_size(mesh):
    return mesh.shape["data"] if mesh is not None else 1


def model_parallel_size(mesh):
    return mesh.shape["model"] if mesh is not None else 1


def check_data_batch(mesh, batch):
    """Loud divisibility contract of every batch-sharded entry point:
    a global batch must split evenly over the mesh's ``data`` axis
    (jagged shards would silently change the per-step math).  No-op
    without a mesh."""
    dsize = data_parallel_size(mesh)
    if batch % dsize:
        raise ValueError("batch %d not divisible by data-parallel %d"
                         % (batch, dsize))
