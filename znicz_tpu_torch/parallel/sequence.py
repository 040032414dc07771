"""Sequence (context) parallelism: ring attention over a mesh axis.

Counterpart of ``znicz_tpu/parallel/sequence.py`` (:41-146).  The
sequence axis is split over the ranks of one mesh axis; each rank keeps
its block of ``T / n`` positions of Q, K and V, and the K/V blocks
travel round the ring (rank ``r`` sends to ``(r + 1) % n``, as JAX's
``ppermute`` ``perm``) while every rank folds each visiting block into
its queries' flash-style streaming softmax (running max and
normalizer), so the ``T x T`` score matrix never exists whole.

What maps to what:

* ``shard_map`` over the mesh becomes the ranks themselves: each rank
  takes its block of the global ``(B, T, H, D)`` arrays and returns the
  global result, all-gathered over the axis;
* ``lax.ppermute`` becomes :meth:`Mesh.shift` (one
  ``batch_isend_irecv`` for K and V) inside :class:`_Rotate`, whose
  backward is the reverse rotation (the ppermute transpose), so the
  ring's gradient flows through ordinary autograd as ``jax.grad``
  flows through ``fori_loop``; the last of JAX's ``n`` rotations,
  whose blocks nothing reads, is not sent;
* the gradient's scale: the split of the inputs gathers its gradient
  from every rank and the gather of the output keeps its own block of
  the gradient, so a replicated computation before and after the ring
  sees the full gradient on every rank, equal to the single-device one.

With ``n == 1`` the rotation is the identity and no collective runs.
"""

import math

import numpy
import torch

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.parallel.mesh import GatherAxis, SplitAxis


def attention_reference(q, k, v, causal=False):
    """Plain softmax attention, ``(B, T, H, D) -> (B, T, H, D)``: the
    single-device function :func:`ring_attention` reproduces."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tk, device=s.device)[None, :] > \
            torch.arange(tq, device=s.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ring_body(q, kb, vb, m, l, acc, q_pos, k_pos, scale, causal):
    """One ring step: fold the visiting K/V block into the running
    flash-softmax state (JAX :55-71)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb) * scale
    if causal:
        mask = k_pos[None, :] > q_pos[:, None]      # (T_q, T_k)
        s = s.masked_fill(mask[None, None], float("-inf"))
    blk_max = s.amax(dim=-1)                        # (B, H, T_q)
    m_new = torch.maximum(m, blk_max)
    # fully-masked rows keep m = -inf; guard the exp against inf - inf
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])  # masked cells: exp(-inf) == 0
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + \
        torch.einsum("bhqk,bkhd->bhqd", p, vb)
    return m_new, l_new, acc_new


class _Rotate(torch.autograd.Function):
    """K and V blocks one step round the ring; the gradient goes one
    step back."""

    @staticmethod
    def forward(ctx, mesh, axis, kb, vb):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.meta = [(t.shape, t.dtype, t.device) for t in (kb, vb)]
        return tuple(mesh.shift([kb, vb], axis, 1))

    @staticmethod
    def backward(ctx, gk, gv):
        grads = [g if g is not None else
                 torch.zeros(shape, dtype=dtype, device=device)
                 for g, (shape, dtype, device) in zip((gk, gv), ctx.meta)]
        gk, gv = ctx.mesh.shift(grads, ctx.axis, -1)
        return None, None, gk, gv


def _as_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(numpy.asarray(a)).to(default_device(device))


def ring_attention(q, k, v, mesh, axis="data", causal=False, device=None):
    """Attention with the sequence axis split over ``mesh``'s ``axis``.

    ``q``, ``k`` and ``v`` are the global ``(B, T, H, D)`` arrays (the
    same on every rank of the axis; numpy arrays are put on ``device``,
    default the mesh's, else the card); ``T`` must divide by the axis
    size.  Returns the global ``(B, T, H, D)`` result on every rank.
    With ``causal`` each rank masks by global positions, so the result
    matches :func:`attention_reference`.  Every rank of the axis calls
    it."""
    if tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError(
            "ring attention is self-attention: q/k/v must share one "
            "(B, T, H, D) shape, got %s / %s / %s"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    n = mesh.shape[axis]
    t = q.shape[1]
    if t % n:
        raise ValueError("sequence length %d not divisible by %d shards"
                         % (t, n))
    device = device or mesh.device
    q, k, v = (_as_tensor(a, device) for a in (q, k, v))
    if n == 1:
        return _ring_local(q, k, v, mesh, axis, 1, t, causal)
    q, k, v = (SplitAxis.apply(a, mesh, axis, 1) for a in (q, k, v))
    out = _ring_local(q, k, v, mesh, axis, n, t // n, causal)
    return GatherAxis.apply(out, mesh, axis, 1)


def _ring_local(q, k, v, mesh, axis, n, t_local, causal):
    """The per-rank body (JAX :114-146): ``q`` is this rank's block;
    the K/V blocks visit through :class:`_Rotate`."""
    my = mesh.coords[axis] if n > 1 else 0
    b, _, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    ar = torch.arange(t_local, device=q.device)
    q_pos = my * t_local + ar
    m = torch.full((b, h, t_local), float("-inf"), dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((b, h, t_local), dtype=q.dtype, device=q.device)
    acc = torch.zeros((b, h, t_local, d), dtype=q.dtype, device=q.device)
    kb, vb = k, v
    for i in range(n):
        # after i rotations this rank holds the block that started at
        # rank (my - i) mod n
        k_pos = ((my - i) % n) * t_local + ar
        m, l, acc = _ring_body(q, kb, vb, m, l, acc, q_pos, k_pos, scale,
                               causal)
        if i + 1 < n:
            kb, vb = _Rotate.apply(mesh, axis, kb, vb)
    # fully-masked rows (l == 0) normalize to 0 rather than NaN
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)  # (B, T_local, H, D)
