"""Long-context demo: needle retrieval trained through ring attention
(``python -m znicz_tpu_torch research.long_context``; under ``torchrun
--nproc-per-node N`` the sequence axis is split over the N ranks).

Counterpart of ``znicz_tpu/samples/research/long_context.py``
(:1-128), at its published config (``root.long_context``: vocab 16,
embed 32, heads 2, seq_len 64, batch 32, 800 steps, lr 1.0).  A MARKER
token appears at a random position and the label is the token right
after it, so the answer needs attention across the whole sequence.
The model: embed -> ring attention
(:func:`znicz_tpu_torch.parallel.sequence.ring_attention`, learned Q/K/V
projections over ``[token, previous token]`` features and a learned
query probe ``bq``) -> readout at the last position -> softmax CE,
trained by plain SGD on the gradient autograd takes through the ring.

Every rank draws the same batches and parameters from one
``numpy.random.RandomState`` (JAX's draws), computes the projections
and the readout on the whole batch, and keeps its block of the
sequence inside the ring, whose split and gather keep every parameter's
gradient whole and equal on every rank (see the sequence module).
"""

import math

import numpy
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core.backends import default_device
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.parallel.mesh import make_mesh
from znicz_tpu_torch.parallel.sequence import ring_attention

root.long_context.update({
    "vocab": 16,      # last id is the MARKER
    "embed": 32,
    "heads": 2,
    "seq_len": 64,
    "batch": 32,
    "steps": 800,
    "learning_rate": 1.0,
})

#: the parameters in the order JAX's ``init_params`` draws them
PARAM_NAMES = ("embed", "wq", "wk", "wv", "bq", "wo")


def make_batch(rand, batch, seq_len, vocab):
    """Sequences with one MARKER; label = the token following it."""
    marker = vocab - 1
    x = rand.randint(0, marker, (batch, seq_len))
    pos = rand.randint(0, seq_len - 1, batch)
    labels = x[numpy.arange(batch), pos + 1].astype(numpy.int32)
    x[numpy.arange(batch), pos] = marker
    return x.astype(numpy.int32), labels


def init_params(rand, vocab, embed, heads):
    """Host float64 parameters, drawn as JAX draws them."""
    scale = 1.0 / math.sqrt(embed)
    return {
        "embed": rand.normal(0, scale, (vocab, embed)),
        # projections read [token, previous-token] features (2E)
        "wq": rand.normal(0, scale, (2 * embed, embed)),
        "wk": rand.normal(0, scale, (2 * embed, embed)),
        "wv": rand.normal(0, scale, (2 * embed, embed)),
        "bq": numpy.zeros(embed),   # learnable probe (see forward)
        "wo": rand.normal(0, scale, (embed, vocab)),
    }


def forward(params, x, mesh, heads):
    """Logits ``(B, vocab)`` of int token ids ``x (B, T)``: each
    position's features are [its token, the previous token], so the
    position after the marker keys on "previous == MARKER" and values
    its own token; ``bq`` lets the readout position emit a
    content-independent probe for that key."""
    b, t = x.shape
    e = params["embed"].shape[1]
    h = params["embed"][x.long()]                       # (B, T, E)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    h2 = torch.cat([h, h_prev], dim=-1)                 # (B, T, 2E)
    q = (h2 @ params["wq"] + params["bq"]).reshape(b, t, heads,
                                                  e // heads)
    k = (h2 @ params["wk"]).reshape(b, t, heads, e // heads)
    v = (h2 @ params["wv"]).reshape(b, t, heads, e // heads)
    a = ring_attention(q, k, v, mesh, causal=False).reshape(b, t, e)
    return a[:, -1] @ params["wo"]


def loss_fn(params, x, labels, mesh, heads):
    logp = F.log_softmax(forward(params, x, mesh, heads), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def run_sample(steps=None, mesh=None, seed=0x10C, device=None,
               dtype=torch.float32, **overrides):
    """Train the retriever on ``device`` (the mesh's, else the card
    unless "cpu"); returns (final accuracy, params, mesh).  ``mesh``
    defaults to one over the whole ``torch.distributed`` world (one rank
    without one)."""
    cfg = root.long_context
    vocab, embed = cfg.vocab, cfg.embed
    heads, t = cfg.heads, cfg.seq_len
    batch = overrides.get("batch", cfg.batch)
    lr = overrides.get("learning_rate", cfg.learning_rate)
    steps = steps if steps is not None else cfg.steps
    mesh = mesh or make_mesh()
    dev = default_device(device or mesh.device)
    rand = numpy.random.RandomState(seed)
    params = {k: torch.as_tensor(v, dtype=dtype, device=dev)
              for k, v in init_params(rand, vocab, embed, heads).items()}

    def tokens(a):
        return torch.as_tensor(a).to(dev)
    for _ in range(steps):
        x, y = make_batch(rand, batch, t, vocab)
        leaves = {k: p.requires_grad_() for k, p in params.items()}
        grads = torch.autograd.grad(
            loss_fn(leaves, tokens(x), tokens(y), mesh, heads),
            [leaves[k] for k in PARAM_NAMES])
        with torch.no_grad():
            params = {k: leaves[k].detach() - lr * g
                      for k, g in zip(PARAM_NAMES, grads)}
    # evaluate on fresh data
    x, y = make_batch(rand, 256, t, vocab)
    with torch.no_grad():
        pred = forward(params, tokens(x), mesh, heads).argmax(-1)
    accuracy = float((pred.cpu().numpy() == y).mean())
    return accuracy, params, mesh


def run(load, main):
    """The launcher contract (a demo: prints the retrieval accuracy; no
    unit graph to build), on the launcher's device."""
    device = getattr(getattr(load, "__self__", None), "device", None)
    accuracy, _, _ = run_sample(device=device)
    print("needle-retrieval accuracy: %.2f%%" % (100 * accuracy))
    _ = main
