"""The plain reference of a Znicz layer list: its forward, its softmax
cross-entropy loss and gradient, and its gradient-descent update, in
float32 PyTorch on NCHW tensors, written from the layers' published
definitions and nothing of the program.

* conv: ``F.conv2d`` over weights stored ``(K, ky*kx*C)`` channel
  innermost, padding ``(left, top, right, bottom)``, sliding ``(x,
  y)``; ``conv_str`` is followed by ``max(x, 0)``;
* max pooling: ``F.max_pool2d`` in ceil mode (a window that overhangs
  the edge is kept);
* LRN (``norm``): ``y_i = x_i / (k + alpha * sum_j x_j^2)^beta`` over
  the channels ``|j - i| <= n // 2``;
* ``zero_filter`` with grouping ``g``: the next weighted layer keeps
  weight ``(k, c)`` where ``k % g != c % g``, ``c`` counting its
  weights' columns;
* a fully-connected layer reads its input flattened in NHWC order;
* dropout keeps ``u >= ratio`` and scales by ``1 / (1 - ratio)``, ``u``
  uniform from the run's dropout generator, one draw of the layer's
  output shape a layer a step, in layer order (the training
  contract of ``FusedNet``: a ``torch.Generator`` on the net's device
  seeded with ``dropout_seed``);
* the loss is the mean cross-entropy of the softmax head's logits;
* the update (the Znicz GD units): ``step = grad + wd * w`` (plus, on
  weights with ``factor_ortho``, ``(col_sums - w) * factor_ortho /
  n_rows``), ``vel = -lr * step + moment * vel``, ``w += vel``; the
  defaults are lr 0.01, wd 0.00005, moment 0, ortho 0, and for the bias
  ``learning_rate_bias`` (default lr), ``weights_decay_bias`` (default
  0) and ``gradient_moment_bias`` (default moment).

``precision`` "f32" runs with TF32 off on both switches; "tf32" is the
control, one precision below: on the card with both switches on, on
the CPU by rounding both operands of every conv and product to TF32's
10-bit mantissa (the forward only).
"""

import contextlib

import torch
import torch.nn.functional as F

#: the layer types this reference holds, with their activation ("relu"
#: is ``max(x, 0)``, Znicz's strict relu; None is linear)
CONV = {"conv": None, "conv_str": "relu"}
FC = {"all2all": None, "all2all_str": "relu", "softmax": None}
ACT = {"activation_str": "relu"}


def _fwd(layer):
    out = {k: v for k, v in layer.items()
           if k not in ("type", "name", "->", "<-")}
    out.update(layer.get("->", {}))
    return out


def _bwd(layer):
    out = {k: v for k, v in layer.items()
           if k not in ("type", "name", "->", "<-")}
    out.update(layer.get("<-", {}))
    return out


def _act(name, y):
    return y if name is None else torch.clamp(y, min=0)


def _round_tf32(t):
    """``t`` with its mantissa rounded to TF32's 10 bits, the gradient
    passed straight through."""
    bits = t.detach().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


@contextlib.contextmanager
def precision_of(precision, device):
    """TF32 off ("f32") or on ("tf32", on the card) on both switches
    for the duration, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = precision == "tf32" and torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Plain:
    """The layer list over an NHWC ``input_shape`` with ``weights``, one
    ``{"w", "b"}`` a weighted layer in the configuration's layout."""

    def __init__(self, layers, input_shape, weights, precision="f32"):
        self.layers = layers
        self.precision = precision
        h, w, c = input_shape
        shape = (int(c), int(h), int(w))
        self.steps = []
        self.params = []
        self.masks = []
        self.hypers = []
        weights = iter(weights)
        grouping = None
        for layer in layers:
            tpe, a = layer["type"], _fwd(layer)
            if tpe == "zero_filter":
                grouping = int(a.get("grouping", 2))
                continue
            if tpe in CONV or tpe in FC:
                p = next(weights)
                wt, b = p["w"].float(), p["b"].float()
                rows, cols = wt.shape
                if grouping:
                    k = torch.arange(rows, device=wt.device)[:, None]
                    j = torch.arange(cols, device=wt.device)[None, :]
                    mask = (k % grouping != j % grouping).float()
                else:
                    mask = None
                grouping = None
                if tpe in CONV:
                    ky, kx = int(a["ky"]), int(a["kx"])
                    cin = shape[0]
                    wt = wt.reshape(rows, ky, kx, cin).permute(0, 3, 1, 2)
                    if mask is not None:
                        mask = mask.reshape(rows, ky, kx, cin).permute(
                            0, 3, 1, 2)
                    left, top, right, bottom = a.get("padding",
                                                     (0, 0, 0, 0))
                    sx, sy = a.get("sliding", (1, 1))
                    hh = (shape[1] + top + bottom - ky) // sy + 1
                    ww = (shape[2] + left + right - kx) // sx + 1
                    self.steps.append(("conv", tpe, (left, top, right,
                                                     bottom), (sy, sx)))
                    shape = (rows, hh, ww)
                else:
                    self.steps.append(("fc", tpe))
                    shape = (rows,)
                wt = wt.contiguous()
                if mask is not None:
                    wt = wt * mask
                self.params.append({"w": wt, "b": b.clone()})
                self.masks.append(mask)
                self.hypers.append(self._hyper(layer))
            elif tpe in ("max_pooling",):
                ky, kx = int(a["ky"]), int(a["kx"])
                sx, sy = a.get("sliding") or (kx, ky)
                out = []
                for size, k, s in ((shape[1], ky, sy), (shape[2], kx, sx)):
                    last = size - k
                    out.append(last // s + 1 + (1 if last % s else 0))
                self.steps.append(("pool", (ky, kx), (sy, sx),
                                   tuple(out)))
                shape = (shape[0],) + tuple(out)
            elif tpe == "norm":
                self.steps.append(("lrn", float(a.get("alpha", 1e-4)),
                                   float(a.get("beta", 0.75)),
                                   float(a.get("k", 2)), int(a.get("n", 5))))
            elif tpe == "dropout":
                self.steps.append(("dropout",
                                   float(a.get("dropout_ratio", 0.5))))
            elif tpe in ACT:
                self.steps.append(("act", ACT[tpe]))
            else:
                raise ValueError("no plain version of layer type %r" % tpe)
        self.vel = [{k: torch.zeros_like(v) for k, v in p.items()}
                    for p in self.params]

    @staticmethod
    def _hyper(layer):
        b = _bwd(layer)
        lr = float(b.get("learning_rate", 0.01))
        wd = float(b.get("weights_decay", 0.00005))
        moment = float(b.get("gradient_moment", 0.0))
        return {"w": {"lr": lr, "wd": wd, "moment": moment,
                      "ortho": float(b.get("factor_ortho", 0.0))},
                "b": {"lr": float(b.get("learning_rate_bias", lr)),
                      "wd": float(b.get("weights_decay_bias", 0.0)),
                      "moment": float(b.get("gradient_moment_bias",
                                            moment)),
                      "ortho": 0.0}}

    def _op(self, t):
        if self.precision == "tf32" and t.device.type == "cpu":
            return _round_tf32(t)
        return t

    def forward(self, x, params=None, dropout_gen=None):
        """The logits of NHWC ``x``; dropout only with ``dropout_gen``."""
        params = self.params if params is None else params
        y = x.permute(0, 3, 1, 2)
        pi = 0
        for st in self.steps:
            kind = st[0]
            if kind in ("conv", "fc"):
                p, mask = params[pi], self.masks[pi]
                pi += 1
                w = p["w"] if mask is None else p["w"] * mask
                if kind == "conv":
                    _, tpe, (left, top, right, bottom), stride = st
                    if (left, top) == (right, bottom):
                        pad = (top, left)
                    else:
                        y = F.pad(y, (left, right, top, bottom))
                        pad = (0, 0)
                    y = F.conv2d(self._op(y), self._op(w), p["b"],
                                 stride=stride, padding=pad)
                    y = _act(CONV[tpe], y)
                else:
                    tpe = st[1]
                    if y.dim() == 4:
                        y = y.permute(0, 2, 3, 1)
                    y = y.reshape(y.shape[0], -1)
                    y = self._op(y) @ self._op(w).t() + p["b"]
                    y = _act(FC[tpe], y)
            elif kind == "pool":
                _, k, s, out = st
                y = F.max_pool2d(y, k, s, ceil_mode=True)
                if tuple(y.shape[2:]) != out:
                    raise ValueError("max_pool2d dropped a ceil-mode window")
            elif kind == "lrn":
                _, alpha, beta, k, n = st
                sq = F.pad(y * y, (0, 0, 0, 0, n // 2, n // 2))
                s = sum(sq[:, i:i + y.shape[1]] for i in range(n))
                y = y / torch.pow(k + alpha * s, beta)
            elif kind == "dropout":
                if dropout_gen is not None:
                    ratio = st[1]
                    shape = (y.permute(0, 2, 3, 1).shape if y.dim() == 4
                             else y.shape)
                    keep = torch.rand(shape, generator=dropout_gen,
                                      device=y.device) >= ratio
                    if y.dim() == 4:
                        keep = keep.permute(0, 3, 1, 2)
                    y = y * keep.to(y.dtype) / (1.0 - ratio)
            else:
                y = _act(st[1], y)
        return y

    def log_probs(self, x):
        with torch.no_grad(), precision_of(self.precision, x.device):
            return F.log_softmax(self.forward(x), dim=1)

    def loss_and_grads(self, x, labels, dropout_gen=None, rows=None):
        """``(loss, grads)``: the mean cross-entropy over the batch (over
        its first ``rows`` where given) and its gradient, one
        ``{"w", "b"}`` a weighted layer."""
        leaves = [{k: v.detach().clone().requires_grad_()
                   for k, v in p.items()} for p in self.params]
        with torch.enable_grad(), precision_of(self.precision, x.device):
            logits = self.forward(x, leaves, dropout_gen)
            if rows is not None:
                logits, labels = logits[:rows], labels[:rows]
            loss = F.cross_entropy(logits, labels.long())
            flat = [v for p in leaves for v in p.values()]
            grads = iter(torch.autograd.grad(loss, flat))
        return loss.detach(), [{k: next(grads) for k in p} for p in leaves]

    @torch.no_grad()
    def update(self, grads):
        """One GD step from ``grads``."""
        for p, v, g, h in zip(self.params, self.vel, grads, self.hypers):
            for name in ("w", "b"):
                hy = h[name]
                w = p[name]
                step = g[name] + hy["wd"] * w
                if hy["ortho"]:
                    rows = w.shape[0]
                    flat = w.reshape(rows, -1)
                    ortho = (flat.sum(dim=0, keepdim=True) - flat) * \
                        (hy["ortho"] / rows)
                    step = step + ortho.reshape(w.shape)
                v[name] = -hy["lr"] * step + hy["moment"] * v[name]
                p[name] = w + v[name]

    def flat_params(self):
        """The parameters in the configuration's layout (conv weights
        back to ``(K, ky*kx*C)``)."""
        out = []
        for p in self.params:
            w = p["w"]
            if w.dim() == 4:
                w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            out.append({"w": w, "b": p["b"]})
        return out

    @staticmethod
    def flat_grads(grads):
        out = []
        for g in grads:
            w = g["w"]
            if w.dim() == 4:
                w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            out.append({"w": w, "b": g["b"]})
        return out
