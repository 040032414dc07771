"""Population-parallel GA evaluation: a whole generation trains as one
batched computation a step.

Counterpart of ``znicz_tpu/parallel/population.py``, which vmaps the
fused train step over the individuals of a generation
(``make_population_evaluator`` :25, ``uniform_lr_hypers``,
``HYPER_KEYS``, ``config_values_to_hypers`` :123,
``workflow_population_evaluator`` :211).  Here the population is an
explicit leading axis of every parameter and optimizer slot, so each
step is one forward, one backward and one update over all individuals:

* a fully-connected layer is a batched product (``torch.matmul`` over
  ``(P, n_out, n_in)`` weights);
* a convolution is one grouped convolution, the individuals' channels
  side by side (``groups=P``; the first layer, whose input all share,
  is one convolution with the individuals' kernels concatenated);
* pools, LRN and activations fold the population into the batch axis
  or act elementwise;
* the loss is the sum of the individuals' mean softmax-CE losses, whose
  gradient in each individual's parameters is that individual's own;
* the update is :func:`gd_math.update` with each hyper a tensor of one
  value an individual along the leading axis.

Every individual starts from one draw of the seeded stream (the JAX
package's draw order) and trains on one fixed shuffle of the data
(``RandomState(0x5EED)``), as in the JAX package; the hypers are taken
in float32, as the JAX package stacks them.  Fitness is the negative
validation error percent, ``-100 * n_err / n`` in float32 as XLA
computes it for the JAX package (``n_err * (-100 * (1 / n))``).  As there,
the pools take the default "reduce_window" lowering (``F.max_pool2d``)
and dropout is the identity (no key is threaded through).
"""

import numpy
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import (default_device, deterministic,
                                            full_f32)
from znicz_tpu_torch.ops import activations, gd_math
from znicz_tpu_torch.ops import normalization as norm_ops
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.params import tree_map

#: validation rows a forward pass takes at once
VALID_CHUNK = 1024


def _conv(y, w, b, spec, n, batched):
    """The convolution of ``n`` individuals' weights ``w (n, K, ky*kx*C)``
    (bias ``b (n, K)`` or None): over ``y (n, B, H, W, C)`` as one
    grouped convolution when ``batched``, over the shared ``y (B, H, W,
    C)`` as one convolution with the kernels concatenated otherwise;
    returns the linear output ``(n, B, ny, nx, K)``."""
    k, c = spec.n_kernels, spec.n_channels
    if batched:
        bsz, h, wd = y.shape[1:4]
        x = y.permute(1, 2, 3, 0, 4).reshape(bsz, h, wd, n * c)
    else:
        x = y
    wn = w.reshape(n * k, spec.ky, spec.kx, c).permute(0, 3, 1, 2)
    xn = x.permute(0, 3, 1, 2)
    left, top, right, bottom = spec.padding
    if left == right and top == bottom:
        pad = (top, left)
    else:
        xn, pad = F.pad(xn, (left, right, top, bottom)), (0, 0)
    out = F.conv2d(xn, wn, None if b is None else b.reshape(n * k),
                   stride=(spec.sliding[1], spec.sliding[0]), padding=pad,
                   groups=n if batched else 1)
    bsz, _, ny, nx = out.shape
    return out.permute(0, 2, 3, 1).reshape(bsz, ny, nx, n, k).permute(
        3, 0, 1, 2, 4)


def _folded(y, n, fn):
    """``fn`` over ``y (n, B, ...)`` with the population in the batch
    axis."""
    out = fn(y.reshape((n * y.shape[1],) + tuple(y.shape[2:])))
    return out.reshape((n, y.shape[1]) + tuple(out.shape[1:]))


def forward(params, x, specs, n, return_logits=False):
    """The forward pass of ``n`` individuals (every parameter with a
    leading axis of ``n``) over the shared batch ``x``: ``(n, B,
    n_out)``, softmax unless ``return_logits``."""
    y, batched = x, False
    deferred_act = None
    for i, (p, spec) in enumerate(zip(params, specs)):
        if deferred_act is not None and spec.kind != "pool":
            raise AssertionError("deferred activation not consumed")
        if spec.kind in ("fc", "conv"):
            w = p["w"]
            mask = fused._mask(spec, w)
            if mask is not None:
                w = w * mask
            b = p.get("b")
        if spec.kind == "fc":
            y2 = y.reshape(n, y.shape[1], -1) if batched else \
                y.reshape(y.shape[0], -1)
            y = torch.matmul(y2, w.transpose(1, 2))
            if b is not None:
                y = y + b[:, None, :]
            if not spec.is_softmax:
                y = activations.apply(spec.activation, y)
            elif not return_logits:
                y = torch.softmax(y, dim=-1)
            batched = True
        elif spec.kind == "conv":
            lead = (n, y.shape[1]) if batched else (y.shape[0],)
            y = y.reshape(lead + spec.in_shape)
            act = spec.activation
            if (act in fused._MONOTONIC_ACTS and i + 1 < len(specs)
                    and specs[i + 1].kind == "pool"
                    and specs[i + 1].mode == "max"):
                deferred_act, act = act, "linear"
            y = activations.apply(act, _conv(y, w, b, spec, n, batched))
            batched = True
        elif spec.kind == "pool":
            if spec.mode.startswith("stochastic") or spec.record_offsets:
                raise ValueError("the population path takes no %s layer"
                                 % spec.type)

            def pool(t, spec=spec):
                t = t.reshape((t.shape[0],) + spec.in_shape)
                return pool_ops.pooling_reduce_window(
                    t, spec.ky, spec.kx, spec.sliding, spec.mode)
            y = _folded(y, n, pool) if batched else pool(y)
            if deferred_act is not None:
                y = activations.apply(deferred_act, y)
                deferred_act = None
        elif spec.kind == "lrn":
            def lrn(t, spec=spec):
                return norm_ops.lrn_forward(
                    t.reshape((t.shape[0],) + spec.in_shape),
                    alpha=spec.alpha, beta=spec.beta, k=spec.k, n=spec.n)
            y = _folded(y, n, lrn) if batched else lrn(y)
        elif spec.kind == "activation":
            y = activations.apply(spec.activation, y)
        elif spec.kind not in ("dropout", "zerofill"):
            raise ValueError("the population path takes no %s layer"
                             % spec.type)
    if not batched:
        raise ValueError("the population path needs a layer with weights")
    return y


def _train_step(params, state, x, labels, specs, hypers, n):
    """One step of ``n`` individuals: ``(new_params, new_state)``."""
    with torch.no_grad():
        params = fused._apply_weight_masks(params, specs)
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    with torch.enable_grad():
        logp = F.log_softmax(forward(leaves, x, specs, n,
                                     return_logits=True), dim=-1)
        lbl = labels.long()[None, :, None].expand(n, -1, 1)
        ce = -torch.gather(logp, 2, lbl)[..., 0]
        loss = (ce.sum(dim=1) / max(int(labels.shape[0]), 1)).sum()
        flat = [v for p in leaves for v in p.values()]
        grads = iter(torch.autograd.grad(loss, flat))
    new_params, new_state = [], []
    for spec, p, st, hy in zip(specs, params, state, hypers):
        np_, nst = {}, {}
        for name in p:   # "w" then "b", the order of ``flat``
            flags = spec.flags if name == "w" else \
                dict(spec.flags, ortho=False)
            np_[name], nst[name], _ = gd_math.update(
                p[name], next(grads), st[name], hy[name], flags)
        new_params.append(np_)
        new_state.append(nst)
    return new_params, new_state


def _stacked_hypers(hypers, params, device):
    """The individuals' hyper pytrees as one, each leaf a float32 tensor
    of one value an individual shaped to broadcast against its
    parameter (then in the parameter's dtype)."""
    out = []
    for i, p in enumerate(params):
        layer = {}
        for name, t in p.items():
            layer[name] = {
                key: torch.tensor(
                    [float(h[i][name][key]) for h in hypers],
                    dtype=torch.float32, device=device).to(t.dtype).reshape(
                        (len(hypers),) + (1,) * (t.dim() - 1))
                for key in hypers[0][i][name]}
        out.append(layer)
    return out


def make_population_evaluator(layers, input_sample_shape,
                              train_x, train_y, val_x, val_y,
                              values_to_hypers, epochs=6,
                              minibatch_size=None, rand=None,
                              dtype=numpy.float32, defaults=None,
                              device=None):
    """``evaluate_population(value_vectors) -> [fitness, ...]`` for
    :class:`znicz_tpu_torch.core.genetics.GeneticsOptimizer`, on
    ``device`` (the card unless "cpu").

    ``values_to_hypers(values, specs)`` maps one GA value vector onto a
    fused hyper pytree (:func:`fused.default_hypers`'s form); each
    individual trains ``epochs`` passes over ``n // minibatch_size``
    minibatches of the fixed shuffle, and its fitness is the negative
    validation error percent of its softmax head."""
    device = default_device(device)
    full_f32(device)
    deterministic(device)
    specs = tuple(fused.build_specs(layers, input_sample_shape, defaults))
    if not specs[-1].is_softmax:
        raise ValueError("population evaluator scores a softmax head")
    tdtype = fused._TORCH_DTYPES[numpy.dtype(dtype)]
    params0 = [{k: torch.from_numpy(v).to(device) for k, v in p.items()}
               for p in fused.init_params(specs, rand or prng.get(), dtype)]
    train_x = numpy.asarray(train_x, dtype)
    train_y = numpy.asarray(train_y, numpy.int32)
    n_rows = len(train_x)
    perm = numpy.random.RandomState(0x5EED).permutation(n_rows)
    train_x, train_y = train_x[perm], train_y[perm]
    mb = minibatch_size or n_rows
    steps = max(1, n_rows // mb)
    xs = torch.from_numpy(numpy.ascontiguousarray(
        train_x[:steps * mb].reshape((steps, mb) + train_x.shape[1:]))).to(
            device, tdtype)
    ys = torch.from_numpy(numpy.ascontiguousarray(
        train_y[:steps * mb].reshape(steps, mb))).to(device)
    vx = torch.from_numpy(numpy.ascontiguousarray(
        numpy.asarray(val_x, dtype))).to(device, tdtype)
    vy = torch.from_numpy(numpy.asarray(val_y, numpy.int32)).to(device)

    def train(hypers):
        """The individuals' final parameters after ``epochs``."""
        n = len(hypers)
        params = tree_map(
            lambda t: t.unsqueeze(0).expand((n,) + tuple(t.shape)).clone(),
            params0)
        state = fused.init_opt_state(specs, params)
        hy = _stacked_hypers(hypers, params, device)
        for _ in range(int(epochs)):
            for s in range(steps):
                params, state = _train_step(params, state, xs[s], ys[s],
                                            specs, hy, n)
        return params

    def fitness(params, n):
        n_err = torch.zeros(n, dtype=torch.int64, device=device)
        with torch.no_grad():
            for s in range(0, vx.shape[0], VALID_CHUNK):
                probs = forward(params, vx[s:s + VALID_CHUNK], specs, n)
                n_err += (torch.argmax(probs, dim=-1) !=
                          vy[None, s:s + VALID_CHUNK]).sum(dim=1)
        # JAX's -100 * n_err / n as XLA compiles it: n_err times the
        # float32 constant -100 * (1 / n)
        scale = numpy.float32(-100.0) * (numpy.float32(1.0) /
                                         numpy.float32(vy.shape[0]))
        return n_err.to(torch.float32) * float(scale)

    def evaluate_population(value_vectors):
        hypers = [values_to_hypers(list(v), specs) for v in value_vectors]
        params = train(hypers)
        return [float(f) for f in
                fitness(params, len(hypers)).cpu().numpy()]

    evaluate_population.specs = specs
    evaluate_population.train = train
    evaluate_population.fitness = fitness
    return evaluate_population


def uniform_lr_hypers(values, specs):
    """One GA value as the learning rate of every weighted layer,
    weights and bias."""
    lr = float(values[0])
    hypers = []
    for spec in specs:
        if spec.kind in ("fc", "conv"):
            h = {"w": dict(spec.hyper, lr=lr)}
            if spec.include_bias:
                h["b"] = dict(spec.hyper_bias, lr=lr)
            hypers.append(h)
        else:
            hypers.append({})
    return hypers


#: a backward key -> (the hyper's field, whether it is the bias slot,
#: whether the weights' value also sets the bias's), as
#: ``fused._parse_hyper`` couples them
HYPER_KEYS = {
    "learning_rate": ("lr", False, True),
    "learning_rate_bias": ("lr", True, False),
    "weights_decay": ("wd", False, False),
    "weights_decay_bias": ("wd", True, False),
    "gradient_moment": ("moment", False, True),
    "gradient_moment_bias": ("moment", True, False),
    "l1_vs_l2": ("l1_vs_l2", False, True),
    "l1_vs_l2_bias": ("l1_vs_l2", True, False),
    "factor_ortho": ("factor_ortho", False, False),
}


def config_values_to_hypers(sites, layers, specs):
    """``values_to_hypers(values, specs)`` from the Range sites of a
    sample's config, or None when a site maps onto no hyper slot.

    A site inside a layer's dict (or its "<-") tunes that layer's slot;
    a site anywhere else with a key of :data:`HYPER_KEYS` tunes it on
    every weighted layer; the weights' value also sets the bias's where
    the layer declares no ``<key>_bias`` of its own."""
    param_idx = [i for i, s in enumerate(specs)
                 if s.kind in ("fc", "conv")]
    plans = []
    for container, key, _rng in sites:
        if key not in HYPER_KEYS:
            return None
        field, bias, couples = HYPER_KEYS[key]

        def _couple(i):
            sub = (layers[i].get("<-") or {}) \
                if isinstance(layers[i], dict) else {}
            return couples and (key + "_bias") not in sub

        targets = None
        for i, layer in enumerate(layers):
            sub = layer.get("<-") if isinstance(layer, dict) else None
            if container is sub or container is layer:
                if i not in param_idx:
                    return None
                targets = [(i, field, bias, _couple(i))]
                break
        if targets is None:
            targets = [(i, field, bias, _couple(i)) for i in param_idx]
        plans.append(targets)

    def values_to_hypers(values, specs):
        hypers = fused.default_hypers(specs)
        for value, targets in zip(values, plans):
            value = float(value)
            for i, field, bias, couple_bias in targets:
                if bias:
                    if "b" in hypers[i]:
                        hypers[i]["b"][field] = value
                else:
                    hypers[i]["w"][field] = value
                    if couple_bias and "b" in hypers[i]:
                        hypers[i]["b"][field] = value
        return hypers

    return values_to_hypers


def _collapse_ranges(obj):
    """A copy of a layers config with every Range at its default."""
    from znicz_tpu_torch.core.genetics import Range
    if isinstance(obj, Range):
        return obj.default
    if isinstance(obj, dict):
        return {k: _collapse_ranges(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_collapse_ranges(v) for v in obj)
    return obj


def workflow_population_evaluator(ns, sites, epochs=None, seed=12,
                                  loader_kwargs=None, verbose=False,
                                  device=None):
    """The generic ``--optimize`` population path of a StandardWorkflow
    sample: its registered loader from the config namespace ``ns``
    (``root.<sample>``), the Range ``sites`` mapped onto hyper slots and
    :func:`make_population_evaluator` over the loader's TRAIN and VALID
    rows; None where the loader, the topology or a site does not fit
    (the serial fallback), the reason printed when ``verbose``."""
    from znicz_tpu_torch.core.workflow import Workflow
    from znicz_tpu_torch.loader.base import TRAIN, VALID, UserLoaderRegistry

    def bail(reason):
        if verbose:
            print("fused GA unavailable: %s; evaluating serially"  # noqa
                  % reason)
        return None

    layers = _collapse_ranges(list(ns.layers))
    loader_cfg = dict(ns.loader.as_dict() if hasattr(ns.loader, "as_dict")
                      else ns.loader)
    loader_cfg.update(loader_kwargs or {})
    try:
        loader_cls = UserLoaderRegistry.get_factory(ns.loader_name)
        loader = loader_cls(Workflow(None), **loader_cfg)
        loader.initialize()
    except Exception as e:
        return bail("loader %r failed to initialize (%s)"
                    % (ns.loader_name, e))
    data = getattr(loader, "original_data", None)
    labels = getattr(loader, "original_labels", None)
    if data is None or not data or not labels:
        return bail("loader exposes no in-memory dataset/labels")
    x = numpy.asarray(data.mem)
    y = numpy.asarray(labels, dtype=numpy.int32)
    vs, ve = loader.class_index_range(VALID)
    ts, te = loader.class_index_range(TRAIN)
    if te <= ts:
        return bail("loader has no TRAIN segment")
    if ve <= vs:   # no validation split: score on TRAIN
        vs, ve = ts, te
    sample_shape = tuple(x.shape[1:])
    last = layers[-1] if layers else {}
    if isinstance(last, dict) and last.get("type") == "softmax":
        # the head is as wide as the loader's labels where the config
        # leaves it out, as the workflow links it
        fwd = last.setdefault("->", {})
        if "output_sample_shape" not in fwd and \
                "output_samples" not in fwd:
            try:
                fwd["output_sample_shape"] = int(loader.unique_labels_count)
            except Exception:
                pass
    try:
        specs = tuple(fused.build_specs(layers, sample_shape, None))
    except Exception as e:
        return bail("topology is not fusable (%s)" % e)
    if not specs[-1].is_softmax:
        return bail("population fitness needs a softmax head")
    if any(s.kind in ("deconv", "depool") or
           s.kind == "pool" and s.mode.startswith("stochastic")
           for s in specs):
        return bail("topology is not fusable (a stochastic, deconv or "
                    "depooling layer)")
    # the sites are the ORIGINAL config's dicts (the collapsed copy is
    # only for building the specs)
    mapper = config_values_to_hypers(sites, list(ns.layers), specs)
    if mapper is None:
        return bail("a Range site does not map onto fused hyper slots")
    max_epochs = ns.decision.get("max_epochs")
    return make_population_evaluator(
        layers, sample_shape, x[ts:te], y[ts:te], x[vs:ve], y[vs:ve],
        mapper, epochs=epochs or min(int(max_epochs or 10), 10),
        minibatch_size=int(loader_cfg.get("minibatch_size") or 0) or None,
        rand=prng.RandomGenerator().seed(seed), device=device)
