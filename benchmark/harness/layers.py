"""The shapes of a Znicz layer list, walked from its input.

A configuration file holds the layer list as the program is given it:
dicts with ``type``, forward arguments under ``->`` and backward ones
under ``<-``.  Tensors are NHWC; conv weights are ``(K, ky*kx*C)`` with
the channel innermost, fully-connected weights ``(n_out, n_in)`` over
the NHWC-flattened input, padding is ``(left, top, right, bottom)`` and
sliding ``(x, y)``.  A ``zero_filter`` layer masks the next weighted
layer's weights: entry ``(k, c)`` is kept where ``k % g != c % g``.
"""

CONV_TYPES = ("conv", "conv_str", "conv_relu", "conv_tanh", "conv_sigmoid")
FC_TYPES = ("all2all", "all2all_str", "all2all_relu", "all2all_tanh",
            "all2all_sigmoid", "softmax")
POOL_TYPES = ("max_pooling", "avg_pooling", "maxabs_pooling")
SHAPELESS = ("norm", "dropout", "activation_str", "activation_relu",
             "activation_tanh", "activation_sigmoid")


def fwd(layer):
    """A layer's forward arguments: its top-level keys under ``->``."""
    out = {k: v for k, v in layer.items()
           if k not in ("type", "name", "->", "<-")}
    out.update(layer.get("->", {}))
    return out


def conv_out(h, w, ky, kx, padding, sliding):
    left, top, right, bottom = padding
    return ((top + h + bottom - ky) // sliding[1] + 1,
            (left + w + right - kx) // sliding[0] + 1)


def pool_out(h, w, ky, kx, sliding):
    """Ceil mode: a last window that overhangs the edge is kept."""
    outs = []
    for size, k, s in ((h, ky, sliding[1]), (w, kx, sliding[0])):
        last = size - k
        outs.append(last // s + 1 + (1 if last % s else 0))
    return tuple(outs)


def walk(layers, input_shape):
    """One dict a layer: ``type``, ``name``, ``args`` (forward
    arguments), ``in`` and ``out`` (NHWC sample shapes, or ``(n,)``),
    and for a weighted layer ``weights`` (its 2-D shape) and
    ``grouping`` (the preceding ``zero_filter``'s, or None)."""
    shape = tuple(int(d) for d in input_shape)
    grouping = None
    out = []
    for i, layer in enumerate(layers):
        tpe, args = layer["type"], fwd(layer)
        item = {"type": tpe, "name": layer.get("name", "%s_%d" % (tpe, i)),
                "args": args, "in": shape, "weights": None,
                "grouping": None}
        if tpe in CONV_TYPES:
            h, w, c = shape
            ky, kx, k = int(args["ky"]), int(args["kx"]), \
                int(args["n_kernels"])
            padding = tuple(args.get("padding", (0, 0, 0, 0)))
            sliding = tuple(args.get("sliding", (1, 1)))
            ny, nx = conv_out(h, w, ky, kx, padding, sliding)
            item.update(weights=(k, ky * kx * c), ky=ky, kx=kx,
                        padding=padding, sliding=sliding)
            shape = (ny, nx, k)
        elif tpe in FC_TYPES:
            n_in = 1
            for d in shape:
                n_in *= d
            n_out = int(args["output_sample_shape"])
            item["weights"] = (n_out, n_in)
            shape = (n_out,)
        elif tpe in POOL_TYPES:
            h, w, c = shape
            ky, kx = int(args["ky"]), int(args["kx"])
            sliding = tuple(args.get("sliding") or (kx, ky))
            ny, nx = pool_out(h, w, ky, kx, sliding)
            item.update(ky=ky, kx=kx, sliding=sliding)
            shape = (ny, nx, c)
        elif tpe == "zero_filter":
            grouping = int(args.get("grouping", 2))
        elif tpe not in SHAPELESS:
            raise ValueError("layer type %r has no shape rule here" % tpe)
        if item["weights"] is not None:
            item["grouping"], grouping = grouping, None
        item["out"] = shape
        out.append(item)
    return out


def weighted(items):
    """The weighted layers of :func:`walk`'s list, in order."""
    return [it for it in items if it["weights"] is not None]


def kept_fraction(rows, cols, grouping):
    """The share of a ``(rows, cols)`` weight matrix that a grouping
    mask keeps (``k % g != c % g``), exactly; 1 without a grouping."""
    if not grouping:
        return 1.0
    g = int(grouping)
    same = sum(len(range(r, rows, g)) * len(range(r, cols, g))
               for r in range(g))
    return (rows * cols - same) / float(rows * cols)
