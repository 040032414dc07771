"""A run's inputs, all made from ``--seed``: the weights, the images and
labels, the epoch orders and the dropout masks' generator.  The same seed gives
the same inputs; the program and the reference are handed the same.

Every stream has its own generator, seeded from ``(seed, stream)``
through numpy's ``SeedSequence``, which takes any whole number, so a
seed past 32 bits is as good as a small one.  Tensors are made on the
run's device in a few large calls.
"""

import numpy

from harness import layers as L

#: the streams of a run, one generator each
WEIGHTS, IMAGES, LABELS, ORDER, DROPOUT = range(5)


def sub_seed(seed, stream, index=0):
    """A 63-bit seed for ``stream`` (and an index inside it)."""
    state = numpy.random.SeedSequence(
        [int(seed) % (1 << 64), int(stream), int(index)]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def host_rng(seed, stream, index=0):
    return numpy.random.default_rng(sub_seed(seed, stream, index))


def torch_gen(torch, seed, stream, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def _magnitude(item):
    """The Znicz fill range of a weighted layer that states none: the
    conv rule ``1 / sqrt(kx*ky*C)`` capped at 0.05, the fully-connected
    ``sqrt(C / (n_in + n_out))`` (C 10, or 9 for tanh) capped at 0.5;
    a third of it for a gaussian filling."""
    args = item["args"]
    gaussian = args.get("weights_filling", "uniform") == "gaussian"
    rows, cols = item["weights"]
    if item["type"] in L.CONV_TYPES:
        vle = 1.0 / numpy.sqrt(cols)
        if gaussian:
            vle /= 3
        return min(vle, 0.05)
    c = 9.0 if item["type"].endswith("tanh") else 10.0
    if item["type"].endswith("sigmoid"):
        c = 1.0
    vle = numpy.sqrt(c / (cols + rows))
    if gaussian:
        vle /= 3
    return min(vle, 0.5)


def _fill(torch, gen, shape, filling, scale, device):
    if filling == "gaussian":
        return torch.randn(shape, generator=gen, device=device) * scale
    if filling == "uniform":
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) \
            * scale
    if filling == "constant":
        return torch.full(shape, float(scale), device=device)
    raise ValueError("unknown filling %r" % filling)


def make_weights(torch, items, seed, device):
    """``[{"w", "b"}]`` float32, one a weighted layer of the walked list,
    in the configuration's layout and not masked: each layer's
    ``weights_filling`` and ``weights_stddev`` (its Znicz default where
    it states none), the bias likewise."""
    gen = torch_gen(torch, seed, WEIGHTS, device)
    out = []
    for it in L.weighted(items):
        args = it["args"]
        scale = args.get("weights_stddev")
        if scale is None:
            scale = _magnitude(it)
        w = _fill(torch, gen, it["weights"],
                  args.get("weights_filling", "uniform"), scale, device)
        bscale = args.get("bias_stddev")
        if bscale is None:
            bscale = scale
        b = _fill(torch, gen, (it["weights"][0],),
                  args.get("bias_filling", "uniform"), bscale, device)
        out.append({"w": w.contiguous(), "b": b.contiguous()})
    return out


def make_labels(torch, seed, n, n_classes, device):
    gen = torch_gen(torch, seed, LABELS, device)
    return torch.randint(0, int(n_classes), (int(n),), generator=gen,
                         device=device, dtype=torch.int64)


def _prototypes(torch, gen, spec, labels, shape, device, chunk):
    """Each image its class's prototype (uniform in [low, high)) plus
    gaussian noise, as the Znicz sample's synthetic ImageNet set is
    made; ``prototypes`` of them, a label's being ``label % prototypes``."""
    n = labels.shape[0]
    protos = torch.rand((int(spec["prototypes"]),) + shape, generator=gen,
                        device=device)
    protos = protos * (spec["high"] - spec["low"]) + spec["low"]
    data = torch.empty((n,) + shape, device=device)
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        data[i:j] = protos[labels[i:j] % protos.shape[0]]
        data[i:j] += torch.randn((j - i,) + shape, generator=gen,
                                 device=device) * spec["noise"]
    return data


def _normalize(torch, data, how):
    """The loader's normalization, in place: "linear" maps the set's
    [min, max] onto [-1, 1]."""
    if how != "linear":
        raise ValueError("unknown normalization %r" % how)
    lo, hi = data.min(), data.max()
    data.sub_(lo).mul_(2.0 / (hi - lo)).sub_(1.0)
    return data


def make_images(torch, config, seed, n, device, chunk=256):
    """``(images, labels)``: ``n`` float32 NHWC images of the
    configuration's kind and their int64 labels."""
    spec = config["data"]
    shape = tuple(int(d) for d in config["input_sample_shape"])
    labels = make_labels(torch, seed, n, config["n_classes"], device)
    gen = torch_gen(torch, seed, IMAGES, device)
    if spec["kind"] != "prototypes":
        raise ValueError("unknown data kind %r" % spec["kind"])
    data = _prototypes(torch, gen, spec, labels, shape, device, chunk)
    return _normalize(torch, data, spec["normalize"]), labels


def epoch_order(seed, epoch, n):
    """Epoch ``epoch``'s order of ``n`` rows."""
    return host_rng(seed, ORDER, epoch).permutation(int(n))
