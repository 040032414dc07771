"""A run's inputs are a function of the seed alone."""

import numpy
import torch

from harness import inputs, layers as L

BIG = 2 ** 31 + 12345


def test_epoch_orders_repeat_and_differ():
    o = inputs.epoch_order(BIG, 0, 4096)
    assert numpy.array_equal(o, inputs.epoch_order(BIG, 0, 4096))
    assert sorted(o) == list(range(4096))
    assert not numpy.array_equal(o, inputs.epoch_order(BIG, 1, 4096))


def test_images_and_weights_repeat_for_a_seed(tiny_cell):
    cfg = tiny_cell("alexnet.train.b128")["config"]
    dev = torch.device("cpu")
    items = L.walk(cfg["layers"], cfg["input_sample_shape"])
    x1, y1 = inputs.make_images(torch, cfg, BIG, 20, dev, chunk=7)
    x2, y2 = inputs.make_images(torch, cfg, BIG, 20, dev, chunk=7)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert x1.shape == (20,) + tuple(cfg["input_sample_shape"])
    assert torch.isfinite(x1).all() and y1.max() < cfg["n_classes"]
    w1 = inputs.make_weights(torch, items, BIG, dev)
    w2 = inputs.make_weights(torch, items, BIG, dev)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(w1, w2)
               for k in ("w", "b"))
    x3, _ = inputs.make_images(torch, cfg, BIG + 1, 20, dev)
    assert not torch.equal(x1, x3)


def test_sub_seeds_take_any_whole_number():
    seen = {inputs.sub_seed(s, inputs.WEIGHTS) for s in
            (0, 1, 2 ** 32, 2 ** 33 + 1, 2 ** 63)}
    assert len(seen) == 5
    assert all(0 <= s < 2 ** 63 for s in seen)
