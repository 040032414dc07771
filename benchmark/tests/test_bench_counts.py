"""The FLOP and byte counts against hand counts from the samples'
shapes."""

import json
import os

import pytest

from harness import counts, layers as L

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _items(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        cfg = json.load(f)
    return L.walk(cfg["layers"], cfg["input_sample_shape"]), cfg


# AlexNet's multiply-adds an image, layer by layer, from its shapes:
# (output cells) x (kernels) x (window) x (input channels), halved
# behind each grouping of 2.
ALEXNET_MACS = [
    ("conv_str1", 55 * 55 * 96 * 11 * 11 * 3, 1.0),
    ("conv_str2", 27 * 27 * 256 * 5 * 5 * 96, 0.5),
    ("conv_str3", 13 * 13 * 384 * 3 * 3 * 256, 0.5),
    ("conv_str4", 13 * 13 * 384 * 3 * 3 * 384, 1.0),
    ("conv_str5", 13 * 13 * 256 * 3 * 3 * 384, 0.5),
    ("fc6", 6 * 6 * 256 * 4096, 0.5),
    ("fc7", 4096 * 4096, 1.0),
    ("fc_softmax8", 4096 * 1000, 1.0),
]


def test_alexnet_shapes_and_parameters():
    items, cfg = _items("alexnet")
    shapes = {it["name"]: it["out"] for it in items}
    assert shapes["conv_str1"] == (55, 55, 96)
    assert shapes["max_pool1"] == (27, 27, 96)
    assert shapes["max_pool2"] == (13, 13, 256)
    assert shapes["max_pool5"] == (6, 6, 256)
    n = sum(r * c + r for r, c in (it["weights"] for it in
                                   L.weighted(items)))
    assert n == cfg["parameters"] == 62378344


@pytest.mark.parametrize("by_groups", [True, False])
def test_alexnet_forward_flops_by_hand(by_groups):
    items, _ = _items("alexnet")
    want = sum(m * (g if by_groups else 1.0) for _, m, g in ALEXNET_MACS)
    assert counts.forward_flops(items, by_groups) == pytest.approx(2 * want,
                                                                   rel=1e-12)
    got = {it["name"]: it["grouping"] for it in L.weighted(items)}
    assert [n for n, g in got.items() if g] == [
        "conv_str2", "conv_str3", "conv_str5", "fc6"]


def test_alexnet_totals():
    items, _ = _items("alexnet")
    # 1,135 M multiply-adds dense, 743 M by groups; a trained image is
    # 3 x that less conv_str1's input gradient (105.4 M): 4.25 GFLOP
    assert counts.forward_flops(items, False) / 2 == 1135256096
    assert counts.forward_flops(items, True) / 2 == 742912544
    first = ALEXNET_MACS[0][1]
    assert first == 105415200
    assert counts.train_flops(items) == 2 * (3 * 742912544 - first)
    assert counts.train_flops(items, False) == 2 * (3 * 1135256096 - first)


def test_the_first_layer_trains_without_an_input_gradient():
    """A one-layer net counts 2 x its forward; a second layer behind it
    counts 3 x its own."""
    one = L.walk([{"type": "softmax", "->": {"output_sample_shape": 3}}],
                 (4,))
    assert counts.train_flops(one) == 2 * counts.forward_flops(one)
    two = L.walk([{"type": "all2all", "->": {"output_sample_shape": 5}},
                  {"type": "softmax", "->": {"output_sample_shape": 3}}],
                 (4,))
    assert counts.train_flops(two) == 2 * (2 * 4 * 5 + 3 * 5 * 3)


@pytest.mark.parametrize("rows,cols,g,kept", [
    (96, 96 * 25, 2, 0.5), (4096, 9216, 2, 0.5), (3, 4, 2, 0.5),
    (3, 3, 2, 4 / 9), (4, 8, 4, 0.75), (5, 7, None, 1.0)])
def test_kept_fraction_counts_the_mask(rows, cols, g, kept):
    assert L.kept_fraction(rows, cols, g) == pytest.approx(kept)
    if g:
        mask = [[(k % g) != (c % g) for c in range(cols)]
                for k in range(rows)]
        assert sum(map(sum, mask)) == pytest.approx(kept * rows * cols)


# The least bytes of one max pool at 3.35 TB/s, in ms: the bounds of
# the kernel table in PERF.md (section 6), forward and backward alike.
POOL_BOUNDS_MS = [
    ("alexnet", 128, 0, 0.0658), ("alexnet", 128, 1, 0.0417),
    ("alexnet", 128, 2, 0.0094), ("alexnet", 64, 0, 0.0329),
    ("alexnet", 64, 1, 0.0209), ("alexnet", 64, 2, 0.0047)]


@pytest.mark.parametrize("config,batch,index,bound_ms", POOL_BOUNDS_MS)
def test_pool_bytes_match_the_kernel_table(config, batch, index, bound_ms):
    items, _ = _items(config)
    pool = counts.max_pools(items)[index]
    for nbytes in (counts.pool_forward_bytes(pool, batch),
                   counts.pool_backward_bytes(pool, batch)):
        assert round(nbytes / 3.35e12 * 1e3, 4) == bound_ms


def test_pool_bytes_of_a_step():
    items, _ = _items("alexnet")
    fwd = counts.pool_bytes(items, 128, backward=False)
    both = counts.pool_bytes(items, 128, backward=True)
    assert both == 2 * fwd
    assert fwd / 3.35e12 * 1e3 == pytest.approx(0.0658 + 0.0417 + 0.0094,
                                                 abs=2e-4)
