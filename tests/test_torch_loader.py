"""The port's loader and softmax evaluator against the JAX package's,
on the CPU:

* ``SyntheticImagenetLoader`` rows at size 35, after the "linear"
  normalization fit on the train slice, bit for bit, and the labels;
* the TRAIN and VALID index sequence a ``FullBatchLoader`` serves over
  3 epochs with a reshuffle every epoch and a short tail minibatch,
  equal to ``znicz_tpu``'s ``Loader``'s (same stream seed), with the
  same segment flags and epoch numbers;
* a draw of prototype images is the prefix of any larger draw (the
  chip smoke test draws once for its two training phases);
* ``softmax_ce`` against ``softmax_ce_jax`` in float64 within 1e-12,
  masked rows and labels of -1 included.
"""

import numpy
import pytest
import torch

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.ops import evaluator as jax_evaluator
from znicz_tpu.samples.research import alexnet as jax_alexnet
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.ops import evaluator
from znicz_tpu_torch.samples import alexnet


def _loader(module, prng_mod, **kwargs):
    loader = module.SyntheticImagenetLoader(
        None, prng=prng_mod.RandomGenerator().seed(5), **kwargs)
    loader.initialize()
    return loader


def test_synthetic_imagenet_rows_bit_equal():
    kw = dict(n_train=12, n_valid=5, size=35, minibatch_size=4)
    got = _loader(alexnet, prng, **kw)
    want = _loader(jax_alexnet, jax_prng, **kw)
    g, w = got.original_data.mem, want.original_data.mem
    assert g.dtype == w.dtype == numpy.float32 and g.shape == w.shape
    assert (g.view(numpy.uint32) == w.view(numpy.uint32)).all()
    assert got.original_labels == want.original_labels
    assert got.class_lengths == want.class_lengths == [0, 5, 12]
    assert got.unique_labels_count == 10
    assert got.normalizer.state == want.normalizer.state
    train = g[5:]   # fit on the train slice: it spans [-1, 1]
    assert train.min() == -1.0 and abs(train.max() - 1.0) < 1e-6


def test_prototype_draws_are_prefixes():
    small = alexnet.prototype_images(5, n_classes=3, size=9)
    large = alexnet.prototype_images(8, n_classes=3, size=9)
    for s, lg in zip(small, large):
        assert (s == lg[:5]).all()


def _served(loader, n_minibatches):
    rows = []
    for _ in range(n_minibatches):
        loader.run()
        rows.append((loader.minibatch_class, loader.minibatch_size,
                     bool(loader.last_minibatch), bool(loader.epoch_ended),
                     loader.epoch_number, loader.shuffle_serial,
                     loader.minibatch_indices.mem.tolist(),
                     loader.minibatch_labels.mem.tolist()))
    return rows


@pytest.mark.parametrize("skip_fill", [False, True])
def test_served_sequence_matches_jax(skip_fill):
    kw = dict(n_train=10, n_valid=6, size=5, minibatch_size=4)
    got = _loader(alexnet, prng, **kw)
    want = _loader(jax_alexnet, jax_prng, **kw)
    got.skip_fill = want.skip_fill = skip_fill
    per_epoch = 3 + 2   # TRAIN 4+4+2, VALID 4+2
    seq = _served(got, 3 * per_epoch)
    assert seq == _served(want, 3 * per_epoch)
    assert [r[0] for r in seq[:per_epoch]] == [2, 2, 2, 1, 1]
    assert [r[1] for r in seq[:per_epoch]] == [4, 4, 2, 4, 2]
    assert seq[-1][4] == 3 and seq[-1][3]
    epochs = [sorted(i for r in seq[e * per_epoch:e * per_epoch + 3]
                     for i in r[6] if i >= 0) for e in range(3)]
    assert all(e == list(range(6, 16)) for e in epochs)
    orders = [[i for r in seq[e * per_epoch:e * per_epoch + 3]
               for i in r[6]] for e in range(3)]
    assert orders[0] != orders[1] != orders[2]     # reshuffled each epoch
    assert (got.train_indices == want.train_indices).all()


def test_softmax_ce_matches_jax():
    rng = numpy.random.RandomState(3)
    b, c = 9, 6
    logits = rng.normal(size=(b, c))
    out = numpy.exp(logits) / numpy.exp(logits).sum(1, keepdims=True)
    max_idx = out.argmax(1).astype(numpy.int32)
    labels = rng.randint(0, c, b).astype(numpy.int32)
    labels[2] = -1
    max_idx[4] = labels[4]
    for batch_size in (b, 7):
        got = evaluator.softmax_ce(
            torch.from_numpy(out), torch.from_numpy(max_idx),
            torch.from_numpy(labels), batch_size, c)
        want = jax_evaluator.softmax_ce_jax(out, max_idx, labels,
                                            batch_size, c, mean=True)
        numpy.testing.assert_allclose(got[0].numpy(), numpy.asarray(want[0]),
                                      rtol=1e-12, atol=1e-12)
        for g, w in zip(got[1:3], want[1:3]):
            assert (g.numpy() == numpy.asarray(w)).all()
        numpy.testing.assert_allclose(float(got[3]), float(want[3]),
                                      rtol=1e-12)
        assert int(got[1][1]) == min(batch_size, b) - 1
