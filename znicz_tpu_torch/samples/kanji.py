"""Kanji — glyph images regressed onto their label's clean target
image (``python -m znicz_tpu_torch kanji``).

Counterpart of ``znicz_tpu/samples/kanji.py`` (``root.kanji``: three
``all2all_tanh`` layers 250 -> 250 -> 24x24, learning rate 0.0001,
minibatch 50, a 15% validation split; the
``full_batch_auto_label_file_image_mse`` loader of
:mod:`znicz_tpu_torch.loader.image_mse`, whose class targets give the
evaluator's nearest-class-target error).  Where ``train_paths`` holds
no directory, :func:`build` writes the JAX package's synthetic glyph
set there (:func:`materialize_synthetic`: the same PNGs from the same
seed).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.image_mse  # noqa: F401 (registers the loader)


def data_dir():
    """The default data directory, read at each call (the datasets'
    directory may change at run time)."""
    return os.path.join(root.common.dirs.datasets, "kanji")


root.kanji.update({
    "decision": {"fail_iterations": 1000, "max_epochs": 10000},
    "loss_function": "mse",
    "loader_name": "full_batch_auto_label_file_image_mse",
    "snapshotter": {"prefix": "kanji", "interval": 1, "time_interval": 0,
                    "compression": ""},
    "loader": {"minibatch_size": 50,
               "normalization_type": "linear",
               "targets_normalization_type": "range_linear",
               "targets_shape": (24, 24),
               "validation_ratio": 0.15},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 250,
                "weights_filling": "uniform", "weights_stddev": 0.03125,
                "bias_filling": "uniform", "bias_stddev": 0.03125},
         "<-": {"learning_rate": 0.0001, "weights_decay": 0.00005}},
        {"name": "fc_tanh2", "type": "all2all_tanh",
         "->": {"output_sample_shape": 250,
                "weights_filling": "uniform",
                "weights_stddev": 0.036858530918682665,
                "bias_filling": "uniform",
                "bias_stddev": 0.036858530918682665},
         "<-": {"learning_rate": 0.0001, "weights_decay": 0.00005}},
        {"name": "fc_tanh3", "type": "all2all_tanh",
         "->": {"output_sample_shape": (24, 24),
                "weights_filling": "uniform",
                "weights_stddev": 0.036858530918682665,
                "bias_filling": "uniform",
                "bias_stddev": 0.036858530918682665},
         "<-": {"learning_rate": 0.0001, "weights_decay": 0.00005}}],
})


def materialize_synthetic(base_dir=None, n_classes=6, per_class=30,
                          seed=0x4A17):
    """The synthetic glyph set in the reference's layout, where
    ``base_dir`` holds none: ``train/<label>/NNN.png``, noisy shifted
    32x32 renderings, and ``target/<label>.png``, the clean 24x24
    prototypes.  Returns ``base_dir``."""
    from PIL import Image
    base_dir = base_dir or data_dir()
    train_dir = os.path.join(base_dir, "train")
    target_dir = os.path.join(base_dir, "target")
    if os.path.isdir(train_dir) and os.path.isdir(target_dir):
        return base_dir
    r = numpy.random.RandomState(seed)
    os.makedirs(target_dir, exist_ok=True)
    for c in range(n_classes):
        label = "glyph%02d" % c
        # the prototype: a few random strokes on a 24x24 canvas
        proto = numpy.zeros((24, 24), dtype=numpy.uint8)
        for _ in range(4):
            if r.randint(2):
                row = r.randint(2, 22)
                proto[row, r.randint(0, 8):r.randint(14, 24)] = 255
            else:
                col = r.randint(2, 22)
                proto[r.randint(0, 8):r.randint(14, 24), col] = 255
        Image.fromarray(proto).save(os.path.join(target_dir, label + ".png"))
        cls_dir = os.path.join(train_dir, label)
        os.makedirs(cls_dir, exist_ok=True)
        big = numpy.asarray(Image.fromarray(proto).resize(
            (32, 32), Image.BILINEAR), dtype=numpy.float64)
        for i in range(per_class):
            noisy = big + r.normal(0, 24, big.shape)
            shift = r.randint(-2, 3, 2)
            noisy = numpy.roll(noisy, shift, axis=(0, 1))
            Image.fromarray(
                numpy.clip(noisy, 0, 255).astype(numpy.uint8)).save(
                    os.path.join(cls_dir, "%03d.png" % i))
    return base_dir


class KanjiWorkflow(StandardWorkflow):
    """Glyph recognition through MSE targets (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`KanjiWorkflow` from ``root.kanji``, with the given
    config dicts merged over it; writes the synthetic set where the
    train paths hold no directory."""
    cfg = root.kanji
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.setdefault("train_paths", [os.path.join(data_dir(), "train")])
    loader_cfg.setdefault("target_paths",
                          [os.path.join(data_dir(), "target")])
    loader_cfg.update(loader_config or {})
    train_paths = loader_cfg.get("train_paths") or []
    if not any(os.path.isdir(p) for p in train_paths):
        materialize_synthetic(os.path.dirname(train_paths[0])
                              if train_paths else None)
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return KanjiWorkflow(
        layers=layers if layers is not None else cfg.layers,
        loader_name=cfg.loader_name, loader_config=loader_cfg,
        decision_config=decision_cfg, snapshotter_config=snap_cfg,
        **kwargs)


def run_sample(device=None, **kwargs):
    """Build, initialize on ``device`` (the card unless "cpu") and
    train."""
    wf = build(**kwargs)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    """The launcher contract (``python -m znicz_tpu_torch kanji``)."""
    load(build)
    main()
