"""Hands — open against closed hands in grayscale
(``python -m znicz_tpu_torch research.hands``).

Counterpart of ``znicz_tpu/samples/research/hands.py``: ``root.hands``
(one directory of images a class, labelled by the directory's name
through ``full_batch_auto_label_file_image``, VALID carved out of
TRAIN at ``validation_ratio`` 0.15, "linear" normalization,
all2all_tanh 30 -> softmax with the label count's width, learning
rate 0.008, minibatch 40; a published 8.18% validation error),
:func:`materialize_synthetic`, :class:`HandsWorkflow`, :func:`build`,
:func:`run_sample` and :func:`run`, the launcher contract.  Where
``train_paths`` hold no image, :func:`build` writes the JAX package's
synthetic hands there (the same PNGs from the same seed; PIL is
imported only to write and read them).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.image  # noqa: F401 (registers the loaders)

DATA_DIR = os.path.join(root.common.dirs.datasets, "hands")

root.hands.update({
    "decision": {"fail_iterations": 100, "max_epochs": 1000},
    "loss_function": "softmax",
    "snapshotter": {"prefix": "hands", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader_name": "full_batch_auto_label_file_image",
    "loader": {"minibatch_size": 40, "validation_ratio": 0.15,
               "normalization_type": "linear",
               "train_paths": [DATA_DIR]},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 30},
         "<-": {"learning_rate": 0.008, "weights_decay": 0.0}},
        {"name": "fc_softmax2", "type": "softmax",
         "->": {},
         "<-": {"learning_rate": 0.008, "weights_decay": 0.0}}],
})


def materialize_synthetic(data_dir=None, per_class=40, size=24,
                          seed=0x4A4D):
    """Synthetic hands in ``data_dir`` (unless it holds files): "Open"
    is a palm disc with five finger strokes, "Close" the disc alone;
    one directory of PNGs a class.  Returns the directory."""
    from PIL import Image
    data_dir = data_dir or DATA_DIR
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        return data_dir
    r = numpy.random.RandomState(seed)
    xx, yy = numpy.meshgrid(numpy.linspace(-1, 1, size),
                            numpy.linspace(-1, 1, size))
    for clazz, name in ((0, "Close"), (1, "Open")):
        class_dir = os.path.join(data_dir, name)
        os.makedirs(class_dir, exist_ok=True)
        for i in range(per_class):
            cx, cy = r.uniform(-0.15, 0.15, 2)
            rad = r.uniform(0.35, 0.5)
            img = (((xx - cx) ** 2 + (yy - cy + 0.3) ** 2) <
                   rad * rad).astype(float)
            if clazz == 1:   # the fingers: strokes from the palm's top
                for f in range(5):
                    ang = numpy.pi * (0.25 + 0.125 * f) + \
                        r.uniform(-0.05, 0.05)
                    for t in numpy.linspace(0.2, 0.9, 24):
                        fx = cx + t * numpy.cos(ang)
                        fy = cy - 0.3 - t * numpy.sin(ang) * 0.8
                        img[((xx - fx) ** 2 + (yy - fy) ** 2) <
                            0.006] = 1.0
            img = img + r.normal(0, 0.05, img.shape)
            img = (255 * numpy.clip(img, 0, 1)).astype(numpy.uint8)
            Image.fromarray(img).save(
                os.path.join(class_dir, "%s_%03d.png" % (name, i)))
    return data_dir


class HandsWorkflow(StandardWorkflow):
    """The Hands workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`HandsWorkflow` from ``root.hands``, with the given
    config dicts merged over it; the synthetic set is written into the
    first of ``train_paths`` if none of them holds a file."""
    cfg = root.hands
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    train_paths = loader_cfg.get("train_paths") or []
    if not any(os.path.isdir(p) and os.listdir(p) for p in train_paths):
        materialize_synthetic(train_paths[0] if train_paths else None)
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return HandsWorkflow(
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
    """The launcher contract (``python -m znicz_tpu_torch
    research.hands``)."""
    load(build)
    main()
