"""Lines — line-orientation classification through an mcdnnic topology
(``python -m znicz_tpu_torch lines [--fused pool_impl=offsets]``).

Counterpart of ``znicz_tpu/samples/lines.py``: ``root.lines`` (the
published topology ``12x256x256-32C4-MP2-64C4-MP3-32N-4N``, backward
``learning_rate`` 0.01 on every layer, one directory of PNGs a class
through ``full_batch_auto_label_file_image``, ``learn`` as TRAIN and
``test`` as VALID, ``mean_disp`` normalization),
:func:`materialize_synthetic`, :class:`LinesWorkflow`, :func:`build`,
:func:`run_sample` and :func:`run`, the launcher contract.  The
topology string sets the loader's minibatch (12) and the images'
``scale`` (256 x 256).  Where ``train_paths`` hold no directory,
:func:`build` writes the JAX package's synthetic line drawings there
(four orientations, the same PNGs from the same seed; PIL is imported
only to write and read them); the checkout tracks the full-size set
under ``.data/lines/`` (48 TRAIN and 16 VALID images).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.image  # noqa: F401 (registers the loaders)

DATA_DIR = os.path.join(root.common.dirs.datasets, "lines")

root.lines.update({
    "loss_function": "softmax",
    "loader_name": "full_batch_auto_label_file_image",
    "mcdnnic_topology": "12x256x256-32C4-MP2-64C4-MP3-32N-4N",
    "mcdnnic_parameters": {"<-": {"learning_rate": 0.01}},
    "decision": {"fail_iterations": 100,
                 "max_epochs": int(numpy.iinfo(numpy.uint32).max)},
    "snapshotter": {"prefix": "lines", "interval": 1, "time_interval": 0,
                    "compression": ""},
    "loader": {"minibatch_size": 12,
               "normalization_type": "mean_disp",
               "train_paths": [os.path.join(DATA_DIR, "learn")],
               "validation_paths": [os.path.join(DATA_DIR, "test")]},
})

CLASSES = ("horizontal", "vertical", "diag_down", "diag_up")


def _draw_line(size, clazz, offset, thickness, rng):
    """One ``size`` x ``size`` uint8 drawing of orientation ``clazz``
    with gaussian noise."""
    img = numpy.zeros((size, size), dtype=numpy.uint8)
    idx = numpy.arange(size)
    if clazz == 0:      # horizontal
        img[max(0, offset):offset + thickness, :] = 255
    elif clazz == 1:    # vertical
        img[:, max(0, offset):offset + thickness] = 255
    elif clazz == 2:    # diagonal down
        for t in range(thickness):
            d = numpy.clip(idx + offset - size // 2 + t, 0, size - 1)
            img[idx, d] = 255
    else:               # diagonal up
        for t in range(thickness):
            d = numpy.clip(size - 1 - idx + offset - size // 2 + t,
                           0, size - 1)
            img[idx, d] = 255
    noise = rng.normal(0, 20, img.shape)
    return numpy.clip(img.astype(numpy.float64) + noise,
                      0, 255).astype(numpy.uint8)


def materialize_synthetic(data_dir=None, size=256, per_class=12,
                          seed=0x11E5):
    """The synthetic set under ``data_dir`` (unless its ``learn``
    directory exists): ``learn/<class>/NNN.png``, ``per_class`` a
    class, and ``test/<class>/NNN.png``, a third as many (at least
    2).  Returns the directory."""
    from PIL import Image
    data_dir = data_dir or DATA_DIR
    if os.path.isdir(os.path.join(data_dir, "learn")):
        return data_dir
    rng = numpy.random.RandomState(seed)
    for split, n in (("learn", per_class), ("test", max(2, per_class // 3))):
        for c, label in enumerate(CLASSES):
            cls_dir = os.path.join(data_dir, split, label)
            os.makedirs(cls_dir, exist_ok=True)
            for i in range(n):
                img = _draw_line(size, c, rng.randint(2, size - 6),
                                 rng.randint(2, 6), rng)
                Image.fromarray(img).save(
                    os.path.join(cls_dir, "%03d.png" % i))
    return data_dir


class LinesWorkflow(StandardWorkflow):
    """The Lines workflow (``StandardWorkflow`` from an mcdnnic
    topology)."""


def build(loader_config=None, decision_config=None, mcdnnic_topology=None,
          mcdnnic_parameters=None, snapshotter_config=None, **kwargs):
    """A :class:`LinesWorkflow` from ``root.lines``, with the given
    config merged over it; the synthetic set, at the topology's image
    size, is written beside the first of ``train_paths`` if none of
    them is a directory."""
    cfg = root.lines
    topology = mcdnnic_topology or cfg.mcdnnic_topology
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    train_paths = loader_cfg.get("train_paths") or []
    if not any(os.path.isdir(p) for p in train_paths):
        base = os.path.dirname(train_paths[0]) if train_paths else None
        size = int(topology.split("-")[0].split("x")[1])
        materialize_synthetic(base, size=size)
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return LinesWorkflow(
        mcdnnic_topology=topology,
        mcdnnic_parameters=(mcdnnic_parameters if mcdnnic_parameters
                            is not None
                            else cfg.mcdnnic_parameters.as_dict()),
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
    """The launcher contract (``python -m znicz_tpu_torch lines``)."""
    load(build)
    main()
