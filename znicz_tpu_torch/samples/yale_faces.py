"""YaleFaces — face identification from cropped grayscale images
(``python -m znicz_tpu_torch yale_faces [--fused]``).

Counterpart of ``znicz_tpu/samples/yale_faces.py``: ``root.yalefaces``
(one directory of images a person, labelled by the directory's name
through ``full_batch_auto_label_file_image``, VALID carved out of
TRAIN at ``validation_ratio`` 0.15, ``mean_disp`` normalization,
all2all_tanh 100 -> softmax whose width is the number of people,
minibatch 40; a published 3.59% validation error),
:func:`materialize_synthetic`, :class:`YaleFacesWorkflow`,
:func:`build`, :func:`run_sample` and :func:`run`, the launcher
contract.  Where ``train_paths`` hold no image, :func:`build` writes
the JAX package's synthetic faces there (the same PGMs from the same
seed; PIL is imported only to write and read them).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.image  # noqa: F401 (registers the loaders)

DATA_DIR = os.path.join(root.common.dirs.datasets, "CroppedYale")

root.yalefaces.update({
    "decision": {"fail_iterations": 50, "max_epochs": 1000},
    "loss_function": "softmax",
    "loader_name": "full_batch_auto_label_file_image",
    "snapshotter": {"prefix": "yalefaces", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader": {"minibatch_size": 40, "validation_ratio": 0.15,
               "normalization_type": "mean_disp",
               "train_paths": [DATA_DIR]},
    "layers": [
        {"name": "fc_tanh1", "type": "all2all_tanh",
         "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}},
        {"name": "fc_softmax2", "type": "softmax",
         "->": {},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}}],
})


def materialize_synthetic(data_dir=None, n_people=8, per_person=20,
                          size=32, seed=0xFACE):
    """Synthetic faces in ``data_dir`` (unless it holds files): a
    smooth prototype a person under a random linear light gradient
    and noise; one directory of PGMs a person (the CroppedYale
    layout).  Returns the directory."""
    from PIL import Image
    data_dir = data_dir or DATA_DIR
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        return data_dir
    r = numpy.random.RandomState(seed)
    xx, yy = numpy.meshgrid(numpy.linspace(-1, 1, size),
                            numpy.linspace(-1, 1, size))
    for p in range(n_people):
        proto = numpy.zeros((size, size))
        for _ in range(5):   # a few gaussian blobs: the face's structure
            cx, cy = r.uniform(-0.7, 0.7, 2)
            s = r.uniform(0.1, 0.4)
            a = r.uniform(0.4, 1.0)
            proto += a * numpy.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) /
                                   (2 * s * s))
        person_dir = os.path.join(data_dir, "yaleB%02d" % (p + 1))
        os.makedirs(person_dir, exist_ok=True)
        for i in range(per_person):
            # the illumination: a linear gradient of random direction
            gx, gy = r.uniform(-0.5, 0.5, 2)
            img = proto * (1.0 + gx * xx + gy * yy)
            img = img + r.normal(0, 0.05, img.shape)
            img = (255 * (img - img.min()) /
                   max(img.max() - img.min(), 1e-6))
            Image.fromarray(img.astype(numpy.uint8)).save(
                os.path.join(person_dir, "P%02d_%02d.pgm" % (p, i)))
    return data_dir


class YaleFacesWorkflow(StandardWorkflow):
    """The YaleFaces workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`YaleFacesWorkflow` from ``root.yalefaces``, with the
    given config dicts merged over it; the synthetic set is written
    into the first of ``train_paths`` if none of them holds a file."""
    cfg = root.yalefaces
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
    return YaleFacesWorkflow(
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
    yale_faces``)."""
    load(build)
    main()
