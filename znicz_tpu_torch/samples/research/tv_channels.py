"""TvChannels — TV channel logos (``python -m znicz_tpu_torch
research.tv_channels``).

Counterpart of ``znicz_tpu/samples/research/tv_channels.py``:
``root.channels`` (one directory of frames a channel, labelled by the
directory's name through ``full_batch_auto_label_file_image``, VALID
carved out of TRAIN at ``validation_ratio`` 0.15, ``mean_disp``
normalization, all2all_tanh 100 -> softmax with the label count's
width, minibatch 30; a published 0.74% validation error),
:func:`materialize_synthetic`, :class:`ChannelsWorkflow`,
:func:`build`, :func:`run_sample` and :func:`run`, the launcher
contract.  Where ``train_paths`` hold no image, :func:`build` writes
the JAX package's synthetic logos there (the same PNGs from the same
seed; PIL is imported only to write and read them).
"""

import os

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.image  # noqa: F401 (registers the loaders)

DATA_DIR = os.path.join(root.common.dirs.datasets, "channels_train")
N_CHANNELS = 6

root.channels.update({
    "decision": {"fail_iterations": 50, "max_epochs": 1000},
    "loss_function": "softmax",
    "snapshotter": {"prefix": "channels", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loader_name": "full_batch_auto_label_file_image",
    "loader": {"minibatch_size": 30, "validation_ratio": 0.15,
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


def materialize_synthetic(data_dir=None, per_class=30, size=32,
                          seed=0x7C11):
    """Synthetic logos in ``data_dir`` (unless it holds files): each
    channel's glyph (a square, a disc or bars, plain or inverted) in a
    fixed corner of noisy frames; one directory of PNGs a channel.
    Returns the directory."""
    from PIL import Image
    data_dir = data_dir or DATA_DIR
    if os.path.isdir(data_dir) and os.listdir(data_dir):
        return data_dir
    r = numpy.random.RandomState(seed)
    for c in range(N_CHANNELS):
        class_dir = os.path.join(data_dir, "channel%02d" % c)
        os.makedirs(class_dir, exist_ok=True)
        gx = (c % 2) * (size - 10)    # the logo's corner
        gy = (c // 2 % 2) * (size - 10)
        for i in range(per_class):
            img = r.uniform(0, 0.3, (size, size))   # the programme
            logo = numpy.zeros((10, 10))
            if c % 3 == 0:
                logo[2:8, 2:8] = 1.0
            elif c % 3 == 1:
                yy, xx = numpy.mgrid[0:10, 0:10]
                logo[((xx - 5) ** 2 + (yy - 5) ** 2) < 12] = 1.0
            else:
                logo[::2, :] = 1.0
            if c >= 3:
                logo = 1.0 - logo
            img[gy:gy + 10, gx:gx + 10] = 0.7 * logo + 0.3
            img = (255 * numpy.clip(img, 0, 1)).astype(numpy.uint8)
            Image.fromarray(img).save(
                os.path.join(class_dir, "frame%03d.png" % i))
    return data_dir


class ChannelsWorkflow(StandardWorkflow):
    """The TvChannels workflow (``StandardWorkflow``)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`ChannelsWorkflow` from ``root.channels``, with the
    given config dicts merged over it; the synthetic set is written
    into the first of ``train_paths`` if none of them holds a file."""
    cfg = root.channels
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
    return ChannelsWorkflow(
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
    research.tv_channels``)."""
    load(build)
    main()
