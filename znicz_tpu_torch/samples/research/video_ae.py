"""VideoAE — the fully-connected frame autoencoder
(``python -m znicz_tpu_torch research.video_ae``).

Counterpart of ``znicz_tpu/samples/research/video_ae.py``
(``root.video_ae``: ``all2all_tanh`` to a 9-unit bottleneck, then
``all2all_tanh`` back to the frame, its width set from the loader's
``targets_shape``; MSE against the input frames, learning rate 0.01,
minibatch 50).  :class:`VideoAELoader` draws the JAX package's
synthetic video: ``n_frames`` frames of two smooth blobs moving, one
orbiting and one bouncing, plus noise (``RandomState(0x51DE0)``);
``frame_shape`` is 18x32 by default, the published frames 90x160.
"""

import numpy

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import (FullBatchLoaderMSE, IFullBatchLoader,
                                         TEST, TRAIN, VALID)
from znicz_tpu_torch.standard_workflow import StandardWorkflow

FRAME = (18, 32)   # the published 90x160 scaled down


class VideoAELoader(FullBatchLoaderMSE, IFullBatchLoader):
    """Frames in, the same frames (flattened) as the targets; a fifth
    VALID, the rest TRAIN."""

    MAPPING = "video_ae_loader"

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super(VideoAELoader, self).__init__(workflow, **kwargs)
        self.n_frames = kwargs.get("n_frames", 120)
        self.frame_shape = tuple(kwargs.get("frame_shape", FRAME))

    def load_data(self):
        h, w = self.frame_shape
        r = numpy.random.RandomState(0x51DE0)
        t = numpy.arange(self.n_frames, dtype=numpy.float32)
        yy, xx = numpy.mgrid[0:h, 0:w].astype(numpy.float32)
        cx1 = w * (0.5 + 0.3 * numpy.cos(t / 9))
        cy1 = h * (0.5 + 0.3 * numpy.sin(t / 9))
        cx2 = w * (0.5 + 0.4 * numpy.sin(t / 5))
        cy2 = numpy.full_like(t, h * 0.5)
        frames = numpy.empty((self.n_frames, h, w), numpy.float32)
        for i in range(self.n_frames):
            frames[i] = (
                numpy.exp(-((xx - cx1[i]) ** 2 + (yy - cy1[i]) ** 2) /
                          (2 * (h / 6) ** 2)) +
                numpy.exp(-((xx - cx2[i]) ** 2 + (yy - cy2[i]) ** 2) /
                          (2 * (h / 8) ** 2)))
        frames += r.normal(0, 0.01, frames.shape).astype(numpy.float32)
        self.original_data.reset(frames)
        self.original_targets.reset(frames.reshape(self.n_frames, -1)
                                    .copy())
        n_valid = self.n_frames // 5
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = n_valid
        self.class_lengths[TRAIN] = self.n_frames - n_valid


root.video_ae.update({
    "decision": {"fail_iterations": 100, "max_epochs": 1000},
    "snapshotter": {"prefix": "video_ae", "interval": 1,
                    "time_interval": 0, "compression": ""},
    "loss_function": "mse",
    "loader_name": "video_ae_loader",
    "loader": {"minibatch_size": 50},
    "layers": [
        {"name": "bottleneck", "type": "all2all_tanh",
         "->": {"output_sample_shape": 9},
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}},
        {"name": "reconstruct", "type": "all2all_tanh",
         "->": {},   # the width comes from the loader's targets_shape
         "<-": {"learning_rate": 0.01, "weights_decay": 0.00005}}],
})


class VideoAEWorkflow(StandardWorkflow):
    """The frame autoencoder (``StandardWorkflow``, MSE)."""


def build(layers=None, loader_config=None, decision_config=None,
          snapshotter_config=None, **kwargs):
    """A :class:`VideoAEWorkflow` from ``root.video_ae``, with the given
    config dicts merged over it."""
    cfg = root.video_ae
    loader_cfg = cfg.loader.as_dict()
    loader_cfg.update(loader_config or {})
    decision_cfg = cfg.decision.as_dict()
    decision_cfg.update(decision_config or {})
    snap_cfg = cfg.snapshotter.as_dict()
    snap_cfg.update(snapshotter_config or {})
    kwargs.setdefault("loss_function", cfg.loss_function)
    return VideoAEWorkflow(
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
    research.video_ae``)."""
    load(build)
    main()
