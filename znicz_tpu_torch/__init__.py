"""znicz_tpu_torch — the PyTorch/CUDA port of znicz_tpu.

The package mirrors ``znicz_tpu``'s module names so each module's
counterpart is easy to find, keeps its public layouts (NHWC
activations, conv weights ``(K, ky*kx*C)``, padding ``(left, top,
right, bottom)``, sliding ``(x, y)``, FC weights ``(out, in)``), and
imports neither ``jax`` nor anything of ``znicz_tpu``.

Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (:func:`znicz_tpu_torch.core.backends.default_device`).
The hand-written Hopper kernels are max pooling with winner offsets
(:mod:`znicz_tpu_torch.ops.cuda_pooling`) and its backward
(:mod:`znicz_tpu_torch.ops.cuda_pooling_backward`).
"""

from znicz_tpu_torch.core.backends import default_device  # noqa: F401

__all__ = ["default_device"]
