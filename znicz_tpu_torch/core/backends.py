"""Device selection for the port.

Counterpart of ``znicz_tpu/core/backends.py``.  The rule is one
function: every entry point resolves its ``device`` argument through
:func:`default_device`, which picks the card and never falls back to
the CPU on its own — a run that asked for the GPU and silently got the
CPU would report CPU numbers under a GPU's name.
"""

import torch


def default_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card (``cuda``); any other value is taken as
    given (``"cpu"`` for the tests).  Raises ``RuntimeError`` when a
    CUDA device is wanted and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the "
            "CPU")
    return dev


def full_f32(device):
    """f32 products and convolutions in full f32 on the card, as the JAX
    package computes them (TF32 keeps about three digits)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
