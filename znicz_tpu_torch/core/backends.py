"""Device selection for the port.

Counterpart of ``znicz_tpu/core/backends.py``.  The rule is one
function: every entry point resolves its ``device`` argument through
:func:`default_device`, which picks the card and never falls back to
the CPU on its own — a run that asked for the GPU and silently got the
CPU would report CPU numbers under a GPU's name.

:func:`full_f32` and :func:`deterministic` set the card's numerics for
a run: full float32 products, and cuDNN's deterministic algorithms so
that a training run repeats bit for bit, as the JAX package's runs do
under XLA.  ``root.common.engine.deterministic`` (default True) is the
port's one knob for the nondeterministic algorithms; the JAX package
has no such knob, because XLA always repeats.
"""

import torch

from znicz_tpu_torch.core.config import root


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


def deterministic(device):
    """cuDNN's deterministic algorithms, and no benchmark-driven choice
    among them, on the card (``cudnn.deterministic = True``,
    ``cudnn.benchmark = False``) unless ``root.common.engine.
    deterministic`` is False, which lets cuDNN pick nondeterministic
    ones (``cudnn.deterministic = False``).  Returns whether the run is
    deterministic; nothing changes for a CPU device."""
    want = bool(root.common.engine.get("deterministic", True))
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = want
        if want:
            torch.backends.cudnn.benchmark = False
    return want
