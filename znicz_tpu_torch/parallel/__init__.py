"""The fused trainer of the port (counterpart of ``znicz_tpu.parallel``,
single device)."""

from znicz_tpu_torch.parallel.fused import (  # noqa: F401 (re-exports)
    FusedMLP, FusedNet, flops_per_image)

__all__ = ["FusedMLP", "FusedNet", "flops_per_image"]
