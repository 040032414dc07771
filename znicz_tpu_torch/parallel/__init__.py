"""The fused trainer of the port (counterpart of ``znicz_tpu.parallel``,
single device)."""

from znicz_tpu_torch.parallel.fused import FusedNet, flops_per_image

__all__ = ["FusedNet", "flops_per_image"]
