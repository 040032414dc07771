"""Training in parallel: the fused trainer of the port and its
multi-process runtime (counterpart of ``znicz_tpu.parallel``).  A mesh
is a ``(data, model)`` grid of ``torch.distributed`` ranks
(:mod:`znicz_tpu_torch.parallel.mesh`); its collectives are explicit
calls, counted by the mesh."""

from znicz_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from znicz_tpu_torch.parallel.fused import (  # noqa: F401 (re-exports)
    FusedMLP, FusedNet, build_fc_specs, build_specs, flops_per_image)
from znicz_tpu_torch.parallel import multihost  # noqa: F401
from znicz_tpu_torch.parallel.sequence import (  # noqa: F401
    attention_reference, ring_attention)

__all__ = ["FusedMLP", "FusedNet", "attention_reference", "build_fc_specs",
           "build_specs", "flops_per_image", "make_mesh", "multihost",
           "ring_attention"]
