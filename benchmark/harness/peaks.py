"""Published peaks of the cards a run may land on (NVIDIA's data
sheets, dense rates without sparsity), by the name
``torch.cuda.get_device_name()`` gives.  ``f32`` is the rate outside the
tensor cores, which is what a float32 product runs at with TF32 off.
A card not listed has no peak here: the metrics that need one are left
out of the result, never reported against a guess."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "tf32": 495e12,
                              "bf16": 989e12, "hbm": 3.35e12},
    "NVIDIA H100 PCIe": {"f32": 51e12, "tf32": 378e12,
                         "bf16": 756e12, "hbm": 2.0e12},
}


def peak(kind, what):
    """The peak ``what`` ("f32", "tf32", "bf16" FLOP/s or "hbm" bytes/s)
    of the card named ``kind``, or None."""
    return PEAKS.get(kind, {}).get(what)
