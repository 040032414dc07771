"""The whole step's share of the card's float32 peak (TF32 off): the
model's FLOPs a trained image (3 x the forward less the first layer's
input gradient, products behind a grouping mask counted by the mask's
kept share) times the window's images, over the window's seconds."""

from harness import peaks


def read(ctx):
    w = ctx.layer.get("window", {})
    peak = peaks.peak(ctx.card, "f32")
    if ctx.layer.get("kind") != "train" or not w.get("seconds") or \
            peak is None:
        return None
    rate = ctx.layer["flops_per_sample"] * w["images"] / w["seconds"]
    return 100.0 * rate / peak
