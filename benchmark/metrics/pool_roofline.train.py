"""Max pooling's share of its roofline in the traced training segment:
the least bytes the pools of its steps move (each tensor once, a 4-byte
winner; forward and backward) at the card's HBM rate, over the device
time of every kernel that implements max pooling."""

import re

from harness import roofline

#: the kernels that implement max pooling: the port's two hand-written
#: kernels and ATen's max_pool2d forward and backward
POOL_KERNELS = re.compile(
    r"max_pooling_offsets|max_pooling_backward|max_pool_forward|"
    r"max_pool_backward", re.IGNORECASE)


def read(ctx):
    if ctx.layer.get("kind") != "train":
        return None
    return roofline.pool_share(ctx, POOL_KERNELS)
