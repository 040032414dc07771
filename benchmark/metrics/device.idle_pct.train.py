"""The share of the traced training segment in which no kernel, copy or
memset ran on the card."""


def read(ctx):
    tr = ctx.layer.get("trace")
    if ctx.layer.get("kind") != "train" or tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
