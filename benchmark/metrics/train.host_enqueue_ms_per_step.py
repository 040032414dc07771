"""Host milliseconds inside ``FusedNet.run_window_sliced`` until it
returns, over the window's steps: what the host pays to enqueue a
step."""


def read(ctx):
    w = ctx.layer.get("window", {})
    if ctx.layer.get("kind") != "train" or not w.get("steps"):
        return None
    return 1e3 * w["enqueue_s"] / w["steps"]
