"""The training driver: ``FusedNet.run_window_sliced`` over a dataset on
the device, re-ordered each epoch by ``set_epoch_perm``, as the fused
trainer of the workflow CLI drives it.

Traffic keys: ``batch``, ``window`` (steps a window), ``rows`` (the
dataset; a multiple of ``batch``), ``pipeline_depth`` (windows in
flight, bounded by events as the trainer bounds them), ``trace_seconds``
(the traced segment of a ``--trace 1`` run) and ``update_steps`` (the
steps whose update is timed after the window).

A window stops at its epoch's last step; the epoch's accumulator is
read back then and reset, once an epoch, as the trainer does.

Set-up builds one net, hands it the benchmark's weights and dataset,
and drives it through its first steps with the window's own call and
feed (rows that all differ): a one-step window, whose optimizer state
gives the first gradient, then a window of the traffic's own length,
so that every step index of a window is checked.  Each step's loss and
the parameters after them are read for the check right away; then the
warm-up runs the rest of the first epoch and the first window of the
second, and the same net goes on into the measured window.
"""

import collections
import gc
import time

from harness import compare, counts, inputs
from harness import layers as L
from harness import trace as T


def _ref_module():
    from reference import znicz_plain
    return znicz_plain


def masks(torch, items, device):
    """Each weighted layer's grouping mask (None without one), in the
    configuration's weight layout."""
    out = []
    for it in L.weighted(items):
        g = it["grouping"]
        if not g:
            out.append(None)
            continue
        rows, cols = it["weights"]
        k = torch.arange(rows, device=device)[:, None]
        c = torch.arange(cols, device=device)[None, :]
        out.append((k % g != c % g).float())
    return out


def _norms(torch, tensors):
    return [float(v) for v in
            torch.stack([t.float().norm() for t in tensors]).cpu()]


class Program:
    """The program's net, set up from the seed, with the window loop."""

    def __init__(self, ctx):
        torch = self.torch = ctx.torch
        from znicz_tpu_torch.parallel import fused
        self.fused = fused
        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.device = ctx.device
        self.seed = ctx.seed
        self.items = L.walk(cfg["layers"], cfg["input_sample_shape"])
        self.batch = int(tr["batch"])
        self.window = int(tr["window"])
        self.rows = int(tr["rows"])
        self.per_epoch = self.rows // self.batch
        self.depth = int(tr.get("pipeline_depth", 2))
        data, labels = inputs.make_images(torch, cfg, self.seed, self.rows,
                                          self.device)
        data_h = data.cpu().numpy()
        labels_h = labels.to(torch.int32).cpu().numpy()
        del data, labels
        self.weights = inputs.make_weights(torch, self.items, self.seed,
                                           self.device)
        ctx.phase("inputs")
        self.net = fused.FusedNet(
            cfg["layers"], tuple(cfg["input_sample_shape"]),
            dropout_seed=inputs.sub_seed(self.seed, inputs.DROPOUT),
            pool_impl=cfg.get("pool_impl"), device=self.device)
        state = self.net.device_state()
        mine = iter(self.weights)
        state["params"] = [dict(next(mine)) if "w" in p else p
                           for p in state["params"]]
        self.net.load_device_state(state)
        ctx.phase("net")
        self.net.set_dataset(data_h, labels_h)
        ctx.phase("dataset")
        self.sample = (data_h[:self.batch].copy(),
                       labels_h[:self.batch].copy())
        del data_h, labels_h, state
        self.epoch = 0
        self.pos = 0
        self._hypers = {}
        self.inflight = collections.deque()
        self.enqueue_s = 0.0

    # -- the loop -------------------------------------------------------
    def hypers(self, n):
        if n not in self._hypers:
            self._hypers[n] = self.fused.stack_hypers(self.net.hypers, n)
        return self._hypers[n]

    def run_window(self, limit):
        """One window of at most ``limit`` steps, ending at the epoch's
        last; returns ``(steps, stats)``."""
        net = self.net
        if self.pos == 0:
            net.set_epoch_perm(inputs.epoch_order(self.seed, self.epoch,
                                                  self.rows),
                               pad=self.batch)
        n = min(limit, self.per_epoch - self.pos)
        starts = [(self.pos + k) * self.batch for k in range(n)]
        t = time.perf_counter()
        stats = net.run_window_sliced(starts, self.batch, [self.batch] * n,
                                      self.hypers(n))
        self.enqueue_s += time.perf_counter() - t
        self.pos += n
        if self.pos == self.per_epoch:
            net.window_acc_host()
            net.reset_window_acc()
            self.pos = 0
            self.epoch += 1
            self.inflight.clear()
        elif self.device.type == "cuda":
            event = self.torch.cuda.Event()
            event.record()
            self.inflight.append(event)
            while self.inflight and self.inflight[0].query():
                self.inflight.popleft()
            while len(self.inflight) > self.depth:
                self.inflight.popleft().synchronize()
        return n, stats

    def run_for(self, seconds):
        """Windows until ``seconds`` have passed, then a synchronize:
        ``(steps, wall seconds)``."""
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n, _ = self.run_window(self.window)
            steps += n
        self.sync()
        return steps, time.perf_counter() - t0

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    # -- the first steps ---------------------------------------------------
    def first_steps(self):
        """A one-step window, then a window of the traffic's length; the
        readings the check compares: each step's loss, each leaf's
        first gradient as the optimizer got it (worked out from its
        state after the first step) and each leaf's change after all
        of them."""
        torch = self.torch
        hyp = [h for layer in self.ctx.config["layers"]
               for h in ([_ref_module().Plain._hyper(layer)]
                         if layer["type"] in L.CONV_TYPES + L.FC_TYPES
                         else [])]
        ms = masks(torch, self.items, self.device)
        w0 = [{"w": p["w"] if m is None else p["w"] * m, "b": p["b"]}
              for p, m in zip(self.weights, ms)]
        _, stats = self.run_window(1)
        losses = [stats["loss"]]
        opt = [s for s, p in zip(self.net.device_state()["opt"],
                                 self.net.params) if "w" in p]
        grads = []
        for st, p0, h in zip(opt, w0, hyp):
            for name in ("w", "b"):
                hy = h[name]
                g = -st[name]["vel"] / hy["lr"] - hy["wd"] * p0[name]
                if hy["ortho"]:
                    w = p0[name]
                    g = g - (w.sum(dim=0, keepdim=True) - w) * \
                        (hy["ortho"] / w.shape[0])
                grads.append(g)
        grad_norms = _norms(torch, grads)
        del opt, grads
        n, stats = self.run_window(self.window)
        if n != self.window:
            raise ValueError("an epoch of %d steps holds no first window "
                             "of %d after one step" % (self.per_epoch,
                                                       self.window))
        losses.append(stats["loss"])
        params = [p for p in self.net.params if "w" in p]
        change = [p[name] - p0[name] for p, p0 in zip(params, w0)
                  for name in ("w", "b")]
        change_norms = _norms(torch, change)
        del change, params, w0
        self.weights = None
        return {"losses": [float(v) for v in torch.cat(losses).cpu()],
                "grad_norms": grad_norms, "change_norms": change_norms}

    def warm_up(self):
        """The rest of the first epoch and the second's first window."""
        while self.pos:
            self.run_window(self.window)
        self.run_window(self.window)
        self.sync()

    def update_ms(self, steps):
        """Device ms of the update of ``steps`` ``FusedNet.step`` calls
        (CUDA events at its "backward" and "update" marks), the first
        left out."""
        torch = self.torch
        out = []
        for _ in range(steps + 1):
            marks = {}

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[name] = ev
            self.net.step(self.sample[0], self.sample[1], mark=mark)
            torch.cuda.synchronize()
            out.append(marks["backward"].elapsed_time(marks["update"]))
        return out[1:]

    def close(self):
        self.net = None
        self.inflight.clear()
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def reference_readings(torch, config, traffic, seed, device,
                       precision="f32", rows=None):
    """The reference's readings of the checked steps (one, then a
    window's), from inputs made again from the seed: the plain version
    in ``precision``, its loss over the first ``rows`` of each batch
    where given (a fault)."""
    ref_mod = _ref_module()
    items = L.walk(config["layers"], config["input_sample_shape"])
    batch, n = int(traffic["batch"]), int(traffic["rows"])
    data, labels = inputs.make_images(torch, config, seed, n, device)
    weights = inputs.make_weights(torch, items, seed, device)
    plain = ref_mod.Plain(config["layers"], config["input_sample_shape"],
                          weights, precision)
    del weights
    start = [p[k].clone() for p in plain.flat_params() for k in ("w", "b")]
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs.sub_seed(seed, inputs.DROPOUT))
    order = torch.as_tensor(inputs.epoch_order(seed, 0, n), device=device)
    losses, grad_norms = [], None
    for k in range(1 + int(traffic["window"])):
        idx = order[k * batch:(k + 1) * batch]
        loss, grads = plain.loss_and_grads(data[idx], labels[idx], gen,
                                           rows)
        losses.append(float(loss))
        if k == 0:
            grad_norms = _norms(torch, [g[name] for g in
                                        plain.flat_grads(grads)
                                        for name in ("w", "b")])
        plain.update(grads)
    del data, labels
    end = [p[k] for p in plain.flat_params() for k in ("w", "b")]
    change_norms = _norms(torch, [e - s for e, s in zip(end, start)])
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms}


def run(ctx):
    """One run: set-up, the window, the traced segment where asked,
    the check.  Returns the driver's result dict."""
    torch = ctx.torch
    prog = Program(ctx)
    readings = prog.first_steps()
    ctx.phase("first steps")
    prog.warm_up()
    ctx.mark_setup_done()
    enqueue0 = prog.enqueue_s
    steps, wall = prog.run_for(ctx.seconds)
    window = {"steps": steps, "seconds": wall,
              "images": steps * prog.batch,
              "enqueue_s": prog.enqueue_s - enqueue0}
    peak = ctx.memory_peak()
    extra = {}
    if ctx.trace:
        extra["update_ms"] = prog.update_ms(int(ctx.traffic.get(
            "update_steps", 5)))
        (t_steps, _), tr = T.traced(torch, lambda: prog.run_for(
            float(ctx.traffic.get("trace_seconds", 3))))
        extra["trace"] = tr
        extra["pool_bytes"] = t_steps * counts.pool_bytes(
            prog.items, prog.batch, backward=True)
    items, batch = prog.items, prog.batch
    prog.close()
    del prog
    ref = reference_readings(torch, ctx.config, ctx.traffic, ctx.seed,
                             ctx.device)
    numbers = compare.train_numbers(readings, ref)
    return {
        "attempted": steps, "failed": 0, "numbers": numbers,
        "memory_peak": peak,
        "end_to_end": {"train_images_per_s": window["images"] / wall},
        "layer": dict(extra, kind="train", window=window,
                      flops_per_sample=counts.train_flops(items),
                      batch=batch),
    }
