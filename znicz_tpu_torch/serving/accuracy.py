"""Accuracy deltas of the serving dtypes, per shape bucket.

Counterpart of ``znicz_tpu/serving/accuracy.py`` (``TOLERANCES``,
``dtype_delta_report`` :91, ``check`` :148), with the JAX package's
pins unchanged.  The same evaluation rows go through an f32 engine and
one engine per low-precision dtype, bucket by bucket (the dispatches
that serve traffic, padding included), and each bucket reports

* ``max_delta`` / ``mean_delta`` — the elementwise deviation from the
  f32 replies (model outputs here are O(1): softmax probabilities or
  bounded activations);
* ``flip_rate`` — the share of rows whose top-1 class changed (for
  outputs at least 2 wide).
"""

import numpy

from znicz_tpu_torch.serving import quant
from znicz_tpu_torch.serving.engine import InferenceEngine

#: the per-dtype pins: ``max_delta`` on |y - y_f32|, ``flip_rate`` on
#: the top-1 disagreement.  f32-fast computes the same f32 products over
#: weights laid out once, so its pin is a few ulps, not a budget
TOLERANCES = {
    "f32_fast": {"max_delta": 1e-5, "flip_rate": 0.01},
    "bf16": {"max_delta": 0.08, "flip_rate": 0.05},
    "int8": {"max_delta": 0.15, "flip_rate": 0.08},
}


def _rows_for(engine, rows, n_rows, seed):
    """The evaluation rows: the caller's, or ``n_rows`` seeded uniform
    samples of the model's recorded sample shape."""
    if rows is not None:
        x = numpy.asarray(rows, dtype=numpy.float32)
        if x.shape[1:] != tuple(engine.sample_shape or x.shape[1:]):
            raise ValueError("eval rows of per-sample shape %s do not match "
                             "the model's %s"
                             % (x.shape[1:], engine.sample_shape))
        return x
    if engine.sample_shape is None:
        raise ValueError("model records no sample shape — pass rows=")
    return numpy.random.RandomState(seed).uniform(
        -1.0, 1.0, (n_rows,) + tuple(engine.sample_shape)).astype(
            numpy.float32)


def _bucket_rows(x, bucket):
    """Exactly ``bucket`` rows, cycling the rows when there are fewer."""
    if len(x) >= bucket:
        return x[:bucket]
    return numpy.concatenate([x] * -(-bucket // len(x)), axis=0)[:bucket]


def _delta_stats(y_ref, y):
    d = numpy.abs(numpy.asarray(y, numpy.float64)
                  - numpy.asarray(y_ref, numpy.float64))
    out = {"max_delta": float(d.max()) if d.size else 0.0,
           "mean_delta": float(d.mean()) if d.size else 0.0,
           "flip_rate": None}
    if y_ref.ndim >= 2 and y_ref.shape[-1] >= 2:
        flips = numpy.argmax(y_ref.reshape(len(y_ref), -1), axis=1) != \
            numpy.argmax(numpy.asarray(y).reshape(len(y), -1), axis=1)
        out["flip_rate"] = float(numpy.mean(flips))
    return out


def dtype_delta_report(source, rows=None, dtypes=("bf16", "int8"),
                       n_rows=64, seed=0, tolerances=None,
                       **engine_kwargs):
    """The same rows through f32 and each dtype of ``dtypes``, bucket by
    bucket, against :data:`TOLERANCES` (``tolerances`` overrides
    entries).  ``source`` is anything the engine loads;
    ``engine_kwargs`` (``max_batch=``, ``buckets=``, ``device=``, ...)
    go to every engine, which is built without warmup.  Returns a
    JSON-able dict whose ``ok`` is True when every dtype is within its
    pin."""
    tolerances = dict(TOLERANCES, **(tolerances or {}))
    engine_kwargs = dict(engine_kwargs, warmup=False)
    ref = InferenceEngine(source, dtype="f32", **engine_kwargs)
    x = _rows_for(ref, rows, n_rows, seed)
    buckets = tuple(ref.buckets)
    per_bucket_ref = {b: ref.predict(_bucket_rows(x, b)) for b in buckets}
    del ref
    report = {"buckets": list(buckets), "rows": int(len(x)),
              "reference": "f32", "dtypes": {}, "ok": True}
    for dt in dtypes:
        dt = quant.normalize_dtype(dt)
        if dt == "f32":
            raise ValueError("f32 is the reference — compare "
                             "f32_fast/bf16/int8")
        engine = InferenceEngine(source, dtype=dt, **engine_kwargs)
        per_bucket = {}
        worst = {"max_delta": 0.0, "mean_delta": 0.0, "flip_rate": 0.0}
        for b in buckets:
            stats = _delta_stats(per_bucket_ref[b],
                                 engine.predict(_bucket_rows(x, b)))
            per_bucket[str(b)] = stats
            for k in worst:
                if stats[k] is not None:
                    worst[k] = max(worst[k], stats[k])
        del engine
        tol = tolerances.get(dt, {})
        within = (worst["max_delta"] <= tol.get("max_delta", float("inf"))
                  and worst["flip_rate"] <= tol.get("flip_rate",
                                                    float("inf")))
        report["dtypes"][dt] = dict(worst, per_bucket=per_bucket,
                                    tolerance=tol,
                                    within_tolerance=bool(within))
        report["ok"] = report["ok"] and within
    return report


def check(report):
    """``(ok, failures)`` of a :func:`dtype_delta_report`: each dtype
    outside its pin, with its numbers."""
    failures = []
    for dt, block in sorted(report.get("dtypes", {}).items()):
        if not block.get("within_tolerance"):
            tol = block.get("tolerance", {})
            failures.append(
                "%s: max_delta %.4g (tol %.4g), flip_rate %.4g (tol %.4g)"
                % (dt, block["max_delta"],
                   tol.get("max_delta", float("inf")), block["flip_rate"],
                   tol.get("flip_rate", float("inf"))))
    return not failures, failures
