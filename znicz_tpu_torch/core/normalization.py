"""Data normalizers, fit ("analyzed") on the training set and applied
in place everywhere.

Counterpart of ``znicz_tpu/core/normalization.py``: the registry and
the "none", "pointwise", "linear", "range_linear", "internal_mean" and
"mean_disp" normalizers, each with ``denormalize``.  The arithmetic is
the JAX module's numpy arithmetic, step for step, so the same rows
normalize to the same bits in either package; the loaders apply it on
the host, once.
"""

import numpy

_registry = {}


def register(name):
    def deco(cls):
        _registry[name] = cls
        cls.NAME = name
        return cls
    return deco


def create(name, **kwargs):
    try:
        cls = _registry[name]
    except KeyError:
        raise KeyError("Unknown normalization %r; known: %s"
                       % (name, sorted(_registry)))
    return cls(**kwargs)


class NormalizerBase(object):
    def __init__(self, **kwargs):
        self.state = {}

    def analyze(self, data):
        pass

    def normalize(self, data):
        raise NotImplementedError

    def denormalize(self, data):
        raise NotImplementedError


@register("none")
class NoneNormalizer(NormalizerBase):
    def normalize(self, data):
        return data

    def denormalize(self, data):
        return data


@register("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map of the training set's range onto [-1, 1]."""

    def analyze(self, data):
        mn = data.min(axis=0)
        mx = data.max(axis=0)
        span = mx - mn
        span[span == 0] = 1.0
        self.state = {"mul": 2.0 / span, "sub": mn, "span": span}

    def normalize(self, data):
        data -= self.state["sub"]
        data *= self.state["mul"]
        data -= 1.0
        return data

    def denormalize(self, data):
        data += 1.0
        data /= self.state["mul"]
        data += self.state["sub"]
        return data


@register("linear")
class LinearNormalizer(NormalizerBase):
    """Whole-tensor linear map of [min, max] onto ``interval``."""

    def __init__(self, interval=(-1, 1), **kwargs):
        super(LinearNormalizer, self).__init__(**kwargs)
        self.interval = interval

    def analyze(self, data):
        self.state = {"min": float(data.min()), "max": float(data.max())}

    def normalize(self, data):
        lo, hi = self.interval
        span = self.state["max"] - self.state["min"] or 1.0
        data -= self.state["min"]
        data *= (hi - lo) / span
        data += lo
        return data

    def denormalize(self, data):
        lo, hi = self.interval
        span = self.state["max"] - self.state["min"] or 1.0
        data -= lo
        data *= span / (hi - lo)
        data += self.state["min"]
        return data


@register("range_linear")
class RangeLinearNormalizer(LinearNormalizer):
    """"linear" under the name the reference's target normalizers use."""


@register("internal_mean")
class InternalMeanNormalizer(NormalizerBase):
    """Subtract the training set's mean sample (the CIFAR caffe
    config's normalization)."""

    def analyze(self, data):
        self.state = {"mean": data.mean(axis=0)}

    def normalize(self, data):
        data -= self.state["mean"].reshape(1, -1)
        return data

    def denormalize(self, data):
        data += self.state["mean"].reshape(1, -1)
        return data


@register("mean_disp")
class MeanDispNormalizer(NormalizerBase):
    """Subtract the per-feature mean and multiply by the reciprocal of
    the per-feature range; ``mean`` and ``rdisp`` given to the
    constructor are used as they are instead of being fit."""

    def __init__(self, mean=None, rdisp=None, **kwargs):
        super(MeanDispNormalizer, self).__init__(**kwargs)
        if mean is not None:
            self.state = {"mean": numpy.asarray(mean),
                          "rdisp": numpy.asarray(rdisp)}

    def analyze(self, data):
        if self.state:
            return
        mean = data.mean(axis=0)
        disp = data.max(axis=0) - data.min(axis=0)
        disp[disp == 0] = 1.0
        self.state = {"mean": mean, "rdisp": 1.0 / disp}

    def normalize(self, data):
        data -= self.state["mean"].reshape(1, -1)
        data *= self.state["rdisp"].reshape(1, -1)
        return data

    def denormalize(self, data):
        data /= self.state["rdisp"].reshape(1, -1)
        data += self.state["mean"].reshape(1, -1)
        return data
