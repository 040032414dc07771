"""Data normalizers, fit ("analyzed") on the training set and applied
in place everywhere.

Counterpart of ``znicz_tpu/core/normalization.py`` (:30-105), cut to
the registry, the base and "none" / "linear" — what
``SyntheticImagenetLoader`` uses.  The other normalizers come with
their loaders (``ROADMAP.md``).
"""

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
        raise NotImplementedError(
            "normalization %r is not in this slice of the port (see "
            "ROADMAP.md); known: %s" % (name, sorted(_registry)))
    return cls(**kwargs)


class NormalizerBase(object):
    def __init__(self, **kwargs):
        self.state = {}

    def analyze(self, data):
        pass

    def normalize(self, data):
        raise NotImplementedError


@register("none")
class NoneNormalizer(NormalizerBase):
    def normalize(self, data):
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
