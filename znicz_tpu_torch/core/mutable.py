"""Mutable lazy booleans used as unit gates.

Counterpart of ``znicz_tpu/core/mutable.py`` (``Bool`` :14), pure
Python and unchanged:

* ``b <<= value`` assigns the underlying value in place, so every
  derived expression referencing ``b`` sees the change
  (``gd_skip <<= minibatch_class != TRAIN``);
* ``~b``, ``a | b``, ``a & b``, ``a ^ b`` build *lazy* derived Bools
  re-evaluated at each ``bool()``.
"""


class Bool(object):
    __slots__ = ("_value", "_expr", "name")

    def __init__(self, value=False, expr=None, name=None):
        self._value = bool(value)
        self._expr = expr
        self.name = name

    def __bool__(self):
        if self._expr is not None:
            return bool(self._expr())
        return self._value

    def __ilshift__(self, value):
        """In-place assignment: ``b <<= True`` / ``b <<= other_bool``."""
        if self._expr is not None:
            raise ValueError("Cannot assign to a derived Bool expression")
        self._value = bool(value)
        return self

    def __invert__(self):
        return Bool(expr=lambda: not bool(self))

    def __or__(self, other):
        return Bool(expr=lambda: bool(self) or bool(other))

    def __and__(self, other):
        return Bool(expr=lambda: bool(self) and bool(other))

    def __xor__(self, other):
        return Bool(expr=lambda: bool(self) != bool(other))

    def __repr__(self):
        kind = "expr" if self._expr is not None else "value"
        return "<Bool %s %s=%s>" % (self.name or "", kind, bool(self))
