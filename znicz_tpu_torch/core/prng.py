"""Seedable host random streams.

Counterpart of ``znicz_tpu/core/prng.py`` (``RandomGenerator``,
``get`` :124): named streams wrapping ``numpy.random.RandomState``,
used for weight init (``fill`` / ``fill_normal_real``), shuffling and
host draws.  Both packages draw with numpy, so the same seed gives
bit-equal draws in either.

The JAX package also mints ``jax.random`` keys from a stream
(``jax_key``); the port has no counterpart.  Device randomness (the
dropout masks) comes from a ``torch.Generator`` that the trainer seeds
itself and keeps in its state (``parallel/fused.py``).
"""

import numpy


class RandomGenerator(object):
    """One seedable random stream wrapping ``numpy.random.RandomState``."""

    def __init__(self, key=None):
        self.key = key
        self._state = numpy.random.RandomState()
        self._seed_arr = None
        self.seed(numpy.frombuffer(b"znicz-tpu-default-seed-0123456789ab",
                                   dtype=numpy.uint8))

    def seed(self, seed, dtype=None, count=None):
        """Seed from an int, an array, or a file path of raw ``dtype``
        values (``count`` of them, 1024 by default)."""
        if isinstance(seed, str):
            seed = numpy.fromfile(seed, dtype=dtype or numpy.int32,
                                  count=count or 1024)
        if isinstance(seed, (int, numpy.integer)):
            arr = numpy.asarray([seed], dtype=numpy.uint32)
        else:
            raw = numpy.ascontiguousarray(seed).tobytes()
            raw += b"\x00" * (-len(raw) % 4)
            arr = numpy.frombuffer(raw, dtype=numpy.uint32).copy()
        self._seed_arr = arr
        self._state.seed(arr)
        return self

    @property
    def state(self):
        return self._state

    def fill(self, arr, vle_min=-1.0, vle_max=1.0):
        """Uniform fill of a numpy array in place."""
        arr[...] = self._state.uniform(
            vle_min, vle_max, size=arr.shape).astype(arr.dtype)

    def fill_normal_real(self, arr, mean=0.0, stddev=1.0,
                         clip_to_sigma=None):
        vals = self._state.normal(mean, stddev, size=arr.shape)
        if clip_to_sigma is not None:
            vals = numpy.clip(vals, mean - clip_to_sigma * stddev,
                              mean + clip_to_sigma * stddev)
        arr[...] = vals.astype(arr.dtype)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._state.normal(loc, scale, size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._state.uniform(low, high, size)

    def randint(self, low, high=None, size=None, dtype=int):
        return self._state.randint(low, high, size).astype(dtype)

    def rand(self, *shape):
        return self._state.rand(*shape)

    def shuffle(self, arr):
        self._state.shuffle(arr)

    def permutation(self, n):
        return self._state.permutation(n)

    def choice(self, a, size=None, replace=True, p=None):
        return self._state.choice(a, size, replace, p)

    def get_state(self):
        """Resumable state: numpy's RandomState state and the seed."""
        return {"np": self._state.get_state(),
                "seed_arr": None if self._seed_arr is None
                else numpy.array(self._seed_arr)}

    def set_state(self, state):
        self._state.set_state(state["np"])
        self._seed_arr = state["seed_arr"]
        return self


_streams = {}


def get(key=1):
    """The process-global stream with the given key (default 1)."""
    rg = _streams.get(key)
    if rg is None:
        rg = _streams[key] = RandomGenerator(key)
    return rg



def states():
    """Every registered stream's state (a snapshot's payload)."""
    return {key: rg.get_state() for key, rg in _streams.items()}


def restore(state_map):
    """Restore the stream states :func:`states` captured."""
    for key, st in state_map.items():
        get(key).set_state(st)
