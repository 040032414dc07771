"""The benchmark's own code: finding a cell's files, making its inputs
from the seed, driving the program's timed path, reading the trace, and
the arithmetic that turns shapes into operations and bytes.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package;
the program (``znicz_tpu_torch``) is imported only by the drivers, and
only inside the functions that run it.
"""
