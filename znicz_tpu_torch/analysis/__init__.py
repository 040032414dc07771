"""The analysis layer: the port's project invariants, checked.

Counterpart of ``znicz_tpu/analysis/``, two halves sharing the knob
registry of :mod:`znicz_tpu_torch.core.config`:

* :mod:`znicz_tpu_torch.analysis.graftlint` — stdlib-``ast`` checkers
  for the invariants the port otherwise enforces only at run time
  (config-knob vocabulary, telemetry series and label discipline,
  lock-guard discipline, host syncs and host RNG in the declared
  device bodies, gate order, thread names) and the style checks,
  driven by ``tools/graftlint_torch.py``;
* :mod:`znicz_tpu_torch.analysis.locksmith` — the opt-in runtime
  lock-order sanitizer the threaded modules make their locks through;
  armed, it records the acquisition-order graph, finds ABBA cycles and
  blocking calls under a held lock, and reports the stacks.  Off (the
  default), its factories hand out plain ``threading`` primitives
  after ONE config predicate.

Neither module imports torch itself: both read only the port's
``core/config.py`` (the package's ``__init__`` is what brings torch
in).
"""
