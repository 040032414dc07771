"""Shell — an interactive console between epochs.

Counterpart of ``znicz_tpu/core/interaction.py``: the unit opens a
console (IPython's where it imports, else the standard library's
``code``) with the workflow in scope, only when it is enabled (its
``enabled`` keyword or ``root.common.interactive``) AND standard input
is a terminal, so a run without one is never blocked.
"""

import sys

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.units import Unit


class Shell(Unit):
    """Opens an interactive console with the workflow in scope.

    The banner documents the conventional locals: ``workflow``, ``unit``
    (this shell), and ``root`` (the config tree)."""

    def __init__(self, workflow, **kwargs):
        super(Shell, self).__init__(workflow, **kwargs)
        self.enabled = kwargs.get("enabled", None)
        self.interactions = 0

    @property
    def should_interact(self):
        enabled = self.enabled
        if enabled is None:
            # .get: an attribute read would make an empty (truthy) node
            enabled = bool(root.common.get("interactive", False))
        return enabled and sys.stdin is not None and \
            hasattr(sys.stdin, "isatty") and sys.stdin.isatty()

    def run(self):
        if not self.should_interact:
            self.debug("non-interactive, skipping shell")
            return
        self.interactions += 1
        banner = ("znicz_tpu_torch shell — locals: workflow, unit, root. "
                  "Ctrl-D to continue the workflow.")
        local = {"workflow": self.workflow, "unit": self, "root": root}
        try:
            import IPython
            IPython.embed(banner1=banner, user_ns=local)
        except ImportError:
            import code
            code.interact(banner=banner, local=local)
