"""Self-constructing workflow base — the graph from a declarative config.

Counterpart of ``znicz_tpu/standard_workflow_base.py``:
``StandardWorkflowBase.__init__``, the loader registry plumbing
(``loader_name``), ``link_repeater`` and ``link_loader``.  A
``layers`` config is a list of dicts::

    {"type": "conv", "->": {forward kwargs}, "<-": {backward kwargs},
     other: shared kwargs}

The mcdnnic topology shorthand, preprocessing workflows and the
unit-at-a-time forward chain (``link_forwards``) are not in this slice
of the port (``ROADMAP.md``).
"""

from znicz_tpu_torch.loader.base import UserLoaderRegistry
from znicz_tpu_torch.units import nn_units


class StandardWorkflowBase(nn_units.NNWorkflow):
    """Builds a workflow from the ``layers`` and loader config."""

    def __init__(self, workflow=None, **kwargs):
        for key in ("mcdnnic_topology", "mcdnnic_parameters",
                    "preprocessing"):
            if kwargs.get(key):
                raise NotImplementedError(
                    "%s is not in this slice of the port (see ROADMAP.md)"
                    % key)
        super(StandardWorkflowBase, self).__init__(workflow, **kwargs)
        # fused execution mode: True or a config dict (see
        # StandardWorkflow.link_fused_trainer)
        fused_cfg = kwargs.get("fused", None)
        if fused_cfg is True:
            fused_cfg = {}
        elif fused_cfg is False:
            fused_cfg = None
        self.fused_config = fused_cfg
        self.fused_trainer = None
        layers = kwargs.get("layers")
        if not isinstance(layers, list) or not layers or \
                any(not isinstance(layer, dict) for layer in layers):
            raise ValueError("layers should be a non-empty list of dicts")
        self.layers = layers
        self.loader_config = dict(kwargs.get("loader_config") or {})
        #: the registered loader class's ``MAPPING`` name
        self.loader_name = kwargs.get("loader_name")

    # -- graph construction -------------------------------------------------
    def link_repeater(self, *parents):
        self.repeater.link_from(*parents)
        return self.repeater

    def link_loader(self, *parents):
        if self.loader_name is None:
            raise ValueError("no loader: pass loader_name=")
        self.loader = UserLoaderRegistry.get_factory(self.loader_name)(
            self, name="loader", **self.loader_config)
        self.loader.link_from(*parents)
        return self.loader
