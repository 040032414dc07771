"""Self-constructing workflow base — the graph from a declarative config.

Counterpart of ``znicz_tpu/standard_workflow_base.py``:
``StandardWorkflowBase.__init__`` with the layer-type registry
(``layer_map`` :34), the loader registry plumbing (``loader_name``),
``_get_layer_type_kwargs`` (:163-188), ``link_repeater``,
``link_loader``, ``link_forwards`` (:203-259, with the
``LINKS_NEXT_WEIGHTS`` hook :213-216 that hands a ``zero_filter`` the
next forward's weights) and ``_add_forward_unit`` (:261-284: a unit
takes its input from the last forward with an output, never from a
filler).  A ``layers`` config is a list of
dicts::

    {"type": "conv", "->": {forward kwargs}, "<-": {backward kwargs},
     other: shared kwargs}

Forward units come from the registry, named ``<name>_forward`` (or
``<type>_<index>_forward``, and their GD units ``gd_<name>`` or
``gd_<type>_<index>``: the names snapshots key on) and chained; the
softmax head's width comes from the loader's label count, an MSE
head's from the loader's ``targets_shape``.  The mcdnnic topology
shorthand and preprocessing workflows are not in this slice of the
port (``ROADMAP.md``).
"""

import numpy

from znicz_tpu_torch.loader.base import UserLoaderRegistry
from znicz_tpu_torch.units import nn_units
# importing the layer modules registers their type strings
from znicz_tpu_torch.units import (  # noqa: F401
    activation, all2all, conv, cutter, deconv, depooling, dropout, gd,
    gd_conv, gd_pooling, multiplier, normalization, pooling,
    resizable_all2all, rprop_gd, summator, zerofilling)
from znicz_tpu_torch.units.all2all import All2AllSoftmax
from znicz_tpu_torch.units.dropout import DropoutForward


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
        self.layer_map = nn_units.mapping
        # fused execution mode: True or a config dict (see
        # StandardWorkflow.link_fused_trainer); None: the unit graph
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

    # -- layer instantiation ------------------------------------------------
    def _get_layer_type_kwargs(self, layer, index=None):
        """Split one layer dict into (type, forward kwargs, backward
        kwargs)."""
        tpe = layer.get("type", "").strip()
        if not tpe:
            raise ValueError("layer type must not be an empty string")
        if tpe not in self.layer_map:
            raise ValueError("Unknown layer type %r" % tpe)
        kwargs_forward = dict(layer.get("->", {}))
        kwargs_backward = dict(layer.get("<-", {}))
        others = {k: v for k, v in layer.items()
                  if k not in ("type", "->", "<-", "name")}
        kwargs_forward.update(others)
        kwargs_backward.update(others)
        if "name" in layer:
            kwargs_forward["name"] = layer["name"] + "_forward"
            kwargs_backward["name"] = "gd_" + layer["name"]
        elif index is not None:
            # unnamed layers get index-unique names: duplicate types
            # would otherwise share one snapshot entry
            kwargs_forward.setdefault("name", "%s_%d_forward"
                                      % (tpe, index))
            kwargs_backward.setdefault("name", "gd_%s_%d" % (tpe, index))
        return tpe, kwargs_forward, kwargs_backward

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

    def link_forwards(self, init_attrs, *parents):
        """Create and chain the forward units; the softmax head's width
        is set from the loader's label count once it is initialized, a
        regression head's from the loader's target sample shape."""
        del self.forwards[:]
        for index, layer in enumerate(self.layers):
            tpe, kwargs, _ = self._get_layer_type_kwargs(layer, index)
            if not self.layer_map[tpe].has_forward:
                raise ValueError("no Forward registered for %r" % tpe)
            unit = self.layer_map[tpe].forward(self, **kwargs)
            self._add_forward_unit(unit, init_attrs, *parents)
        # a ZeroFiller masks the NEXT layer's weights
        for prev_fwd, fwd in zip(self.forwards, self.forwards[1:]):
            if getattr(prev_fwd, "LINKS_NEXT_WEIGHTS", False):
                prev_fwd.link_attrs(fwd, "weights")
        last_fwd = self.forwards[-1]
        if isinstance(last_fwd, All2AllSoftmax) and self.loader is not None:
            loader = self.loader

            def on_initialized():
                ulc = loader.unique_labels_count
                oss = last_fwd.output_sample_shape
                if oss != tuple() and numpy.prod(oss) != ulc:
                    self.warning(
                        "Overriding %s.output_sample_shape %s with (%d,)",
                        last_fwd.name, oss, ulc)
                else:
                    self.info("Setting %s.output_sample_shape to %d",
                              last_fwd.name, ulc)
                last_fwd.output_sample_shape = ulc

            loader.on_initialized = on_initialized
        elif (self.loader is not None and
              hasattr(self.loader, "minibatch_targets") and
              hasattr(last_fwd, "output_sample_shape")):
            loader = self.loader

            def on_initialized_mse():
                tshape = loader.targets_shape
                oss = last_fwd.output_sample_shape
                if oss != tuple() and tuple(numpy.ravel(oss)) != tshape \
                        and numpy.prod(oss) != numpy.prod(tshape):
                    self.warning(
                        "Overriding %s.output_sample_shape %s with %s "
                        "(loader targets)", last_fwd.name, oss, tshape)
                last_fwd.output_sample_shape = tshape

            loader.on_initialized = on_initialized_mse
        return last_fwd

    def _add_forward_unit(self, new_unit, init_attrs=None, *parents):
        """Link ``new_unit`` after the last forward (or ``parents``) and
        take its input from the last forward's output (or the first
        parent's ``init_attrs``)."""
        if self.forwards:
            prev = (self.forwards[-1],)
        else:
            if not parents:
                raise ValueError(
                    "No parent units were specified for the first forward!")
            prev = parents
        new_unit.link_from(*prev)
        if isinstance(new_unit, DropoutForward):
            new_unit.link_attrs(self.loader, "minibatch_class")
        self.forwards.append(new_unit)
        if "input" not in new_unit._demanded and \
                getattr(new_unit, "input", None) is None and \
                not new_unit.has_linked_attr("input"):
            return
        for fwd in reversed(self.forwards[:-1]):
            if getattr(fwd, "output", None) is not None:
                new_unit.link_attrs(fwd, ("input", "output"))
                break
        else:
            new_unit.link_attrs(parents[0], init_attrs)
