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
softmax head's width comes from the loader's label count (a loader
that knows none, such as ``InteractiveLoader``, keeps the configured
width), an MSE head's from the loader's ``targets_shape``.

The mcdnnic topology shorthand (JAX :29-31, :97-161)::

    "12x256x256-32C4-MP2-64C4-MP3-32N-4N"

is minibatch x height x width, then ``<K>C<k>`` a linear ``conv`` of K
kernels k x k, ``MP<k>`` a ``max_pooling`` k x k with sliding k, and
``<n>N`` an ``all2all`` of n neurons, the last one a ``softmax``;
``mcdnnic_parameters`` ``{"->": {...}, "<-": {...}}`` go into every
layer's forward and backward kwargs, and the input part sets the
loader's ``minibatch_size`` and ``scale``.  The loader comes from
``loader_name`` (a registered ``MAPPING``, built with
``loader_config``) or ``loader_factory`` (a callable taking the
workflow; JAX :61-95).  ``create_workflow`` builds the forward-only
graph (JAX :286-303): the loader loops until its epoch ends or it
reports ``complete`` (an ``InteractiveLoader``'s drained queue), and
``run`` re-arms the loader's latched flags first, so a forward
workflow serves again after every feed.  ``preprocessing=True``
allows a workflow without layers (JAX :35, :110-113).
"""

import re

import numpy

from znicz_tpu_torch.core.config import Config
from znicz_tpu_torch.loader.base import UserLoaderRegistry
from znicz_tpu_torch.units import nn_units
# importing the layer modules registers their type strings (and the
# accumulators and the labels printer, as JAX's units/__init__.py does)
from znicz_tpu_torch.units import (  # noqa: F401
    accumulator, activation, all2all, conv, cutter, deconv, depooling,
    dropout, gd, gd_conv, gd_pooling, labels_printer, lstm, lstm_scan,
    multiplier, normalization, pooling, resizable_all2all, rprop_gd,
    summator, zerofilling)
from znicz_tpu_torch.units.all2all import All2AllSoftmax
from znicz_tpu_torch.units.dropout import DropoutForward


class StandardWorkflowBase(nn_units.NNWorkflow):
    """Builds a workflow from the ``layers`` (or mcdnnic) and loader
    config."""

    mcdnnic_layer_pattern = re.compile(
        r"(?P<C>\d+C\d+)|(?P<MP>MP\d+)|(?P<N>\d+N)")

    def __init__(self, workflow=None, **kwargs):
        super(StandardWorkflowBase, self).__init__(workflow, **kwargs)
        self.layer_map = nn_units.mapping
        self.preprocessing = kwargs.get("preprocessing", False)
        # fused execution mode: True or a config dict (see
        # StandardWorkflow.link_fused_trainer); None: the unit graph
        fused_cfg = kwargs.get("fused", None)
        if fused_cfg is True:
            fused_cfg = {}
        elif fused_cfg is False:
            fused_cfg = None
        self.fused_config = fused_cfg
        self.fused_trainer = None
        self.mcdnnic_topology = kwargs.get("mcdnnic_topology", None)
        self.mcdnnic_parameters = kwargs.get("mcdnnic_parameters", None)
        self.layers = kwargs.get("layers", [{}])
        self.loader_config = dict(self.dictify(
            kwargs.get("loader_config") or {}))
        self._loader_name = None
        self._loader_factory = None
        #: the loader the graph links (the softmax head's width hook)
        self.real_loader = None
        if kwargs.get("loader_name") is not None:
            self.loader_name = kwargs["loader_name"]
        elif kwargs.get("loader_factory") is not None:
            self.loader_factory = kwargs["loader_factory"]

    # -- config plumbing ----------------------------------------------------
    @staticmethod
    def dictify(obj):
        """A config node as a plain dict; anything else as it is."""
        return obj.as_dict() if isinstance(obj, Config) else obj

    def config2kwargs(self, unit_config):
        """A unit's config (a dict, a config node or None) as kwargs."""
        return {} if unit_config is None else dict(self.dictify(unit_config))

    @property
    def loader_name(self):
        """The registered loader class's ``MAPPING`` name (None when
        the loader comes from a factory)."""
        return self._loader_name

    @loader_name.setter
    def loader_name(self, value):
        if value is None:
            self._loader_name = None
            return
        kwargs = dict(self.loader_config)
        if self.mcdnnic_topology is not None:
            kwargs = self._update_loader_kwargs_from_mcdnnic(
                kwargs, self.mcdnnic_topology)
        kls = UserLoaderRegistry.get_factory(value)
        self._loader_factory = lambda wf: kls(wf, name="loader", **kwargs)
        self._loader_name = value

    @property
    def loader_factory(self):
        """A callable taking the workflow and returning its loader."""
        return self._loader_factory

    @loader_factory.setter
    def loader_factory(self, value):
        if not callable(value):
            raise TypeError("loader_factory must be callable")
        self._loader_name = None
        self._loader_factory = value

    # -- layers config ------------------------------------------------------
    @property
    def layers(self):
        if self.mcdnnic_topology is not None:
            return self._get_layers_from_mcdnnic(self.mcdnnic_topology)
        return self._layers

    @layers.setter
    def layers(self, value):
        if self.mcdnnic_topology is not None and value != [{}]:
            raise ValueError(
                "Do not set mcdnnic_topology and layers at the same time")
        if not isinstance(value, list) or \
                any(not isinstance(layer, dict) for layer in value):
            raise ValueError("layers should be a list of dicts")
        if (value in ([], [{}]) and self.mcdnnic_topology is None and
                not self.preprocessing):
            raise ValueError(
                "layers is empty and mcdnnic_topology is not defined")
        self._layers = value

    # -- the mcdnnic topology -----------------------------------------------
    def _get_mcdnnic_parameters(self, arrow):
        params = self.dictify(self.mcdnnic_parameters) or {}
        return dict(self.dictify(params.get(arrow, {})))

    @staticmethod
    def _parse_mcdnnic_c(is_last, value):
        kernels, kx = value.split("C")
        return {"type": "conv",
                "->": {"n_kernels": int(kernels), "kx": int(kx),
                       "ky": int(kx)}}

    @staticmethod
    def _parse_mcdnnic_mp(is_last, value):
        _, kx = value.split("MP")
        return {"type": "max_pooling", "->": {"kx": int(kx), "ky": int(kx)}}

    @staticmethod
    def _parse_mcdnnic_n(is_last, value):
        neurons, _ = value.split("N")
        tpe = "softmax" if is_last else "all2all"
        return {"type": tpe, "->": {"output_sample_shape": int(neurons)}}

    def _get_layers_from_mcdnnic(self, description):
        """The ``layers`` list an mcdnnic string describes, with
        ``mcdnnic_parameters`` in every layer."""
        layers = []
        fwd_params = self._get_mcdnnic_parameters("->")
        bwd_params = self._get_mcdnnic_parameters("<-")
        parse = {"C": self._parse_mcdnnic_c, "MP": self._parse_mcdnnic_mp,
                 "N": self._parse_mcdnnic_n}
        matches = tuple(re.finditer(self.mcdnnic_layer_pattern, description))
        for index, match in enumerate(matches):
            name = next(n for n, v in match.groupdict().items() if v)
            cfg = parse[name](index == len(matches) - 1, match.group(name))
            cfg["->"].update(fwd_params)
            cfg["<-"] = dict(bwd_params)
            layers.append(cfg)
        return layers

    @staticmethod
    def _update_loader_kwargs_from_mcdnnic(kwargs, description):
        """The input part ``BxHxW`` sets ``minibatch_size`` and
        ``scale``."""
        minibatch_size, y_size, x_size = description.split("-")[0].split("x")
        kwargs["minibatch_size"] = int(minibatch_size)
        kwargs["scale"] = (int(y_size), int(x_size))
        return kwargs

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
        if self.loader_factory is None:
            raise ValueError(
                "no loader: pass loader_name= or loader_factory=")
        self.loader = self.loader_factory(self)
        self.loader.link_from(*parents)
        self.real_loader = self.loader
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
        if isinstance(last_fwd, All2AllSoftmax) and \
                self.real_loader is not None:
            loader = self.real_loader

            def on_initialized():
                ulc = loader.unique_labels_count
                if not ulc:
                    # a loader that knows no labels (InteractiveLoader)
                    # keeps the configured width
                    return
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
        elif (self.real_loader is not None and
              hasattr(self.real_loader, "minibatch_targets") and
              hasattr(last_fwd, "output_sample_shape")):
            loader = self.real_loader

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

    def link_end_point(self, *parents):
        self.repeater.link_from(*parents)
        self.end_point.link_from(*parents)
        return self.end_point

    def create_workflow(self):
        """The forward-only graph: the loader loops until one epoch was
        served or it reports ``complete`` (an ``InteractiveLoader``'s
        drained queue)."""
        self.link_repeater(self.start_point)
        self.link_loader(self.repeater)
        self.link_forwards(("input", "minibatch_data"), self.loader)
        done = self.loader.complete | self.loader.epoch_ended
        self.link_end_point(self.forwards[-1])
        self.end_point.gate_block = ~done
        self.loader.gate_block = done

    def run(self):
        """Re-arm the loader's latched epoch flags before each run, so
        a forward workflow serves again: a latched ``epoch_ended`` would
        gate the loader off and a second run serve stale outputs."""
        loader = getattr(self, "loader", None)
        for attr in ("epoch_ended", "last_minibatch"):
            flag = getattr(loader, attr, None)
            if flag is not None and getattr(flag, "_expr", True) is None:
                flag <<= False
        return super(StandardWorkflowBase, self).run()
