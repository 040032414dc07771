"""Host parameters <-> the port's device tensors.

The JAX engine keeps each loaded model's host parameters as
``_Model.host_params``: a list with one ``{attribute: ndarray}`` per
manifest layer.  :func:`params_from_numpy` turns such a list into
tensors on ``device``, in the layout the port computes with:

* conv weights stay ``(K, ky*kx*C)`` (:func:`znicz_tpu_torch.ops.conv.
  forward` views them as ``channels_last`` OIHW at no cost);
* FC weights become ``(out, in)`` — a ``weights_transposed`` layer is
  transposed once here, so the forward never transposes per call;
* conv weights of a ``weights_transposed`` layer are transposed back to
  ``(K, ky*kx*C)`` once here as well;
* floating arrays are float32, the one serving dtype of the port.

:func:`unit_params_from_numpy` and :func:`unit_params_to_numpy` carry
the unit graph's forward weights between host arrays and its forward
units, layer by layer; a unit whose weights are another's (an
autoencoder's deconv, which applies its conv's) has no pair of its own,
and neither has a unit that links the next layer's weights
(``LINKS_NEXT_WEIGHTS``: a ``zero_filter``, which comes before the
layer whose weights it masks).

:func:`train_state_from_numpy` and :func:`train_state_to_numpy` carry
a fused trainer's state (parameters, optimizer slots, hypers) between
host arrays — the JAX package's ``FusedNet.state_dict()`` among them —
and the port's device tensors, in the fused path's layout, unchanged.

The ``*_params_from_numpy`` / ``*_params_to_numpy`` pairs carry the
state of the families outside the layer graph, in the JAX package's
layouts: a Kohonen trainer's ``weights`` (``(neurons,
sample_length)``), an RBM's ``weights``, ``hbias`` and ``vbias``, and
the four gates' ``{"w", "b"}`` of an ``LSTMScan`` or a unit-graph
``LSTM`` cell (``w`` ``(hidden, in + hidden)``).
"""

import numpy
import torch


def params_from_numpy(layers, host_params, device):
    """``[{attribute: tensor}]`` on ``device``, one dict per layer."""
    out = []
    for entry, arrays in zip(layers, host_params):
        p = {}
        for attr, value in arrays.items():
            value = numpy.asarray(value)
            if attr == "weights" and entry.get("weights_transposed"):
                value = value.T
            if numpy.issubdtype(value.dtype, numpy.floating):
                value = value.astype(numpy.float32, copy=False)
            p[attr] = torch.from_numpy(
                numpy.ascontiguousarray(value)).to(device)
        out.append(p)
    return out


def unit_params_from_numpy(forwards, host_params):
    """Set each forward unit's ``weights`` / ``bias`` Arrays from
    ``host_params``, one ``(weights, bias)`` pair of host arrays per
    forward, in layer order, in the JAX package's layout (which is the
    unit graph's); a pair of None, or a None in it, leaves that Array
    as it is.  The arrays take the unit's dtype and upload at the next
    use."""
    seen = set()
    for unit, pair in zip(forwards, host_params):
        w = getattr(unit, "weights", None)
        if getattr(unit, "LINKS_NEXT_WEIGHTS", False):
            if pair is not None:
                raise ValueError("%s links the next layer's weights: its "
                                 "pair must be None" % unit.name)
            continue
        if w is not None and id(w) in seen:
            if pair is not None:
                raise ValueError("%s shares its weights with an earlier "
                                 "layer: its pair must be None" % unit.name)
            continue
        seen.add(id(w))
        if pair is not None:
            unit.apply_params(*pair)


def unit_params_to_numpy(forwards):
    """The inverse of :func:`unit_params_from_numpy`: one ``(weights,
    bias)`` pair of host arrays per forward unit (None where it has no
    weights, shares an earlier unit's or links the next one's, and for a
    missing bias)."""
    out, seen = [], set()
    for unit in forwards:
        if getattr(unit, "LINKS_NEXT_WEIGHTS", False):
            out.append(None)
            continue
        w, b = getattr(unit, "weights", None), getattr(unit, "bias", None)
        out.append(None if not w or id(w) in seen else (
            numpy.array(w.mem), numpy.array(b.mem) if b else None))
        seen.add(id(w))
    return out


def tree_map(fn, tree):
    """``fn`` of every leaf of a pytree of dicts, lists and tuples (both
    sequences come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def train_state_from_numpy(sd, device, dtype=None):
    """``(params, opt, hypers)`` on ``device`` from a training state of
    host arrays: a JAX ``FusedNet.state_dict()`` or any dict with
    ``"params"`` and ``"opt"`` (and optionally ``"hypers"``) in the
    fused layout — ``[{"w", "b"}]`` per spec, FC weights ``(out, in)``,
    conv weights ``(K, ky*kx*C)``, ``[{"w": {slot: array}, ...}]`` for
    the optimizer.  Floating arrays become ``dtype`` (their own when
    None); hypers become python floats, or None when absent."""
    def put(v):
        t = torch.from_numpy(numpy.array(v))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    hypers = sd.get("hypers")
    return (tree_map(put, sd["params"]), tree_map(put, sd["opt"]),
            None if hypers is None else tree_map(float, hypers))


def train_state_to_numpy(params, opt, hypers=None):
    """The inverse of :func:`train_state_from_numpy`: ``{"params",
    "opt", "hypers"}`` of host numpy arrays (hypers as floats)."""
    def get(t):
        return t.detach().cpu().numpy()
    return {"params": tree_map(get, params), "opt": tree_map(get, opt),
            "hypers": None if hypers is None else tree_map(float, hypers)}


def _set(arr, value):
    """Host ``value`` into Array ``arr`` in its dtype (uploaded at the
    next use; the Array object, and so every link to it, stays)."""
    arr.reset(numpy.array(value, dtype=arr.dtype))


def kohonen_params_from_numpy(trainer, weights):
    """Set a ``KohonenTrainer``'s ``(neurons, sample_length)`` weights
    from a host array (JAX's ``trainer.weights.mem``)."""
    _set(trainer.weights, weights)


def kohonen_params_to_numpy(trainer):
    """A host copy of a ``KohonenTrainer``'s weights."""
    return numpy.array(trainer.weights.mem)


def _rbm_arrays(rbm):
    """``(weights, hbias, vbias)`` Arrays of an RBM: a workflow with a
    ``hidden`` layer and ``vbias`` (``MnistRBMWorkflow``), or a unit
    with the three attributes (``GradientRBM``)."""
    if hasattr(rbm, "hidden"):
        return rbm.hidden.weights, rbm.hidden.bias, rbm.vbias
    return rbm.weights, rbm.hbias, rbm.vbias


def rbm_params_from_numpy(rbm, params):
    """Set an RBM's ``weights`` (``(hidden, visible)``), ``hbias`` and
    ``vbias`` from host arrays (``{"weights", "hbias", "vbias"}``)."""
    for arr, key in zip(_rbm_arrays(rbm), ("weights", "hbias", "vbias")):
        _set(arr, params[key])


def rbm_params_to_numpy(rbm):
    """The inverse of :func:`rbm_params_from_numpy`."""
    return {key: numpy.array(arr.mem) for arr, key in zip(
        _rbm_arrays(rbm), ("weights", "hbias", "vbias"))}


def _gate_arrays(lstm):
    """``{gate: {"w": Array, "b": Array}}`` of an ``LSTMScan`` or of a
    unit-graph ``LSTM`` cell (its gate units' weights and bias)."""
    if getattr(lstm, "gate_arrays", None):
        return lstm.gate_arrays
    from znicz_tpu_torch.ops.recurrent import GATES
    return {name: {"w": getattr(lstm, name).weights,
                   "b": getattr(lstm, name).bias} for name in GATES}


def lstm_params_from_numpy(lstm, params):
    """Set the four gates' ``{"w": (hidden, in + hidden), "b":
    (hidden,)}`` of an ``LSTMScan`` or a unit-graph ``LSTM`` from host
    arrays (JAX's ``gate_state`` or ``recurrent.params_from_cell``)."""
    for name, arrays in _gate_arrays(lstm).items():
        for key in ("w", "b"):
            _set(arrays[key], params[name][key])


def lstm_params_to_numpy(lstm):
    """The inverse of :func:`lstm_params_from_numpy`."""
    return {name: {key: numpy.array(arr.mem) for key, arr in arrays.items()}
            for name, arrays in _gate_arrays(lstm).items()}
