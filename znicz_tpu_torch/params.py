"""Host parameters -> the port's device tensors.

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
