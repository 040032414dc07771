"""Convolutional forward units.

Counterpart of ``znicz_tpu/units/conv.py`` (``ConvolutionalBase``
:68, ``Conv`` and its variants :89-221).  Type strings: conv,
conv_tanh, conv_sigmoid, conv_relu, conv_str.  Layout NHWC, weights
``(n_kernels, ky*kx*n_channels)``, padding ``(left, top, right,
bottom)``, sliding ``(x, y)``; a 3-D ``(B, H, W)`` input is one
channel (:func:`~znicz_tpu_torch.units.nn_units.as_nhwc`).  The
product is :func:`znicz_tpu_torch.ops.conv.forward`.  The "gabor"
weight filling is the JAX package's (``gabor_kernel`` and
``fill_gabor_filters`` :15-55, the hook :151-152).
"""

import numpy

from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.units.nn_units import NNLayerBase, as_nhwc


def gabor_kernel(kx, ky, sigma, theta, lambd, gamma, psi):
    """A real Gabor kernel on a (ky, kx) grid: the formula of
    ``cv2.getGaborKernel``, computed directly."""
    ymax, xmax = ky // 2, kx // 2
    y, x = numpy.mgrid[-ymax:ky - ymax, -xmax:kx - xmax]
    xr = x * numpy.cos(theta) + y * numpy.sin(theta)
    yr = -x * numpy.sin(theta) + y * numpy.cos(theta)
    return (numpy.exp(-(xr ** 2 + (gamma * yr) ** 2) / (2.0 * sigma ** 2))
            * numpy.cos(2.0 * numpy.pi * xr / lambd + psi))


def fill_gabor_filters(w, kx, ky, n_channels, stddev, rand):
    """Fill ``(n_kernels, ky*kx*C)`` weights with the Gabor bank: 4
    orientations x 2 phase shifts over the wavelength / deviation
    ratios, 96 distinct filters, each normalized to [0, 255], scaled by
    ``stddev`` and repeated over the channels; kernels past the 96 get
    white noise from ``rand``."""
    n_kernels = w.shape[0]
    size = min(kx, ky)
    orientations = (0.0, numpy.pi / 4, numpy.pi / 2, 3 * numpy.pi / 4)
    phase_shifts = (0.0, numpy.pi)
    count = 0
    for wavelen_ratio in range(4):
        for dev_ratio in range(1, 2 * wavelen_ratio + 1):
            for ori in orientations:
                for phase in phase_shifts:
                    if count == n_kernels:
                        return
                    k2d = gabor_kernel(
                        kx, ky, sigma=size / dev_ratio / 2.0, theta=ori,
                        lambd=size / wavelen_ratio, gamma=1.0, psi=phase)
                    k2d = k2d - k2d.min()
                    mx = k2d.max()
                    if mx:
                        k2d = k2d * (255.0 / mx)
                    k2d = k2d * stddev
                    # (ky, kx, C) row-major: the flat layout of a row
                    w[count] = numpy.repeat(
                        k2d.reshape(-1), n_channels).astype(w.dtype)
                    count += 1
    if count < n_kernels:
        rand.fill_normal_real(w[count:], 0, stddev)


class ConvolutionalBase(object):
    """The carrier of ``CONV_ATTRS``, the geometry a GD unit takes from
    its forward."""

    CONV_ATTRS = ("n_kernels", "kx", "ky", "sliding", "padding")

    def link_conv_attrs(self, other):
        """Take ``CONV_ATTRS`` from ``other`` (a deconv from its conv)."""
        self.link_attrs(other, *self.CONV_ATTRS)
        return self

    @property
    def weights2d_dev(self):
        """``(n_kernels, ky*kx*C)`` on the device, honouring
        ``weights_transposed`` with a true transpose."""
        w = self.weights.dev
        return w.T if self.weights_transposed else w


class Conv(ConvolutionalBase, NNLayerBase):
    """Convolution with a linear activation."""

    MAPPING = {"conv"}
    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs):
        super(Conv, self).__init__(workflow, **kwargs)
        try:
            self.n_kernels = kwargs["n_kernels"]
            self.kx = kwargs["kx"]
            self.ky = kwargs["ky"]
        except KeyError:
            raise KeyError("n_kernels, kx and ky are required parameters")
        self.padding = tuple(kwargs.get("padding", (0, 0, 0, 0)))
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.max_supposed = kwargs.get("input_max_supposed", 1.0)
        self.exports.extend(("kx", "ky", "n_kernels", "padding", "sliding"))

    @property
    def n_channels(self):
        s = self.input.shape
        return self.input.size // (s[0] * s[1] * s[2])

    def get_weights_magnitude(self):
        vle = 1.0 / (self.max_supposed *
                     numpy.sqrt(self.kx * self.ky * self.n_channels))
        if self.weights_filling == "gaussian":
            vle /= 3
        return vle

    def initialize(self, device=None, **kwargs):
        super(Conv, self).initialize(device=device, **kwargs)
        if len(self.input.shape) not in (3, 4):
            raise ValueError("conv input must be (B,H,W[,C]), got shape %s"
                             % (self.input.shape,))
        if self.weights_stddev is None:
            self.weights_stddev = min(self.get_weights_magnitude(), 0.05)
        if self.bias_stddev is None:
            self.bias_stddev = self.weights_stddev
        kernel_size = self.kx * self.ky * self.n_channels
        if not self.weights:
            w = numpy.zeros((self.n_kernels, kernel_size),
                            dtype=self.input.dtype)
            if self.weights_filling == "gabor":
                fill_gabor_filters(w, self.kx, self.ky, self.n_channels,
                                   self.weights_stddev, self.rand)
            else:
                self.fill_array(self.weights_filling, w,
                                self.weights_stddev)
            if self.weights_transposed:
                w = w.T.copy()
            self.weights.reset(w)
        if self.include_bias and not self.bias:
            b = numpy.zeros(self.n_kernels, dtype=self.input.dtype)
            self.fill_array(self.bias_filling, b, self.bias_stddev)
            self.bias.reset(b)
        ny, nx = conv_ops.output_spatial(
            self.input.shape[1], self.input.shape[2], self.ky, self.kx,
            self.padding, self.sliding)
        out_shape = (self.input.shape[0], ny, nx, self.n_kernels)
        if self.output and self.output.shape[1:] != out_shape[1:]:
            raise ValueError("%s: output %s is not %s" % (
                self.name, self.output.shape, out_shape))
        if not self.output or self.output.shape[0] != out_shape[0]:
            self.output.reset(numpy.zeros(out_shape, self.input.dtype))

    def run(self):
        self.output.set_dev(conv_ops.forward(
            as_nhwc(self.input.dev), self.weights2d_dev,
            self.bias.dev if self.include_bias else None,
            self.ky, self.kx, self.padding, self.sliding,
            activation=self.ACTIVATION, include_bias=self.include_bias))


class ConvTanh(Conv):
    """``1.7159 tanh(0.6666 x)``."""
    MAPPING = {"conv_tanh"}
    ACTIVATION = "tanh"


class ConvSigmoid(Conv):
    """``1 / (1 + e^-x)``."""
    MAPPING = {"conv_sigmoid"}
    ACTIVATION = "sigmoid"


class ConvRELU(Conv):
    """Softplus ``log(1 + e^x)``."""
    MAPPING = {"conv_relu"}
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    """``max(x, 0)``."""
    MAPPING = {"conv_str"}
    ACTIVATION = "strict_relu"
