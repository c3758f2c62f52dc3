"""gluon.nn convolution and pooling layers (parity: gluon/nn/conv_layers.py).

Conv1D/2D/3D and their transposes, MaxPool/AvgPool 1/2/3D and
GlobalMaxPool/GlobalAvgPool 1/2/3D, over the ``Convolution``,
``Deconvolution`` and ``Pooling`` ops.  A weight's input-channel dimension
left at 0 is read off the first input's channel axis.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", op_name="Convolution",
                 adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            if isinstance(strides, int):
                strides = (strides,) * len(kernel_size)
            if isinstance(padding, int):
                padding = (padding,) * len(kernel_size)
            if isinstance(dilation, int):
                dilation = (dilation,) * len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups) + tuple(kernel_size)
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_param_shapes(self, x, *args):
        """The weight's input channels from x's channel axis (shape
        inference over the graph cannot tell them from the batch for a
        transposed convolution: its shape rule does not read them)."""
        layout = self._kwargs["layout"]
        c = x.shape[layout.index("C") if layout else 1]
        groups = self._kwargs["num_group"]
        out_c, in_c, *kernel = self.weight.shape
        if self._op_name == "Convolution":
            self.weight.shape = (out_c, c // groups, *kernel)
        else:
            self.weight.shape = (c, in_c, *kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, name="fwd", **self._kwargs)
        else:
            act = op(x, weight, bias, name="fwd", **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(shape[1] if shape[1] else
                                                    None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        assert len(kernel_size) == 1
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        assert len(kernel_size) == 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        assert len(kernel_size) == 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        if isinstance(output_padding, int):
            output_padding = (output_padding,)
        assert len(kernel_size) == 1
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * 2
        assert len(kernel_size) == 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0), dilation=(1, 1, 1),
                 groups=1, layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        if isinstance(output_padding, int):
            output_padding = (output_padding,) * 3
        assert len(kernel_size) == 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
               "ceil_mode={ceil_mode})".format(
                   name=self.__class__.__name__,
                   ceil_mode=self._kwargs["pooling_convention"] == "full",
                   **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        assert layout == "NCW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        assert layout == "NCDHW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        assert layout == "NCW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        assert layout == "NCDHW"
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)
