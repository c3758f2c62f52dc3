"""gluon.nn basic layers (parity: gluon/nn/basic_layers.py).

Sequential, HybridSequential, Dense, Activation, Dropout, BatchNorm,
LeakyReLU, Embedding, Flatten, InstanceNorm, LayerNorm, Lambda,
HybridLambda and MultiHeadAttention, with the JAX package's parameter names, shapes and
initializers.  Dense and LayerNorm resolve their deferred input-sized
parameters from the first input's trailing dimension(s); the others by
shape inference over their graph.
"""
from __future__ import annotations

import math
import warnings

from ..block import Block, HybridBlock


class Sequential(Block):
    """Runs its children in order, eagerly."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._modules)

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children):
            warnings.warn(
                "All children of this Sequential layer are HybridBlocks. "
                "Consider using HybridSequential for the best performance.")
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._modules)


class Dense(HybridBlock):
    """Parity: nn.Dense → FullyConnected."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_param_shapes(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        else:
            act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        if self.act is not None:
            act = self.act(act)
        return act


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis``; ``running_mean`` and
    ``running_var`` are aux states (``grad_req="null"``), updated in train
    mode with MXNet's ``momentum``.  ``scale=False`` fixes gamma at 1."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get("running_mean", grad_req="null",
                                            shape=(in_channels,),
                                            init=running_mean_initializer,
                                            allow_deferred_init=True,
                                            differentiable=False)
        self.running_var = self.params.get("running_var", grad_req="null",
                                           shape=(in_channels,),
                                           init=running_variance_initializer,
                                           allow_deferred_init=True,
                                           differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          name="fwd", **self._kwargs)
        if isinstance(out, (list, tuple)):
            return out[0]
        return out


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha, name="fwd")


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd",
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon, "axis": axis}
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        self.gamma.shape = self.beta.shape = (x.shape[self._axis],)

    def hybrid_forward(self, F, x, gamma, beta):
        out = F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)
        if isinstance(out, (list, tuple)):
            return out[0]
        return out


class Lambda(Block):
    """Wraps a function, or the name of an ``nd`` function, as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F
            if not hasattr(F, function):
                raise ValueError(f"Function name {function} is not found in "
                                 "ndarray.")
            self._func_impl = getattr(F, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """Wraps ``function(F, x, *args)``, or the name of a function both
    ``nd`` and ``sym`` have, as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray, symbol
            if not (hasattr(ndarray, function) and hasattr(symbol, function)):
                raise ValueError(f"Function name {function} is not found in "
                                 "ndarray/symbol.")
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class MultiHeadAttention(HybridBlock):
    """Multi-head self-attention over the flash-attention kernels.

    Inputs (N, T, E), ``units`` divisible by ``num_heads``.  One Dense
    projects x to q, k and v at once; each is a slice of its transpose to
    (N, H, T, E/H), a strided view that the flash op copies to contiguous
    memory before K1 (and K1b under ``record()``) reads it.  Non-causal
    unless ``causal``.
    """

    def __init__(self, units, num_heads, causal=False, use_bias=True,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, use_bias=use_bias,
                             weight_initializer=weight_initializer,
                             prefix="qkv_")
            self.out_proj = Dense(units, flatten=False, use_bias=use_bias,
                                  weight_initializer=weight_initializer,
                                  prefix="out_")

    def hybrid_forward(self, F, x):
        H = self._heads
        Dh = self._units // H
        qkv = self.qkv(x)                                   # (N, T, 3E)
        qkv = F.reshape(qkv, shape=(0, 0, 3 * H, Dh))
        qkv = F.transpose(qkv, axes=(0, 2, 1, 3))           # (N, 3H, T, Dh)
        q = F.slice_axis(qkv, axis=1, begin=0, end=H)
        k = F.slice_axis(qkv, axis=1, begin=H, end=2 * H)
        v = F.slice_axis(qkv, axis=1, begin=2 * H, end=3 * H)
        o = F.flash_attention(q, k, v, causal=self._causal)  # (N, H, T, Dh)
        o = F.transpose(o, axes=(0, 2, 1, 3))
        o = F.reshape(o, shape=(0, 0, -1))                   # (N, T, E)
        return self.out_proj(o)
