"""gluon.rnn fused layers RNN/LSTM/GRU (parity:
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

The whole layer is one ``RNN`` op (``ops/sequence.py``: the input
projection hoisted, a loop over time of one matrix product and the cell's
pointwise ops, on the tensors' device).  Per-layer parameters keep the
reference's names (``l0_i2h_weight``, ...) and are packed into the cuDNN
flat layout at each forward, by one recipe (``hybrid_forward``) for the
eager path, a Symbol and a hybridized layer; a hybridized layer runs the
traced graph through a ``CachedOp``, one per call arity (with and without
states).  Without CUDA and without an explicit ``cpu()`` the parameters
cannot be placed, and ``initialize`` raises ``MXNetError``.
"""
from __future__ import annotations

from torch import Tensor as NDArray

from ..block import HybridBlock
from . import rnn_cell


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout '{layout}'; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = f"{shape[1] if shape[1] else None} -> {shape[0] // self._gates}"
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F
        func = func or F.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name=f"{self.prefix}h0_{i}", **info))
        return states

    def _unfuse(self):
        """Unfuse into stacked cells (parity: rnn_layer._unfuse)."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.SequentialRNNCell(prefix=self.prefix,
                                           params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {"input_size": ni,
                          "i2h_weight_initializer": self._i2h_weight_initializer,
                          "h2h_weight_initializer": self._h2h_weight_initializer,
                          "i2h_bias_initializer": self._i2h_bias_initializer,
                          "h2h_bias_initializer": self._h2h_bias_initializer}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix=f"l{i}_", **kwargs),
                        get_cell(prefix=f"r{i}_", **kwargs)))
                else:
                    stack.add(get_cell(prefix=f"l{i}_", **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def _resolve_input_size(self, inputs):
        """A layer made without ``input_size`` takes it from its first
        tensor input."""
        if self._input_size == 0 and isinstance(inputs, NDArray):
            for i in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, f"{i}0_i2h_weight")
                if p.is_deferred:
                    p.shape = (self._gates * self._hidden_size,
                               inputs.shape[2])
                    p._finish_deferred_init()

    def forward(self, inputs, states=None):
        from ...symbol import Symbol
        if isinstance(inputs, Symbol) or self._active:
            self._resolve_input_size(inputs)
            # symbol composition / hybridized CachedOp: the whole layer is
            # one RNN op node (use_default_state builds zero states inside
            # the op, so no shape access is needed here)
            if states is None:
                return super().forward(inputs)
            if isinstance(states, NDArray):
                states = [states]
            if isinstance(inputs, NDArray):
                # same recurrent-state validation as the eager path — a
                # transposed state with matching element count would
                # otherwise reshape silently into wrong numbers
                bs = inputs.shape[self._layout.find("N")]
                for state, info in zip(states, self.state_info(bs)):
                    if state.shape != info["shape"]:
                        raise ValueError(
                            f"Invalid recurrent state shape. Expecting "
                            f"{info['shape']}, got {state.shape}.")
            return super().forward(inputs, *states)
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.device,
                                      dtype=inputs.dtype)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    f"Invalid recurrent state shape. Expecting {info['shape']}, "
                    f"got {state.shape}.")
        self._resolve_input_size(inputs)
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def hybrid_forward(self, F, inputs, *states, **params):
        """Symbol-composable kernel: params packed with F ops, states
        optional (the RNN op's use_default_state builds zeros on-device,
        where shapes are concrete)."""
        dirs = ["l", "r"] if self._dir == 2 else ["l"]
        parts = []
        for i in range(self._num_layers):
            for j in dirs:
                parts.append(F.Reshape(params[f"{j}{i}_i2h_weight"],
                                       shape=(-1,)))
                parts.append(F.Reshape(params[f"{j}{i}_h2h_weight"],
                                       shape=(-1,)))
        for i in range(self._num_layers):
            for j in dirs:
                parts.append(params[f"{j}{i}_i2h_bias"])
                parts.append(params[f"{j}{i}_h2h_bias"])
        packed = F.Concat(*parts, dim=0)
        x = F.SwapAxis(inputs, dim1=0, dim2=1) if self._layout == "NTC" \
            else inputs
        rnn = F.RNN(x, packed, *states, state_size=self._hidden_size,
                    num_layers=self._num_layers,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True, mode=self._mode,
                    use_default_state=not states)
        out = rnn[0]
        if self._layout == "NTC":
            out = F.SwapAxis(out, dim1=0, dim2=1)
        if not states:
            return out
        new_states = [rnn[1]]
        if self._mode == "lstm":
            new_states.append(rnn[2])
        return out, new_states

    def _forward_kernel(self, inputs, states):
        """Eager kernel = hybrid_forward with F=nd (ONE packing recipe for
        both paths — they cannot drift)."""
        from ... import ndarray as F
        params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, inputs, *states, **params)


class RNN(_RNNLayer):
    """Parity: gluon.rnn.RNN."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Parity: gluon.rnn.LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Parity: gluon.rnn.GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
