"""mx.rnn symbol-level cells (parity: ``mxnet_tpu/rnn/rnn_cell.py``).

BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell (over the ``RNN``
op, with ``unfuse``), SequentialRNNCell, BidirectionalCell, DropoutCell,
ZoneoutCell, ResidualCell and the convolutional ConvRNNCell, ConvLSTMCell,
ConvGRUCell: each call adds one step to a Symbol graph, ``unroll`` a whole
sequence; ``BucketingModule`` binds the graph of each length.  A begin
state is a ``zeros`` node of shape ``(0, H)``, its batch filled in by shape
inference at bind.  ``steppable`` says whether a cell has a one-token step
(``serving.decode.CellModel`` needs one).
"""
from __future__ import annotations

import torch

from .. import symbol
from ..symbol import Symbol
from ..base import MXNetError


def _concat(parts):
    """Parameter arrays (tensors or numpy arrays) joined on axis 0."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    import numpy as np
    return np.concatenate(parts)


def _copy(a):
    """A copy of a parameter array (a tensor or a numpy array)."""
    return a.clone() if isinstance(a, torch.Tensor) else a.copy()


class RNNParams:
    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def steppable(self):
        """True when ``cell(x, states)`` emits ONE token step — the
        contract continuous-batching decode needs
        (``serving.decode.CellModel`` builds its per-step program
        from exactly that one-step Symbol).  Whole-sequence
        cells (fused, bidirectional) override to False and are
        rejected with a typed ``GenerativeRouteError`` instead of
        silently serving at request granularity."""
        return True

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name=f"{self._prefix}begin_state_{self._init_counter}",
                         **info) if "name" not in info else func(**info)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Unpack fused parameter vector into per-gate weights (parity:
        rnn_cell.unpack_weights)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop(f"{self._prefix}{group_name}_weight")
            bias = args.pop(f"{self._prefix}{group_name}_bias")
            for j, gate in enumerate(self._gate_names):
                wname = f"{self._prefix}{group_name}{gate}_weight"
                args[wname] = _copy(weight[j * h:(j + 1) * h])
                bname = f"{self._prefix}{group_name}{gate}_bias"
                args[bname] = _copy(bias[j * h:(j + 1) * h])
        return args

    def pack_weights(self, args):
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = f"{self._prefix}{group_name}{gate}_weight"
                weight.append(args.pop(wname))
                bname = f"{self._prefix}{group_name}{gate}_bias"
                bias.append(args.pop(bname))
            args[f"{self._prefix}{group_name}_weight"] = _concat(weight)
            args[f"{self._prefix}{group_name}_bias"] = _concat(bias)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell over `length` steps (parity: rnn_cell.unroll)."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, Symbol):
            if len(inputs) != length:
                inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                                  num_outputs=length,
                                                  squeeze_axis=1))
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4,
                                          name=f"{name}slice")
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name=f"{name}i")
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name=f"{name}f")
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name=f"{name}c")
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name=f"{name}o")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(prev_state_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}h2h")
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3,
                                                name=f"{name}i2h_slice")
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3,
                                                name=f"{name}h2h_slice")
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name=f"{name}r_act")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name=f"{name}z_act")
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh", name=f"{name}h_act")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the ``RNN`` op (parity: rnn_cell.
    FusedRNNCell over cudnn_rnn)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        from ..initializer import FusedRNN
        self._parameter = self.params.get(
            "parameters", init=FusedRNN(None, num_hidden, num_layers, mode,
                                        bidirectional, forget_bias))

    @property
    def steppable(self):
        # the fused op consumes a whole (T, N, C) sequence: no
        # single-token step exists; unfuse() yields a stack of steppable
        # per-layer cells for decode serving
        return False

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, Symbol):
            assert len(inputs) == length
            inputs = [symbol.expand_dims(i, axis=1) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=1)
            axis = 1
        if axis == 1:
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        rnn_inputs = [inputs, self._parameter, states[0]]
        if self._mode == "lstm":
            rnn_inputs.append(states[1])
        rnn = symbol.RNN(*rnn_inputs, state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state, mode=self._mode,
                         name=self._prefix + "rnn")
        outputs = rnn if not self._get_next_state else rnn[0]
        attr_states = []
        if self._get_next_state:
            if self._mode == "lstm":
                attr_states = [rnn[1], rnn[2]]
            else:
                attr_states = [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(outputs, axis=axis,
                                               num_outputs=length,
                                               squeeze_axis=1))
        return outputs, attr_states

    def unfuse(self):
        """Equivalent stack of unfused cells (parity: FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="relu", prefix=cell_prefix),
            "rnn_tanh": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="tanh", prefix=cell_prefix),
            "lstm": lambda cell_prefix: LSTMCell(self._num_hidden,
                                                 prefix=cell_prefix),
            "gru": lambda cell_prefix: GRUCell(self._num_hidden,
                                               prefix=cell_prefix),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None else \
            symbol.zeros_like(next_output)
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def steppable(self):
        # needs the future half of the sequence — meaningless at
        # decode time, where the future is what's being generated
        return False

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, Symbol):
            inputs = list(symbol.SliceChannel(inputs, axis=axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name=f"{self._output_prefix}t{i}")
                   for i, (l_o, r_o) in
                   enumerate(zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states


# -- convolutional recurrent cells (parity: rnn_cell.py BaseConvRNNCell /
# ConvRNNCell / ConvLSTMCell / ConvGRUCell — recurrence over NCHW feature
# maps with Convolution i2h/h2h instead of FullyConnected; used for
# spatiotemporal models, e.g. precipitation nowcasting) -------------------

class BaseConvRNNCell(BaseRNNCell):
    """Shared conv-gate machinery.  `input_shape` is the per-step
    (C, H, W); the state shape follows from the i2h conv arithmetic, and
    the h2h kernel must be odd so its SAME padding preserves it."""

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 activation, prefix="", params=None, i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)
        self._activation = activation
        self._h2h_kernel = tuple(h2h_kernel)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                f"h2h kernel must be odd to preserve the state shape, "
                f"got {h2h_kernel}")
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = (self._h2h_dilate[0] * (self._h2h_kernel[0] - 1) // 2,
                         self._h2h_dilate[1] * (self._h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        # conv output arithmetic fixes the recurrent state's spatial dims
        _, h, w = self._input_shape
        sh = (h + 2 * self._i2h_pad[0]
              - self._i2h_dilate[0] * (self._i2h_kernel[0] - 1) - 1) \
            // self._i2h_stride[0] + 1
        sw = (w + 2 * self._i2h_pad[1]
              - self._i2h_dilate[1] * (self._i2h_kernel[1] - 1) - 1) \
            // self._i2h_stride[1] + 1
        self._state_shape = (num_hidden, sh, sw)
        self._iW = self.params.get("i2h_weight")
        # RNNParams.get caches the first Variable it creates per name, so
        # a subclass's bias initializer must ride THIS call — a re-get
        # with init= later would be silently ignored
        self._iB = self.params.get("i2h_bias", init=i2h_bias_init) \
            if i2h_bias_init is not None else self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{"shape": (0,) + self._state_shape, "__layout__": "NCHW"}
                for _ in range(self._num_states)]

    def _conv_gates(self, inputs, states, name):
        ng = self._num_gates
        i2h = symbol.Convolution(inputs, self._iW, self._iB,
                                 kernel=self._i2h_kernel,
                                 stride=self._i2h_stride,
                                 pad=self._i2h_pad,
                                 dilate=self._i2h_dilate,
                                 num_filter=self._num_hidden * ng,
                                 name=f"{name}i2h")
        h2h = symbol.Convolution(states[0], self._hW, self._hB,
                                 kernel=self._h2h_kernel,
                                 dilate=self._h2h_dilate,
                                 pad=self._h2h_pad,
                                 num_filter=self._num_hidden * ng,
                                 name=f"{name}h2h")
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """Parity: rnn_cell.ConvRNNCell — h' = act(conv(x) + conv(h))."""

    _num_states = 1

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvRNN_", params=None):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix, params)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h, h2h = self._conv_gates(inputs, states, name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{name}out")
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """Parity: rnn_cell.ConvLSTMCell (Shi et al. 2015, "Convolutional
    LSTM Network") — LSTM gates computed by convolutions over feature
    maps; state is (h, c) pairs of NCHW maps."""

    _num_states = 2

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvLSTM_", params=None, forget_bias=1.0):
        from ..initializer import LSTMBias
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix, params,
                         i2h_bias_init=LSTMBias(forget_bias=forget_bias))

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h, h2h = self._conv_gates(inputs, states, name)
        gates = i2h + h2h
        sl = symbol.SliceChannel(gates, num_outputs=4, name=f"{name}slice")
        in_gate = symbol.Activation(sl[0], act_type="sigmoid",
                                    name=f"{name}i")
        forget_gate = symbol.Activation(sl[1], act_type="sigmoid",
                                        name=f"{name}f")
        in_transform = self._get_activation(sl[2], self._activation,
                                            name=f"{name}c")
        out_gate = symbol.Activation(sl[3], act_type="sigmoid",
                                     name=f"{name}o")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Parity: rnn_cell.ConvGRUCell — GRU gates by convolution."""

    _num_states = 1

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1), activation="tanh",
                 prefix="ConvGRU_", params=None):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         activation, prefix, params)

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h, h2h = self._conv_gates(inputs, states, name)
        i2h_r, i2h_z, i2h_o = symbol.SliceChannel(
            i2h, num_outputs=3, name=f"{name}i2h_slice")
        h2h_r, h2h_z, h2h_o = symbol.SliceChannel(
            h2h, num_outputs=3, name=f"{name}h2h_slice")
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name=f"{name}r")
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name=f"{name}z")
        cand = self._get_activation(i2h_o + reset * h2h_o,
                                    self._activation, name=f"{name}h")
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]
