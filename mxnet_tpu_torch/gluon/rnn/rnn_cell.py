"""gluon.rnn cells (parity: ``mxnet_tpu/gluon/rnn/rnn_cell.py``).

RecurrentCell, RNNCell, LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
BidirectionalCell, ResidualCell, ZoneoutCell, ModifierCell: one step per
call over ``F`` ops (``nd`` on tensors, ``sym`` on Symbols), unrolled by
``unroll``; the fused counterpart is ``gluon.rnn.rnn_layer`` over the
``RNN`` op.  A cell's parameters live where ``initialize(ctx=)`` put them:
without CUDA and without an explicit ``cpu()`` that raises ``MXNetError``.
"""
from __future__ import annotations

from ..block import HybridBlock


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _state_kw(inputs):
    """Where ``unroll``'s default begin states go: the inputs' device and
    dtype (the port's default context is ``gpu(0)``)."""
    from torch import Tensor
    first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    if isinstance(first, Tensor):
        return {"ctx": first.device, "dtype": first.dtype}
    return {}


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    from torch import Tensor as NDArray
    from ... import ndarray as F_nd
    from ...symbol import Symbol
    from ... import symbol as F_sym
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    if isinstance(inputs, (Symbol, NDArray)):
        F = F_sym if isinstance(inputs, Symbol) else F_nd
        if isinstance(inputs, NDArray):
            batch_size = inputs.shape[batch_axis]
            if length is None:
                length = inputs.shape[axis]
        if merge is False:
            inputs = list(F.SliceChannel(inputs, axis=axis, num_outputs=length,
                                         squeeze_axis=True))
    else:
        assert length is None or len(inputs) == length
        F = F_sym if isinstance(inputs[0], Symbol) else F_nd
        if isinstance(inputs[0], NDArray):
            batch_size = inputs[0].shape[batch_axis - (batch_axis > axis)] \
                if inputs[0].ndim < 3 else inputs[0].shape[batch_axis]
            if inputs[0].ndim == 2:
                batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = F.Concat(*[F.expand_dims(i, axis=axis) for i in inputs],
                              dim=axis)
    return inputs, axis, F, batch_size


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F
        assert not self._modified
        states = []
        func = func or F.zeros
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name=f"{self._prefix}begin_state_{self._init_counter}",
                         **info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout,
                                                       False)
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size, **_state_kw(inputs))
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # each sample's returned state is the one at its last valid
            # step (parity: unroll's F.SequenceLast over per-step states),
            # and outputs past valid_length are zero-masked
            states = [F.SequenceLast(
                F.Concat(*[F.expand_dims(s[i], axis=0) for s in all_states],
                         dim=0),
                valid_length, use_sequence_length=True, axis=0)
                for i in range(len(states))]
            merged = F.Concat(*[F.expand_dims(o, axis=axis)
                                for o in outputs], dim=axis)
            merged = F.SequenceMask(merged, valid_length,
                                    use_sequence_length=True, axis=axis)
            if merge_outputs:
                return merged, states
            outputs = list(F.SliceChannel(merged, num_outputs=length,
                                          axis=axis, squeeze_axis=True))
            return outputs, states
        if merge_outputs:
            outputs = F.Concat(*[F.expand_dims(o, axis=axis) for o in outputs],
                               dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "h2h")
        output = self._get_activation(F, i2h + h2h, self._activation,
                                      name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4, axis=1,
                                     name=prefix + "slice")
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "h2h")
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=1,
                                             name=prefix + "i2h_slice")
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=1,
                                             name=prefix + "h2h_slice")
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float))
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate,
                               name=f"t{self._counter}_fwd")
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        assert not base_cell._modified
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ResidualCell(ModifierCell):
    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([F.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please "
                                  "use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout,
                                                       False)
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size, **_state_kw(inputs))
        states = begin_state
        l_cell, r_cell = self._children

        def _rev(seq):
            """Time-reverse a list of per-step (N, C) frames; with
            valid_length, reverse only within each sample's valid span
            (SequenceReverse semantics — padded tail stays in place)."""
            if valid_length is None:
                return list(reversed(seq))
            stacked = F.Concat(*[F.expand_dims(o, axis=0) for o in seq],
                               dim=0)  # TNC
            rev = F.SequenceReverse(stacked, valid_length,
                                    use_sequence_length=True)
            return list(F.SliceChannel(rev, num_outputs=length, axis=0,
                                       squeeze_axis=True))

        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=_rev(inputs),
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        outputs = [F.Concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, _rev(r_outputs))]
        if merge_outputs:
            outputs = F.Concat(*[F.expand_dims(o, axis=axis)
                                 for o in outputs], dim=axis)
        states = l_states + r_states
        return outputs, states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError
