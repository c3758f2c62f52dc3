"""Sequence operators and the fused RNN (parity: ``mxnet_tpu/ops/sequence.py``).

The counterpart of the JAX package's ``SequenceLast``, ``SequenceMask``,
``SequenceReverse`` and fused ``RNN``, with the same schemas.  The JAX
package runs the recurrence as a ``lax.scan`` that XLA compiles; here it is
torch ops on the tensors' device, one formula for the four modes:

  * each layer and direction's input projection is hoisted out of the time
    loop as one ``torch.matmul`` over the whole sequence, with both biases
    folded in (``W x + bW + bR``);
  * a Python loop over time then does one matrix product for ``R h`` (an
    ``addmm`` onto the hoisted projection for ``lstm`` and ``rnn_*``, an
    ``mm`` for ``gru``) and the cell's pointwise ops.

The GRU is the JAX package's, not cuDNN's: the recurrent bias ``bR`` sits in
the hoisted projection, so the candidate is ``tanh(W_n x + bW_n + bR_n +
r * (R_n h))``, its recurrent bias outside the reset gate (cuDNN,
``torch.nn.GRU`` and ``gluon.rnn.GRUCell`` put it inside; ROADMAP.md §3).
``lstm_state_clip_*`` clips only the returned cell state, as the JAX op
does.  Inter-layer dropout (``p``, training only) draws its masks from the
port's generator (``random.generator``), so its draws are not the JAX
package's.

The packed parameter vector has the cuDNN layout the JAX package uses:
every layer's and direction's ``W`` then ``R`` (gate-major rows), then every
layer's and direction's ``bW`` then ``bR`` (``rnn_param_size``,
``_unpack_rnn_params``).
"""
from __future__ import annotations

import torch

from ..base import Arg, MXNetError
from .nn import _dropout
from .registry import register


def _lengths(seq_len, device):
    return seq_len.to(device=device, dtype=torch.int64)


@register("SequenceLast", input_names=("data", "sequence_length"),
          variadic=True,
          args=[Arg("use_sequence_length", bool, False), Arg("axis", int, 0)])
def _sequence_last(p, data, seq_len=None):
    ax = p["axis"]
    if not p["use_sequence_length"] or seq_len is None:
        return data.select(ax, data.shape[ax] - 1)
    idx = (_lengths(seq_len, data.device) - 1).clamp(min=0)   # (batch,)
    moved = torch.movedim(data, ax, 0)                         # (seq, batch, ...)
    idx = idx.reshape((1, -1) + (1,) * (moved.dim() - 2)).expand(
        (1,) + tuple(moved.shape[1:]))
    return torch.gather(moved, 0, idx)[0]


@register("SequenceMask", input_names=("data", "sequence_length"),
          variadic=True,
          args=[Arg("use_sequence_length", bool, False),
                Arg("value", float, 0.0), Arg("axis", int, 0)])
def _sequence_mask(p, data, seq_len=None):
    if not p["use_sequence_length"] or seq_len is None:
        return data
    ax = p["axis"]
    steps = torch.arange(data.shape[ax], device=data.device)
    lens = seq_len.to(data.device)
    # (seq, batch, ...) for axis=0, (batch, seq, ...) for axis=1
    mask = steps[:, None] < lens[None, :] if ax == 0 \
        else steps[None, :] < lens[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), p["value"],
                                              dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", input_names=("data", "sequence_length"),
          variadic=True,
          args=[Arg("use_sequence_length", bool, False), Arg("axis", int, 0)])
def _sequence_reverse(p, data, seq_len=None):
    """Reverses along the first axis whatever ``axis`` says, as the JAX
    op does."""
    if not p["use_sequence_length"] or seq_len is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    steps = torch.arange(T, device=data.device)[:, None]
    L = _lengths(seq_len, data.device)[None, :]
    idx = torch.where(steps < L, L - 1 - steps, steps)       # (seq, batch)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return torch.gather(data, 0, idx)


# ---------------------------------------------------------------------------
# Fused RNN (the cuDNN packed-parameter layout)
# ---------------------------------------------------------------------------
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """The packed parameter count: W and R of every layer and direction,
    then their biases bW and bR."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size)
    size += num_layers * d * g * state_size * 2
    return size


def _unpack_rnn_params(params, num_layers, input_size, state_size, bidir,
                       mode):
    """Views of the packed vector: ``ws[layer][dir]`` (gH, in), ``rs`` (gH,
    H), ``bws``, ``brs`` (gH,)."""
    g = _GATES[mode]
    d = 2 if bidir else 1
    ws, rs, bws, brs = [], [], [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        lw, lr = [], []
        for _ in range(d):
            n = g * state_size * in_sz
            lw.append(params[off:off + n].reshape(g * state_size, in_sz))
            off += n
            n = g * state_size * state_size
            lr.append(params[off:off + n].reshape(g * state_size,
                                                  state_size))
            off += n
        ws.append(lw)
        rs.append(lr)
    for layer in range(num_layers):
        lbw, lbr = [], []
        for _ in range(d):
            n = g * state_size
            lbw.append(params[off:off + n])
            off += n
            lbr.append(params[off:off + n])
            off += n
        bws.append(lbw)
        brs.append(lbr)
    return ws, rs, bws, brs


def _run_layer(x, h, c, W, R, bW, bR, mode, reverse):
    """One direction of one layer over x (T, B, in): (outputs (T, B, H),
    h_T, c_T or None)."""
    T = x.shape[0]
    # the input projection of every step at once, both biases folded in
    wx = torch.matmul(x, W.t()) + bW + bR
    Rt = R.t()
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "lstm":
            i, f, g, o = torch.addmm(wx[t], h, Rt).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = wx[t].chunk(3, dim=-1)
            rh, zh, nh = torch.mm(h, Rt).chunk(3, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(torch.addmm(wx[t], h, Rt))
        else:
            # max(x, 0) as jnp.maximum: half the gradient at a tie
            h = torch.maximum(torch.addmm(wx[t], h, Rt),
                              torch.zeros((), dtype=h.dtype,
                                          device=h.device))
        outs[t] = h
    return torch.stack(outs), h, c


@register("RNN", input_names=("data", "parameters", "state", "state_cell"),
          variadic=True,
          args=[Arg("state_size", int, required=True),
                Arg("num_layers", int, required=True),
                Arg("bidirectional", bool, False),
                Arg("mode", str, required=True),
                Arg("p", float, 0.0), Arg("state_outputs", bool, False),
                Arg("lstm_state_clip_min", float, None),
                Arg("lstm_state_clip_max", float, None),
                Arg("use_default_state", bool, False)],
          num_outputs=3, takes_is_train=True)
def _rnn(p, data, parameters, state=None, state_cell=None):
    """Fused multi-layer (bidirectional) RNN, LSTM or GRU.

    data: (seq_len, batch, input_size); state, state_cell: (L*D, batch,
    H), zeros when not given (``use_default_state``).  Returns (out,
    state_out, statecell_out); a Symbol shows the first one or, with
    ``state_outputs``, all three."""
    mode = p["mode"]
    if mode not in _GATES:
        raise MXNetError(f"unknown RNN mode {mode}")
    L, H = p["num_layers"], p["state_size"]
    bidir = p["bidirectional"]
    d = 2 if bidir else 1
    T, B, I = data.shape
    if state is None:
        state = torch.zeros((L * d, B, H), dtype=data.dtype,
                            device=data.device)
    if mode == "lstm" and state_cell is None:
        state_cell = torch.zeros((L * d, B, H), dtype=data.dtype,
                                 device=data.device)
    ws, rs, bws, brs = _unpack_rnn_params(parameters, L, I, H, bidir, mode)
    if data.device.type == "meta":
        # shape inference: the shapes alone, not T steps of the loop
        return (torch.empty((T, B, d * H), dtype=data.dtype, device="meta"),
                torch.empty_like(state), torch.empty_like(state))
    hs = state.reshape(L, d, B, H)
    cs = state_cell.reshape(L, d, B, H) if mode == "lstm" else None
    x = data
    h_out, c_out = [], []
    for layer in range(L):
        outs = []
        for direction in range(d):
            out, hT, cT = _run_layer(
                x, hs[layer, direction],
                cs[layer, direction] if cs is not None else None,
                ws[layer][direction], rs[layer][direction],
                bws[layer][direction], brs[layer][direction], mode,
                reverse=direction == 1)
            outs.append(out)
            h_out.append(hT)
            c_out.append(cT if cT is not None else hT)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        # every layer's output but the last, in training only
        if p["p"] > 0 and layer < L - 1 and p.get("__is_train__"):
            x = _dropout({"p": p["p"], "mode": "training", "axes": (),
                          "__is_train__": True}, x)
    state_out = torch.stack(h_out).reshape(L * d, B, H)
    cell_out = torch.stack(c_out).reshape(L * d, B, H)
    if mode == "lstm" and p.get("lstm_state_clip_min") is not None:
        cell_out = torch.clamp(cell_out, p["lstm_state_clip_min"],
                               p["lstm_state_clip_max"])
    return x, state_out, cell_out
