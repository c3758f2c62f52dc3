"""RNN checkpoint helpers (parity: ``mxnet_tpu/rnn/rnn.py``): checkpoints
whose parameters are unpacked per gate on save and packed on load."""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    for cell in cells:
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    sym, arg, aux = load_checkpoint(prefix, epoch)
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    for cell in cells:
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated (parity: rnn.rnn_unroll) — use cell.unroll.  An
    input_prefix names the auto-generated per-step input variables the
    way the v0 API did (`<prefix>t<i>_data`)."""
    import warnings
    warnings.warn("rnn_unroll is deprecated; call cell.unroll directly.")
    if inputs is None:
        from .. import symbol as _sym
        inputs = [_sym.Variable("%st%d_data" % (input_prefix, i))
                  for i in range(length)]
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)
