"""RNN checkpoint helpers (ref: python/mxnet/rnn/rnn.py) — save/load model
checkpoints with fused parameter blobs unpacked into portable per-gate
arrays.

Counterpart: ``mxnet_tpu/rnn/rnn.py``, a copy; the files are
``model.save_checkpoint``'s, which either package loads."""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _as_cell_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """ref: rnn/rnn.py save_rnn_checkpoint:28 — unpack fused blobs before
    saving so checkpoints are layout-independent."""
    for cell in _as_cell_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """ref: rnn/rnn.py load_rnn_checkpoint:54."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cell_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback variant (ref: rnn/rnn.py do_rnn_checkpoint:86)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
