"""The fused recurrent op ``RNN`` (ref: src/operator/rnn.cc,
src/operator/cudnn_rnn-inl.h): vanilla (tanh / relu), LSTM and GRU,
multi-layer, bidirectional, inter-layer dropout, one flat parameter
blob.

Counterpart: ``mxnet_tpu/ops/rnn.py``, whose recurrence is a
``lax.scan``.  Here the op has two routes, chosen from its arguments
alone and recorded per call (:func:`route_counts`, :func:`calls`):

* ``cudnn`` — torch's fused RNN (``torch.lstm`` / ``gru`` /
  ``rnn_tanh`` / ``rnn_relu``, what ``torch.nn.LSTM`` calls; cuDNN on
  CUDA) for every mode, when the data lies on a CUDA device and no
  ``lstm_state_clip_*`` is set;
* ``scan`` — a plain step-by-step loop, the counterpart of the JAX
  package's ``_scan_one_direction``: CPU and ``meta`` tensors (shape
  inference), and the state clip, which torch's fused RNN lacks.

A failure of the fused call propagates; nothing retries it down the
scan.  Inter-layer dropout (``p > 0`` while training) runs the layers
one at a time with the mask drawn from the op's generator (the port's
random stream), as the JAX op draws from its key, so a remat recompute
replays it; cuDNN's internal dropout is never used.

Blob layout (ref: rnn-inl.h GetRnnParamSize, cuDNN's linLayer order):
all weights first — per layer, per direction: ``W_i2h (G·H × in)``,
``W_h2h (G·H × H)`` — then all biases per layer / direction:
``b_i2h (G·H)``, ``b_h2h (G·H)``.  Gate order is cuDNN's, which is also
torch's: LSTM ``[i, f, g, o]``, GRU ``[r, z, n]`` with the reset gate
applied to ``W_hn h + b_hn`` (linear before reset).  cuDNN wants one
contiguous weight buffer in its own per-layer order; the blob's order
differs, so torch compacts the views into that buffer on every call.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch

from ..base import dtype_name
from .registry import register

__all__ = ["rnn_param_size", "split_params", "choose_route", "rnn_forward",
           "run_fused", "run_scan", "route_counts", "calls", "passes",
           "reset_counts", "FAULTS", "ROUTES"]

_NUM_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_FUSED = {"lstm": torch.lstm, "gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
          "rnn_relu": torch.rnn_relu}
ROUTES = ("cudnn", "scan")

#: calls by (route, dtype name, mode); shape inference (``meta``) is
#: not counted
_CALLS: collections.Counter = collections.Counter()
#: passes by route: one a call, or one a layer under dropout
_PASSES: collections.Counter = collections.Counter()

#: planted faults for the checks that must catch them:
#: ``cudnn_swap_if`` swaps the LSTM's i and f gates in the fused route's
#: weights; ``scan_reverse_unflipped`` leaves the scan's reverse
#: direction in reversed time
FAULTS: set = set()


def rnn_param_size(num_layers, input_size, state_size, bidirectional=False,
                   mode="lstm"):
    """Total flat-parameter length (ref: rnn-inl.h GetRnnParamSize)."""
    ng = _NUM_GATES[mode]
    nd = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * nd
        size += nd * ng * state_size * (isz + state_size + 2)
    return size


def split_params(flat, mode, num_layers, num_dir, input_size, H
                 ) -> List[List[List[torch.Tensor]]]:
    """The blob as views ``[layer][direction] = [w_i2h, w_h2h, b_i2h,
    b_h2h]`` (the JAX package's ``_split_params``)."""
    ng = _NUM_GATES[mode]
    weights, idx = [], 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else H * num_dir
        per_layer = []
        for _ in range(num_dir):
            w_i2h = flat[idx:idx + ng * H * isz].reshape(ng * H, isz)
            idx += ng * H * isz
            w_h2h = flat[idx:idx + ng * H * H].reshape(ng * H, H)
            idx += ng * H * H
            per_layer.append([w_i2h, w_h2h])
        weights.append(per_layer)
    for layer in range(num_layers):
        for d in range(num_dir):
            b_i2h = flat[idx:idx + ng * H]
            idx += ng * H
            b_h2h = flat[idx:idx + ng * H]
            idx += ng * H
            weights[layer][d] += [b_i2h, b_h2h]
    return weights


def choose_route(data: torch.Tensor, clip_min=None, clip_max=None) -> str:
    """``cudnn`` for CUDA data without a state clip, else ``scan``."""
    clipped = clip_min is not None and clip_max is not None
    return "cudnn" if data.device.type == "cuda" and not clipped else "scan"


def route_counts() -> Dict[str, int]:
    """Calls of the op by route since the last :func:`reset_counts`."""
    out = {r: 0 for r in ROUTES}
    for (route, _, _), n in _CALLS.items():
        out[route] += n
    return out


def calls() -> Dict[str, int]:
    """Calls by ``"route/dtype/mode"``."""
    return {"/".join(k): n for k, n in sorted(_CALLS.items())}


def passes() -> Dict[str, int]:
    """Passes over the stack by route (torch fused-RNN calls on the
    ``cudnn`` route): one a call, or one a layer under dropout."""
    return {r: _PASSES[r] for r in ROUTES}


def reset_counts() -> None:
    _CALLS.clear()
    _PASSES.clear()


# ---------------------------------------------------------------------------
# the scan route
# ---------------------------------------------------------------------------
def _scan_one_direction(x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h, mode,
                        reverse=False, clip_min=None, clip_max=None):
    """One (layer, direction) pass.  x: (T, N, I) → (T, N, H), h_T[, c_T]."""
    if reverse:
        x = torch.flip(x, dims=(0,))
    ys = []
    c = c0
    if mode == "lstm":
        gx = x @ w_i2h.t() + b_i2h + b_h2h
        h = h0
        for t in range(x.shape[0]):
            i, f, g, o = (gx[t] + h @ w_h2h.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip_min is not None and clip_max is not None:
                # cuDNN clips the cell state inside the recurrence
                # (ref: cudnn_rnn-inl.h lstm_state_clip_*)
                c = torch.clamp(c, clip_min, clip_max)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
    elif mode == "gru":
        # linear-before-reset: n = tanh(Wx_n + b_in + r * (Rh_n + b_hn))
        gx = x @ w_i2h.t() + b_i2h
        h = h0
        for t in range(x.shape[0]):
            xr, xz, xn = gx[t].chunk(3, dim=-1)
            hr, hz, hn = (h @ w_h2h.t() + b_h2h).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            ys.append(h)
        c = None
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu
        gx = x @ w_i2h.t() + b_i2h + b_h2h
        h = h0
        for t in range(x.shape[0]):
            h = act(gx[t] + h @ w_h2h.t())
            ys.append(h)
        c = None
    ys = torch.stack(ys, dim=0)
    if reverse and "scan_reverse_unflipped" not in FAULTS:
        ys = torch.flip(ys, dims=(0,))
    return ys, h, c


def run_scan(x, h0, c0, weights, mode, layers, num_dir, clip_min=None,
             clip_max=None) -> Tuple[torch.Tensor, list, list]:
    """``layers`` (a range) of the stack on the scan route: the output
    and the final states in ``layer * num_dir + d`` order.  ``h0`` /
    ``c0`` hold those layers' initial states."""
    h_fin, c_fin = [], []
    for k, layer in enumerate(layers):
        outs = []
        for d in range(num_dir):
            s = k * num_dir + d
            ys, h_t, c_t = _scan_one_direction(
                x, h0[s], c0[s] if c0 is not None else None,
                *weights[layer][d], mode, reverse=(d == 1),
                clip_min=clip_min, clip_max=clip_max)
            outs.append(ys)
            h_fin.append(h_t)
            if c_t is not None:
                c_fin.append(c_t)
        x = outs[0] if num_dir == 1 else torch.cat(outs, dim=-1)
    return x, h_fin, c_fin


# ---------------------------------------------------------------------------
# the fused (cuDNN) route
# ---------------------------------------------------------------------------
def _swap_if(w, H):
    return torch.cat([w[H:2 * H], w[:H], w[2 * H:]], dim=0)


def run_fused(x, h0, c0, weights, mode, layers, num_dir
              ) -> Tuple[torch.Tensor, list, list]:
    """``layers`` of the stack in one call of torch's fused RNN (cuDNN
    on CUDA; the route is :func:`choose_route`'s, this runs on whatever
    device its tensors are on)."""
    flat: List[torch.Tensor] = []
    H = h0.shape[-1]
    for layer in layers:
        for d in range(num_dir):
            ws = list(weights[layer][d])
            if mode == "lstm" and "cudnn_swap_if" in FAULTS:
                ws = [_swap_if(w, H) for w in ws]
            flat += ws
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, h0] + flat)
    # cuDNN takes dense states (a zero state may be a broadcast view)
    hx = ((h0.contiguous(), c0.contiguous()) if mode == "lstm"
          else h0.contiguous())
    out = _FUSED[mode](x, hx, flat, True, len(layers), 0.0, train,
                       num_dir == 2, False)
    ys, h_n = out[0], out[1]
    c_n = out[2] if mode == "lstm" else None
    return ys, list(h_n.unbind(0)), (list(c_n.unbind(0))
                                     if c_n is not None else [])


def rnn_forward(route, key, data, parameters, state, cell0=None, *,
                state_size, num_layers=1, bidirectional=False, mode="lstm",
                p=0.0, state_outputs=False, clip_min=None, clip_max=None,
                training=True):
    """The op's body on the given route (the op chooses it with
    :func:`choose_route`); the tests call it to hold the fused route's
    weight mapping against the scan on CPU tensors, where torch's fused
    RNN runs its own CPU code."""
    H = int(state_size)
    num_layers = int(num_layers)
    num_dir = 2 if bidirectional else 1
    weights = split_params(parameters.reshape(-1), mode, num_layers, num_dir,
                           data.shape[2], H)
    # one call over the whole stack, or one a layer with a dropout mask
    # between them
    dropout = p > 0.0 and training and num_layers > 1
    groups = ([range(l, l + 1) for l in range(num_layers)] if dropout
              else [range(num_layers)])
    x = data
    h_fin, c_fin = [], []
    for layers in groups:
        if layers.start > 0:
            keep = 1.0 - p
            mask = torch.bernoulli(torch.full(x.shape, keep, device=x.device),
                                   generator=key).to(x.dtype)
            x = x * mask / keep
        s = slice(layers.start * num_dir, layers.stop * num_dir)
        c0 = cell0[s] if cell0 is not None else None
        if data.device.type != "meta":
            _PASSES[route] += 1
        if route == "cudnn":
            x, h, c = run_fused(x, state[s], c0, weights, mode, layers,
                                num_dir)
        else:
            x, h, c = run_scan(x, state[s], c0, weights, mode, layers,
                               num_dir, clip_min, clip_max)
        h_fin += h
        c_fin += c

    if not state_outputs:
        return x
    h_out = torch.stack(h_fin, dim=0)
    if mode == "lstm":
        return x, h_out, torch.stack(c_fin, dim=0)
    return x, h_out


@register("RNN", rng=True, train_aware=True,
          input_names=("data", "parameters", "state", "state_cell"))
def _rnn(key, data, parameters, state, *maybe_cell, state_size=0,
         num_layers=1, bidirectional=False, mode="lstm", p=0.0,
         state_outputs=False, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         _training=True, **_):
    """Fused multi-layer (bi)directional RNN over time-major (T, N, I)
    data.  Returns ``output`` — plus the final ``state`` (and
    ``state_cell`` for LSTM) when ``state_outputs`` is set, the
    reference's output list."""
    clip = ((lstm_state_clip_min, lstm_state_clip_max) if mode == "lstm"
            else (None, None))
    route = choose_route(data, *clip)
    if data.device.type != "meta":
        _CALLS[(route, dtype_name(data.dtype), mode)] += 1
    cell0 = maybe_cell[0] if (mode == "lstm" and maybe_cell) else None
    return rnn_forward(route, key, data, parameters, state, cell0,
                       state_size=state_size, num_layers=num_layers,
                       bidirectional=bidirectional, mode=mode, p=p,
                       state_outputs=state_outputs, clip_min=clip[0],
                       clip_max=clip[1], training=_training)
