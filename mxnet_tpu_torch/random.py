"""Global random state: one ``torch.Generator`` per device.

Counterpart: ``mxnet_tpu/random.py``, which keeps one JAX root key and
folds a counter into it for every call.  Here each device the port
draws on has its own explicit ``torch.Generator`` (the reference's
per-device RNG resource, ``src/resource.cc`` kRandom); :func:`seed`
reseeds every one of them, and a generator made later for another
device starts from the same seed.  Ops that draw (``rng=True`` in the
registry: the samplers of ``ops/random_ops.py``, ``Dropout``) get the
generator of their output's device from ``nd.invoke``.

Draws differ from the JAX package's for the same seed (another
generator), so parity tests compare distributions, never draws.

:func:`get_state` / :func:`set_state` snapshot and restore the whole
random state bit for bit: the seed and every generator's state.  A
checkpoint carries it (``checkpoint.rng_state``), and a remat scope
replays it for its recompute (``remat.checkpoint``).
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from .base import as_shape, dtype_name

__all__ = ["seed", "uniform", "normal", "randint", "get_state",
           "set_state"]

_lock = threading.Lock()
_seed_state = 0
_generators: Dict[torch.device, torch.Generator] = {}


def seed(seed_state: int, ctx=None) -> None:
    """ref: python/mxnet/random.py seed -> MXRandomSeed.  Reseeds the
    generator of every device (``ctx`` is accepted and, as in the JAX
    package, every device is reseeded)."""
    global _seed_state
    with _lock:
        _seed_state = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed_state)


def generator(device: torch.device) -> torch.Generator:
    """The generator of ``device``, made (and seeded) at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed_state)
            _generators[device] = gen
        return gen


def get_state() -> dict:
    """The random state: ``{"seed": int, "generators": {device string:
    uint8 state tensor}}``.  A draw after ``set_state(get_state())``
    repeats the draw that would have come."""
    with _lock:
        return {"seed": _seed_state,
                "generators": {str(d): g.get_state()
                               for d, g in _generators.items()}}


def set_state(state: dict) -> None:
    """Restore a :func:`get_state` snapshot.  A generator it names that
    does not exist yet is made first; one it does not name is reseeded
    with its seed, the state such a generator starts from.  A device
    this process cannot reach (a card's generator on a machine without
    one) is skipped: nothing here can draw on it."""
    global _seed_state
    gens = state.get("generators") or {}
    for dev in gens:
        d = torch.device(dev)
        if d.type != "cuda" or torch.cuda.is_available():
            generator(d)
    with _lock:
        _seed_state = int(state["seed"])
        for d, gen in _generators.items():
            s = gens.get(str(d))
            if s is None:
                gen.manual_seed(_seed_state)
            else:
                gen.set_state(torch.as_tensor(s, dtype=torch.uint8)
                              .cpu())


def _shape_from_out(shape, out):
    """``out=`` with no explicit shape samples at ``out``'s shape (ref:
    python/mxnet/random.py _random_helper)."""
    if out is not None and (shape == () or shape is None):
        return tuple(out.shape)
    return shape


def _draw(op, params, shape, dtype, ctx, out):
    from .ndarray import ndarray as _nd

    params = dict(params, shape=as_shape(_shape_from_out(shape, out)),
                  dtype=dtype_name(dtype))
    return _nd.invoke(op, [], params, out=out, ctx=ctx)


def uniform(low=0.0, high=1.0, shape=(), dtype=None, ctx=None, out=None):
    return _draw("_random_uniform", {"low": float(low), "high": float(high)},
                 shape, dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=(), dtype=None, ctx=None, out=None):
    return _draw("_random_normal", {"loc": float(loc),
                                    "scale": float(scale)},
                 shape, dtype, ctx, out)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return _draw("_random_randint", {"low": int(low), "high": int(high)},
                 shape, dtype, ctx, out)
