"""Random state: the port of `mxnet_tpu/random.py`.

One `torch.Generator` per device, made at its first use from the last seed
(0 until `seed` is called). Ops that draw random numbers (``needs_rng``,
e.g. Dropout) take the generator of their inputs' device. The streams are
torch's (Philox on a CUDA card, MT19937 on the host), so they do not match
the JAX package's threefry draws bit for bit, as the JAX package's do not
match the reference's.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = 0
_generators: dict[torch.device, torch.Generator] = {}


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device):
    """The generator that ops on ``device`` draw from; None on the
    ``meta`` device, where shape inference draws nothing."""
    key = _key(device)
    if key.type == "meta":
        return None
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = _generators[key] = torch.Generator(device=key)
            gen.manual_seed(_seed)
    return gen


def seed(seed_state, ctx="all"):
    """Seed the generators (parity `mxnet.random.seed`): every device's
    when ``ctx`` is ``"all"``, else only the generator of that Context."""
    global _seed
    seed_state = int(seed_state)
    with _lock:
        if ctx == "all":
            _seed = seed_state
            for gen in _generators.values():
                gen.manual_seed(seed_state)
            return
    generator(ctx.torch_device).manual_seed(seed_state)
