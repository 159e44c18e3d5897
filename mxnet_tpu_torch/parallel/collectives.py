"""Collectives over the positions of a mesh that one process holds: the
counterpart of `mxnet_tpu/parallel/collectives.py`, cut to what ring
attention needs.

In the JAX package a collective runs inside `shard_map`, each position
holding its own shard. Here one process holds every position's shard, as a
list in position order, and a collective maps that list to a new one.
"""
from __future__ import annotations

__all__ = ["ring_shift"]


def ring_shift(shards, shift=1):
    """One hop around the ring: position r receives position (r - shift)'s
    shard, as `lax.ppermute` with ``perm = [(i, (i + shift) % n)]`` does.
    Each shard is moved to the device of the position it reaches (the
    device its current shard lies on), with a device-to-device copy where
    that device differs and none where it is the same. Differentiable: the
    gradient travels back the other way."""
    n = len(shards)
    return [shards[(r - shift) % n].to(shards[r].device) for r in range(n)]
