"""Device mesh: the counterpart of `mxnet_tpu/parallel/mesh.py`, cut to
what ring attention needs.

The JAX package is single-controller: one process drives every position of
a `jax.sharding.Mesh` through `shard_map`. The port keeps that model in one
process. A `DeviceMesh` names the device of each position; positions may
share a device (all four `sp` positions of a ring on one card, as the JAX
package's tests put them on virtual host devices), and then a shard moves
between them without a copy. Only the `sp` axis is carried (with every
other axis of size 1); data, tensor, fully-sharded, pipeline and expert
parallelism over the mesh are later slices of the port.
"""
from __future__ import annotations

import math

import torch

from ..context import resolve_device

__all__ = ["AXIS_DP", "AXIS_FSDP", "AXIS_TP", "AXIS_SP", "AXIS_PP",
           "AXIS_EP", "DeviceMesh", "axis_size", "create_mesh"]

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"
AXIS_EP = "ep"

_STANDARD_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_PP, AXIS_EP)


class DeviceMesh:
    """Named axes over positions, each position on one device.

    `shape` maps each axis to its size, in order; `devices` lists the device
    of each position in row-major order over the axes."""

    def __init__(self, shape, devices):
        self.shape = dict(shape)
        self.devices = [torch.device(d) for d in devices]
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh {self.shape} has "
                             f"{math.prod(self.shape.values())} positions "
                             f"but {len(self.devices)} devices were given")

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, "
                f"devices=[{', '.join(map(str, self.devices))}])")


def create_mesh(devices=None, **axes):
    """A `DeviceMesh`: ``create_mesh(devices=["cuda:0"] * 4, sp=4)``.

    `devices` lists the device of each position (default: every CUDA card,
    one position each); a device may repeat. Axis sizes multiply to the
    number of positions; no axes means ``dp`` over all of them, as in the
    JAX package. Raises NotImplementedError for an axis other than `sp`
    with a size above 1."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(
            torch.cuda.device_count() if torch.cuda.is_available() else 1)]
    devices = [resolve_device(d) for d in devices]
    sizes = dict(axes or {AXIS_DP: len(devices)})
    unknown = [a for a in sizes if a not in _STANDARD_AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                         f"{_STANDARD_AXES}")
    bad = {a: n for a, n in sizes.items() if n < 1}
    if bad:
        raise ValueError(f"mesh axis sizes must be positive, got {bad}")
    later = {a: n for a, n in sizes.items() if n > 1 and a != AXIS_SP}
    if later:
        raise NotImplementedError(
            f"mesh axes {later}: the port carries only the 'sp' axis (ring "
            "attention) so far; dp, tp and fsdp with sp are a later slice of "
            "the port")
    return DeviceMesh(sizes, devices)


def axis_size(mesh, axis):
    """Size of `axis` in `mesh`; 1 when the mesh is None or lacks it."""
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))
