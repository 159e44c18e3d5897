"""Device contexts: the counterpart of `mxnet_tpu/context.py`.

A `Context` names a real `torch.device`: ``cpu()`` is the host and
``gpu(i)`` is CUDA card ``i``. ``with ctx:`` makes it the default for array
creation in this thread. The default context is ``gpu(0)``, so without a
card an array made with no explicit ``cpu()`` raises. This differs from the
JAX package on purpose: there the default is ``cpu()``, which its arrays
quietly place on the accelerator anyway; here ``cpu()`` means the host.
`tpu()` raises. The device-type numbering keeps the reference's values
(cpu=1, gpu=2, cpu_pinned=3, cpu_shared=5).

`resolve_device` is the entry points' older form of the same rule, for the
modules that take a ``device=`` argument.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "resolve_device"]

_devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
_devstr2type = {v: k for k, v in _devtype2str.items()}


class Context:
    """A device context. ``with mx.gpu(0):`` sets the default device for
    array creation in this thread."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type == "tpu":
                raise MXNetError(
                    "the PyTorch port has no tpu context; use mx.gpu() for a "
                    "CUDA card or mx.cpu() for the host")
            self.device_typeid = _devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return _devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The `torch.device` this context names. Raises MXNetError for a
        gpu context when no such card is present."""
        if self.device_typeid != 2:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self}: no CUDA device is available; pass ctx=mx.cpu() to "
                "run on the host")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self} does not name an available device "
                             f"({torch.cuda.device_count()} present)")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def empty_cache(self):
        """Return the card's cached blocks to the driver."""
        if self.device_typeid == 2 and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Raises MXNetError: the port runs on CUDA cards (`gpu`)."""
    return Context("tpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The thread's default context: the innermost ``with ctx:``, else
    ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    if ctx is None:
        ctx = Context._default_ctx.value = gpu(0)
    return ctx


def context_of(device):
    """The Context of a `torch.device`."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu(0)


def resolve_device(device=None) -> torch.device:
    """Return the device an entry point runs on: ``cuda`` when ``device`` is
    None, else ``device`` itself. Raises RuntimeError when that device is a
    CUDA device and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
