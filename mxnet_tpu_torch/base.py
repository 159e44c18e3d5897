"""The port's error type and environment knobs: the counterpart of
`mxnet_tpu/base.py`, cut to what the port raises and reads."""
from __future__ import annotations

import os
import threading

__all__ = ["MXNetError", "register_env", "getenv"]


class MXNetError(RuntimeError):
    """Default error raised by the port (the name of the reference's
    ``mxnet.base.MXNetError``, kept so user code catches the same type on
    either package)."""


_env_lock = threading.Lock()
_env_registry = {}


def register_env(name, default, doc=""):
    """Declare an ``MXNET_*`` knob with its default; returns the name."""
    with _env_lock:
        _env_registry[name] = (default, doc)
    return name


def getenv(name, default=None):
    """The knob's value from the environment, parsed to the type of its
    default (a bool knob is false for "0", "false", "False" and ""), or the
    default when unset. `default` overrides the registered one."""
    if default is None and name in _env_registry:
        default = _env_registry[name][0]
    val = os.environ.get(name)
    if val is None:
        return default
    if isinstance(default, bool):
        return val not in ("0", "false", "False", "")
    if isinstance(default, int):
        return int(val)
    if isinstance(default, float):
        return float(val)
    return val
