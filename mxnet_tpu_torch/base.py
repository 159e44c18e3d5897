"""The port's error type: the counterpart of `mxnet_tpu/base.py`, cut to
what the port raises."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Default error raised by the port (the name of the reference's
    ``mxnet.base.MXNetError``, kept so user code catches the same type on
    either package)."""
