"""NDArray save/load: the port of `mxnet_tpu/ndarray/utils.py`, byte for byte
the same container, so a file saved by either package loads in the other.

Layout (little-endian): the magic ``0x112`` and a version word (uint64
each), the array count, then per array its dtype flag (int32), ndim
(uint32), shape (int64 each) and raw bytes; then the name count and each
name as length + UTF-8. Version 0 is the reference's layout; version 1,
which `save` writes, follows every payload with a (crc32 uint32, length
int64) footer that `load` verifies. A short or corrupt file raises
`CorruptCheckpointError`. bfloat16, which has no dtype flag, is written as
float32, as the JAX package writes it.

With telemetry on: ``checkpoint.saves`` / ``save_bytes`` /
``write_us`` and ``checkpoint.loads`` / ``load_bytes`` / ``load_us``, and
``checkpoint.corrupt`` for a file that fails its checks.
"""
from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as _np

from .. import telemetry
from ..base import MXNetError, _DTYPE_MX_TO_NP, _DTYPE_NP_TO_MX, getenv, \
    register_env
from ..resilience import CorruptCheckpointError

__all__ = ["save", "load", "CorruptCheckpointError"]

_MAGIC = 0x112
_VERSION = 1  # 0 = reference layout, 1 = + per-array CRC footers

register_env("MXNET_CHECKPOINT_VERIFY", True,
             "verify per-array CRC32 footers on load")


def _as_numpy(arr):
    return arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)


def _write_array(f, npv):
    flag = _DTYPE_NP_TO_MX.get(npv.dtype.type)
    if flag is None:
        npv = npv.astype(_np.float32)
        flag = 0
    f.write(struct.pack("<i", flag))
    f.write(struct.pack("<I", npv.ndim))
    for s in npv.shape:
        f.write(struct.pack("<q", s))
    raw = _np.ascontiguousarray(npv).tobytes()
    f.write(raw)
    f.write(struct.pack("<Iq", zlib.crc32(raw) & 0xFFFFFFFF, len(raw)))


def _read_exact(f, n, fname):
    buf = f.read(n)
    if len(buf) != n:
        raise CorruptCheckpointError(
            f"{fname}: truncated array file (wanted {n} bytes, got "
            f"{len(buf)})")
    return buf


def _read_array(f, fname, has_footer, verify):
    (flag,) = struct.unpack("<i", _read_exact(f, 4, fname))
    (ndim,) = struct.unpack("<I", _read_exact(f, 4, fname))
    shape = tuple(struct.unpack("<q", _read_exact(f, 8, fname))[0]
                  for _ in range(ndim))
    if flag not in _DTYPE_MX_TO_NP or flag < 0:
        raise CorruptCheckpointError(f"{fname}: bad dtype flag {flag}")
    if any(s < 0 for s in shape):
        raise CorruptCheckpointError(f"{fname}: negative shape {shape}")
    dt = _np.dtype(_DTYPE_MX_TO_NP[flag])
    total = (int(_np.prod(shape)) if shape else 1) * dt.itemsize
    buf = _read_exact(f, total, fname)
    if has_footer:  # footer bytes are part of the v1 layout even unverified
        want, length = struct.unpack("<Iq", _read_exact(f, 12, fname))
        if verify and (length != total
                       or (zlib.crc32(buf) & 0xFFFFFFFF) != want):
            raise CorruptCheckpointError(
                f"{fname}: CRC mismatch on array payload — checkpoint is "
                "corrupt")
    return _np.frombuffer(buf, dtype=dt).reshape(shape)


def save(fname, data):
    """Save an NDArray, a list or a dict of NDArrays (parity `mx.nd.save`).
    The file is written to a temporary name and renamed, so a reader sees
    the old file or the whole new one."""
    from .ndarray import NDArray

    if isinstance(data, NDArray):
        names, arrays = [], [data]
    elif isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise MXNetError("save expects NDArray, list or dict of NDArrays")
    snaps = [_as_numpy(a) for a in arrays]
    tele = telemetry._enabled
    t0 = time.perf_counter() if tele else 0.0
    if tele:
        telemetry.counter("checkpoint.saves").inc()
        telemetry.counter("checkpoint.save_bytes").inc(
            sum(a.nbytes for a in snaps))
    tmp = fname + ".tmp~"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", _MAGIC))
        f.write(struct.pack("<Q", _VERSION))
        f.write(struct.pack("<Q", len(snaps)))
        for a in snaps:
            _write_array(f, a)
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)
    if tele:
        telemetry.histogram("checkpoint.write_us").record(
            (time.perf_counter() - t0) * 1e6)


def load(fname, ctx=None):
    """Load arrays saved by `save` or by the JAX package: a list, or a dict
    when the file has names. Version-1 footers are verified unless
    ``MXNET_CHECKPOINT_VERIFY=0``. ``ctx`` defaults to the current
    context."""
    from .ndarray import array

    verify = bool(getenv("MXNET_CHECKPOINT_VERIFY"))
    tele = telemetry._enabled
    t0 = time.perf_counter() if tele else 0.0
    try:
        raw, names = _read_file(fname, verify)
    except CorruptCheckpointError:
        if tele:
            telemetry.counter("checkpoint.corrupt").inc()
        raise
    if tele:
        telemetry.counter("checkpoint.loads").inc()
        telemetry.counter("checkpoint.load_bytes").inc(
            sum(npv.nbytes for npv in raw))
        telemetry.histogram("checkpoint.load_us").record(
            (time.perf_counter() - t0) * 1e6)
    arrays = [array(npv, ctx=ctx, dtype=npv.dtype) for npv in raw]
    if not names:
        return arrays
    return dict(zip(names, arrays))


def _read_file(fname, verify):
    """The arrays (numpy) and names of one file."""
    with open(fname, "rb") as f:
        (magic,) = struct.unpack("<Q", _read_exact(f, 8, fname))
        if magic != _MAGIC:
            raise MXNetError(f"Invalid NDArray file format: {fname}")
        (version,) = struct.unpack("<Q", _read_exact(f, 8, fname))
        (n,) = struct.unpack("<Q", _read_exact(f, 8, fname))
        raw = [_read_array(f, fname, version >= 1, verify) for _ in range(n)]
        (nn,) = struct.unpack("<Q", _read_exact(f, 8, fname))
        names = []
        for _ in range(nn):
            (ln,) = struct.unpack("<Q", _read_exact(f, 8, fname))
            try:
                names.append(_read_exact(f, ln, fname).decode())
            except UnicodeDecodeError as e:
                raise CorruptCheckpointError(
                    f"{fname}: undecodable array name") from e
    return raw, names
