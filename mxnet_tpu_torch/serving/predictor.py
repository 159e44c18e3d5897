"""The port of `mxnet_tpu/serving/predictor.py`, cut to `bucket_ladder`,
which the generation engine's prefill ladder parses through. The
`Predictor` itself is not ported yet."""
from __future__ import annotations

from ..base import MXNetError, getenv

__all__ = ["bucket_ladder"]


def bucket_ladder(buckets=None, env_var="MXNET_SERVING_BUCKETS"):
    """Normalize a bucket spec (None -> the `env_var` knob, a
    comma-separated string, or any int iterable) into an ascending,
    deduplicated tuple of positive sizes. `env_var` names the knob in error
    messages."""
    if buckets is None:
        buckets = getenv(env_var)
        if buckets is None:
            raise MXNetError(f"no buckets given and {env_var} is not set")
    if isinstance(buckets, str):
        try:
            buckets = [int(tok) for tok in buckets.replace(" ", "").split(",")
                       if tok]
        except ValueError:
            raise MXNetError(
                f"{env_var} must be comma-separated ints, got {buckets!r}")
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise MXNetError(f"serving buckets must be positive ints, got {out}")
    return out
