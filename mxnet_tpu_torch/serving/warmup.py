"""Build-ahead warmup: pay every program's build before traffic exists.

The port of `mxnet_tpu/serving/warmup.py`, for the generation engine: one
prefill program per prompt-length bucket plus THE decode program, each a
CUDA-graph capture on the card, so the first unlucky user request of a
bucket never pays one.
"""
from __future__ import annotations

__all__ = ["warmup"]


def warmup(target, buckets=None):
    """Build every program of `target`, a `GenerationEngine`, ahead of
    traffic. Returns ``{"buckets", "compiles", "captures", "seconds",
    "cache_entries"}``: ``compiles`` is the exact number of new programs
    built (the cache-miss delta), so a second call reports 0. The port has
    no `Predictor` or batcher yet, so any other target raises TypeError."""
    if not hasattr(target, "prefill_buckets"):
        raise TypeError(f"warmup takes a GenerationEngine, got "
                        f"{type(target).__name__}")
    return target.warm(buckets)
