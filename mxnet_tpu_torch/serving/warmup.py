"""Build-ahead warmup: pay every program's build before traffic exists.

The port of `mxnet_tpu/serving/warmup.py`. A server that builds lazily pays
the build (on the card, a CUDA-graph capture) on the first unlucky user
request of each shape. Warmup runs a zeros batch through every bucket of a
`Predictor` (or of a `DynamicBatcher`'s predictor), or builds every
program of a `GenerationEngine` (or of each engine behind a
`GenerationRouter`), so steady state builds nothing.
"""
from __future__ import annotations

import time

from ..log import get_logger

__all__ = ["warmup"]


def warmup(target, buckets=None):
    """Build every program of ``target`` ahead of traffic.

    ``target`` is a `Predictor` or `DynamicBatcher` (one forward program
    per batch bucket) or a `GenerationEngine` or `GenerationRouter` (one
    prefill program per prompt-length bucket plus THE decode program, and
    the programs of the enabled lanes, per replica: `GenerationEngine.warm`);
    anything else raises TypeError. Returns ``{"buckets", "compiles", "seconds",
    "cache_entries"}`` (an engine's or router's also has ``"captures"``):
    ``compiles`` is the exact number of new programs built (the
    cache-miss delta; on a card, graphs captured), so a second call
    reports 0."""
    if hasattr(target, "prefill_buckets") or any(
            hasattr(e, "prefill_buckets")
            for e in getattr(target, "engines", ())):
        return target.warm(buckets)
    pred = getattr(target, "predictor", target)
    if not hasattr(pred, "warm_bucket"):
        raise TypeError("warmup takes a Predictor, a DynamicBatcher or a "
                        f"GenerationEngine, got {type(target).__name__}")
    buckets = (pred.buckets if buckets is None
               else tuple(sorted({int(b) for b in buckets})))
    cache = pred.cache
    misses0 = cache.misses
    t0 = time.perf_counter()
    for b in buckets:
        pred.warm_bucket(b)
    compiles = cache.misses - misses0
    seconds = time.perf_counter() - t0
    pred._warmed = True           # readiness: warm-up complete
    get_logger("mxnet_tpu_torch.serving").info(
        "serving warmup: %d bucket(s) -> %d build(s) in %.2fs "
        "(cache %r now holds %d programs)",
        len(buckets), compiles, seconds, cache.name, len(cache))
    return {"buckets": list(buckets), "compiles": compiles,
            "seconds": seconds, "cache_entries": len(cache)}
