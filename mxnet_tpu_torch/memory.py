"""Device-memory accounting: a live buffer census by category.

The port of `mxnet_tpu/memory.py`, the truth plane behind the port's
memory claims (a generation engine pins one KV slab; a Predictor's
buckets share their weights; the fused step updates weights in place):

* **categories**: every long-lived device buffer the port owns is
  registered under one of ``weights`` / ``optimizer_state`` /
  ``gradients`` / ``serving_batches`` / ``kv_cache`` (a generation
  engine's slab and a checkpoint draft's own slab, as live-view
  providers; prefix-cache entries are rows of the slab, so they add no
  bytes). Registration is by weak reference: a provider or tensor that
  dies drops out, and tracking never extends a buffer's life.
* **census** (:func:`census`): walks the registrations and counts each
  storage once, by ``untyped_storage().data_ptr()`` (the JAX package's
  `_buffer_key`): two arrays over one storage (a Predictor's buckets
  bound to shared weights) count once, at the storage's size. It
  publishes ``memory.<cat>_bytes`` gauges; ``live_total`` is
  `torch.cuda.memory_allocated` on a card, and ``other`` what the
  categories do not explain.
* **capacity** (:func:`device_capacity_bytes`): the card's total bytes
  from `torch.cuda.mem_get_info`, or ``MXNET_DEVICE_HBM_BYTES``; with it
  the census publishes ``memory.headroom_bytes``.
* **per-program memory** (:func:`executable_stats`): each cache's entries
  with their counted cost (`compile_cache`), and the allocator's view of
  the card (`torch.cuda.memory_stats`: allocated, reserved and peak
  bytes, the CUDA graphs' private pools included). XLA's per-executable
  memory analysis has no counterpart for a CUDA graph.

The census and capacity read the device named (default ``cuda``): with no
card and no explicit ``device="cpu"`` they raise. The census runs on
demand (``/memory``, ``prom_text()``, tests), never on the step path.
"""
from __future__ import annotations

import threading
import weakref

from . import analysis
from . import telemetry
from .base import MXNetError, getenv, register_env

__all__ = ["CATEGORIES", "track", "track_transient", "register_provider",
           "census", "update_gauges", "executable_stats", "clear",
           "device_capacity_bytes"]

register_env("MXNET_DEVICE_HBM_BYTES", 0,
             "per-device memory capacity override in bytes for the "
             "memory.headroom_bytes gauge; 0 = the card's own total")

CATEGORIES = ("weights", "optimizer_state", "gradients", "serving_batches",
              "kv_cache")

_lock = analysis.make_lock("memory.census")
# category -> list of weakref.ref to NDArray / tensor (long-lived)
_tracked = {c: [] for c in CATEGORIES}
# category -> list of (weakref to owner, getter(owner) -> iterable)
_providers = {c: [] for c in CATEGORIES}
_SWEEP_FLOOR = 4096
_sweep_at = {c: _SWEEP_FLOOR for c in CATEGORIES}


def clear():
    """Drop every registration (tests)."""
    with _lock:
        for c in CATEGORIES:
            _tracked[c] = []
            _providers[c] = []
            _sweep_at[c] = _SWEEP_FLOOR


def track(category, arrays):
    """Register long-lived buffers under ``category`` (an NDArray, a
    tensor, or an iterable of them), weakly."""
    if category not in _tracked:
        raise ValueError(f"unknown memory category {category!r} "
                         f"(one of {CATEGORIES})")
    if not isinstance(arrays, (list, tuple, set)):
        arrays = [arrays]
    refs = []
    for a in arrays:
        try:
            refs.append(weakref.ref(a))
        except TypeError:
            pass
    with _lock:
        cur = _tracked[category]
        cur.extend(refs)
        if len(cur) > _sweep_at[category]:
            kept = [r for r in cur if r() is not None]
            _tracked[category] = kept
            _sweep_at[category] = max(_SWEEP_FLOOR, 2 * len(kept))


# transient buffers (a serving batch in flight) use the same list; the
# distinct name keeps call sites honest about lifetime
track_transient = track


def register_provider(category, owner, getter):
    """Register a live view: ``getter(owner)`` enumerates the category's
    current buffers at census time. ``owner`` is weakly held."""
    if category not in _providers:
        raise ValueError(f"unknown memory category {category!r} "
                         f"(one of {CATEGORIES})")
    with _lock:
        _providers[category].append((weakref.ref(owner), getter))


def _unwrap(obj):
    """NDArray -> its tensor; tensors pass through."""
    data = getattr(obj, "_data", None)
    return data if data is not None else obj


def _buffer_key(t):
    """Identity for dedup: the storage's device and address."""
    return (str(t.device), t.untyped_storage().data_ptr())


def _iter_category(category):
    """Live buffers of one category: swept tracked refs and provider
    views (the getters run outside the lock)."""
    live = []
    with _lock:
        cur = _tracked[category]
        kept = []
        for r in cur:
            o = r()
            if o is not None:
                live.append(o)
                kept.append(r)
        if len(kept) != len(cur):
            _tracked[category] = kept
            _sweep_at[category] = max(_SWEEP_FLOOR, 2 * len(kept))
        kept_p = [(ref, getter) for ref, getter in _providers[category]
                  if ref() is not None]
        _providers[category] = kept_p
    for ref, getter in kept_p:
        owner = ref()
        if owner is None:
            continue
        try:
            live.extend(getter(owner) or [])
        except Exception:  # noqa: BLE001 - a dying provider must not kill
            pass           # the census
    return live


def _resolve(device):
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("memory: no CUDA device; pass device='cpu' for a "
                         "census of host tensors")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def census(update=True, device=None):
    """One memory snapshot of ``device`` (default ``cuda``)::

        {"categories": {cat: {"total", "per_device_max", "buffers"}},
         "per_device": {device: categorized bytes},
         "live_total": bytes the allocator holds live (the categorized
                       bytes on the CPU),
         "other": live_total - categorized, "device_count": N}

    plus ``capacity_bytes`` and ``headroom_bytes`` where the capacity is
    known. Each storage counts once, at its full size. ``update`` also
    publishes the ``memory.*`` gauges."""
    import torch

    dev = _resolve(device)
    seen = set()
    cats = {}
    per_device = {}
    categorized = 0
    for cat in CATEGORIES:
        total = n = 0
        for obj in _iter_category(cat):
            t = _unwrap(obj)
            if not isinstance(t, torch.Tensor) or t.device.type != dev.type:
                continue
            key = _buffer_key(t)
            if key in seen:
                continue
            seen.add(key)
            nb = int(t.untyped_storage().nbytes())
            n += 1
            total += nb
            per_device[str(t.device)] = per_device.get(str(t.device), 0) + nb
        categorized += total
        cats[cat] = {"total": total, "per_device_max": total, "buffers": n}
    live_total = (int(torch.cuda.memory_allocated(dev))
                  if dev.type == "cuda" else categorized)
    out = {"categories": cats, "per_device": per_device,
           "live_total": live_total,
           "other": max(0, live_total - categorized),
           "device_count": len(per_device)}
    cap = device_capacity_bytes(dev)
    if cap:
        used = max(per_device.values()) if per_device else 0
        out["capacity_bytes"] = cap
        out["headroom_bytes"] = cap - used - out["other"]
    if update:
        _publish(out)
    return out


def device_capacity_bytes(device=None):
    """The device's total memory in bytes: ``MXNET_DEVICE_HBM_BYTES`` when
    set, else `torch.cuda.mem_get_info`'s total on a card, else 0 (the
    CPU: headroom unpublished)."""
    import torch

    cap = int(getenv("MXNET_DEVICE_HBM_BYTES"))
    if cap:
        return cap
    dev = _resolve(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return 0


def _publish(snap):
    """The gauges, recorded with telemetry off too (as ``compile.*``)."""
    for cat, v in snap["categories"].items():
        telemetry.gauge(f"memory.{cat}_bytes").set(v["per_device_max"])
        telemetry.gauge(f"memory.{cat}_bytes_total").set(v["total"])
    telemetry.gauge("memory.other_bytes").set(snap["other"])
    telemetry.gauge("memory.live_bytes_total").set(snap["live_total"])
    if "headroom_bytes" in snap:
        telemetry.gauge("memory.headroom_bytes").set(snap["headroom_bytes"])
        telemetry.gauge("memory.capacity_bytes").set(snap["capacity_bytes"])


def update_gauges(device=None):
    """Refresh the ``memory.*`` gauges from a fresh census."""
    return census(update=True, device=device)


_ALLOCATOR_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                   "reserved_bytes.all.current", "reserved_bytes.all.peak",
                   "num_alloc_retries", "num_ooms")


def executable_stats(device=None):
    """``{cache name: [{key, flops, bytes_accessed, dtype, captures}]}``
    over every live `CompileCache` entry with a cost record, and on a card
    ``"allocator"``: the allocator's current and peak allocated and
    reserved bytes (the graphs' private pools included)."""
    import torch

    from . import compile_cache

    out = {}
    for c in compile_cache.all_caches():
        rows = c.memory_stats()
        if rows:
            out.setdefault(c.name, []).extend(rows)
    dev = _resolve(device)
    if dev.type == "cuda":
        st = torch.cuda.memory_stats(dev)
        out["allocator"] = {k: int(st.get(k, 0)) for k in _ALLOCATOR_KEYS}
    return out
