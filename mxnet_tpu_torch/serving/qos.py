"""Multi-tenant QoS: priority classes, quotas and the preemption policy.

The port's own copy of `mxnet_tpu/serving/qos.py` (it imports nothing of
the device). Every queue of the serving stack is oldest-first by default,
the right policy for exactly one tenant; once a fleet serves many, one
bulk tenant's backlog starves every interactive tenant's time to first
token. This module is the policy layer both serving stacks consult:

* **tenant registry**: ``MXNET_QOS_SPEC`` declares tenants as
  ``name:class[:rps=N,tps=N,weight=N]`` entries (``;``-separated), with
  ``class`` one of ``interactive`` / ``standard`` / ``batch``. Unknown
  (or anonymous) tenants land in ``MXNET_QOS_DEFAULT_CLASS``. The spec is
  read ONCE, at the first `active` call: build servers after setting it
  (or use `install`);
* **class-ordered, deadline-aware admission**: with a registry active,
  `admission.AdmissionQueue` pops by ``(class rank, earliest deadline,
  enqueue time)`` instead of FIFO, and a batch request waiting longer
  than ``MXNET_QOS_AGING_S`` is promoted to standard rank;
* **quotas**: per-tenant request-rate (``rps``) and token-rate (``tps``)
  token buckets. An over-quota submit fails synchronously with
  `QuotaExceededError`. Tokens are charged as they are DELIVERED
  (`TenantRegistry.charge_tokens`), so a tenant over its token budget
  cannot admit new sessions until the bucket refills;
* **preemption policy**: ``weight`` (by class: interactive 2.0, standard
  1.0, batch 0.25) feeds the fairness-weighted autoscale demand, and the
  class ranks drive the generation engine's park, preempt and resume
  decisions (``MXNET_QOS_PARK_SLOTS`` slab rows; see the engine);
* **per-tenant SLO rows**: `attach_slo` adds one
  ``qos.ttft_us|tenant=<name>:p99<target>`` objective a declared tenant
  to the health layer's burn tracker.

Everything here is off by default: with no spec and no `install`,
`active` returns None and every call site takes its path without QoS,
unchanged (the same FIFO order and the same programs).
"""
from __future__ import annotations

import collections
import time

from .. import analysis
from .. import telemetry
from ..base import MXNetError, getenv, register_env
from .admission import ServingError

__all__ = ["QuotaExceededError", "TenantSpec", "TenantRegistry", "CLASSES",
           "BATCH_RANK", "parse_spec", "active", "install", "clear",
           "labeled_metric", "attach_slo"]

register_env("MXNET_QOS_SPEC", "",
             "multi-tenant QoS spec: ';'-separated "
             "'name:class[:rps=N,tps=N,weight=N]' entries (class one of "
             "interactive|standard|batch); empty = QoS layer off "
             "(FIFO admission, no quotas, no preemption)")
register_env("MXNET_QOS_DEFAULT_CLASS", "standard",
             "priority class for tenants the MXNET_QOS_SPEC does not "
             "declare (and for untenanted requests)")
register_env("MXNET_QOS_PARK_SLOTS", 1,
             "KV-slab slots each generation engine reserves as the "
             "preemption park region when QoS is active (0 disables "
             "preemption; ignored — and no slots reserved — while QoS "
             "is off)")
register_env("MXNET_QOS_AGING_S", 30.0,
             "anti-starvation aging: a batch-class request queued longer "
             "than this many seconds is promoted to standard rank "
             "(0 disables aging)")

CLASSES = ("interactive", "standard", "batch")
_RANK = {"interactive": 0, "standard": 1, "batch": 2}
BATCH_RANK = _RANK["batch"]
# class-default fairness weights (autoscale demand) and TTFT p99 SLO
# targets (attach_slo) — an explicit per-tenant weight overrides
_CLASS_WEIGHT = {"interactive": 2.0, "standard": 1.0, "batch": 0.25}
_CLASS_TTFT_MS = {"interactive": 500.0, "standard": 2000.0,
                  "batch": 10000.0}


class QuotaExceededError(ServingError):
    """The tenant is over its request-rate (or token-rate) quota. Raised
    synchronously from ``submit()`` — the cheap per-tenant analog of
    ``QueueFullError``: shed or defer THIS tenant's load now instead of
    letting it crowd the shared queue."""


class TenantSpec:
    """One tenant's QoS contract: priority class, quotas, weight."""

    __slots__ = ("name", "cls", "rank", "rps", "tps", "weight")

    def __init__(self, name, cls, rps=None, tps=None, weight=None):
        if cls not in _RANK:
            raise MXNetError(
                f"QoS class {cls!r} for tenant {name!r} not one of "
                f"{'|'.join(CLASSES)}")
        for label, v in (("rps", rps), ("tps", tps), ("weight", weight)):
            if v is not None and not v > 0:
                raise MXNetError(
                    f"QoS {label} for tenant {name!r} must be > 0, "
                    f"got {v!r}")
        self.name = name
        self.cls = cls
        self.rank = _RANK[cls]
        self.rps = None if rps is None else float(rps)
        self.tps = None if tps is None else float(tps)
        self.weight = (_CLASS_WEIGHT[cls] if weight is None
                       else float(weight))


def parse_spec(text):
    """Parse an ``MXNET_QOS_SPEC`` string into ``{name: TenantSpec}``."""
    tenants = {}
    for entry in (text or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3) or not parts[0].strip():
            raise MXNetError(
                f"MXNET_QOS_SPEC entry {entry!r}: expected "
                "'name:class[:rps=N,tps=N,weight=N]'")
        name, cls = parts[0].strip(), parts[1].strip()
        kv = {}
        if len(parts) == 3:
            for tok in parts[2].split(","):
                tok = tok.strip()
                if not tok:
                    continue
                k, eq, v = tok.partition("=")
                k = k.strip()
                if not eq or k not in ("rps", "tps", "weight"):
                    raise MXNetError(
                        f"MXNET_QOS_SPEC entry {entry!r}: bad option "
                        f"{tok!r} (rps=/tps=/weight=)")
                try:
                    kv[k] = float(v)
                except ValueError:
                    raise MXNetError(
                        f"MXNET_QOS_SPEC entry {entry!r}: {k} value "
                        f"{v!r} is not a number")
        if name in tenants:
            raise MXNetError(
                f"MXNET_QOS_SPEC declares tenant {name!r} twice")
        tenants[name] = TenantSpec(name, cls, **kv)
    return tenants


class TenantRegistry:
    """The active tenant set plus its quota state.

    Quotas are classic token buckets (capacity = one second of rate,
    refilled continuously): :meth:`check_admit` spends one request
    token and verifies the token-rate bucket is not exhausted;
    :meth:`charge_tokens` debits delivered generation tokens — the
    bucket may go negative, which blocks new admissions until the
    refill catches up. Unknown tenant names get a quota-free
    default-class spec (cached per name: label cardinality is the
    operator's contract)."""

    def __init__(self, tenants=None, default_class=None, aging_s=None):
        self.tenants = dict(tenants or {})
        self.default_class = (getenv("MXNET_QOS_DEFAULT_CLASS")
                              if default_class is None else default_class)
        if self.default_class not in _RANK:
            raise MXNetError(
                f"MXNET_QOS_DEFAULT_CLASS {self.default_class!r} not one "
                f"of {'|'.join(CLASSES)}")
        self.aging_s = float(getenv("MXNET_QOS_AGING_S")
                             if aging_s is None else aging_s)
        self.default_rank = _RANK[self.default_class]
        self._defaults = {}          # unknown tenant name -> cached spec
        self._lock = analysis.make_lock("qos.registry")
        # token buckets, keyed by declared-tenant name: level + last
        # refill instant. Requests start at full capacity so the first
        # second of traffic is never throttled by an empty bucket.
        self._req = {}
        self._tok = {}
        now = time.monotonic()
        for name, spec in self.tenants.items():
            if spec.rps is not None:
                self._req[name] = [max(spec.rps, 1.0), now]
            if spec.tps is not None:
                self._tok[name] = [max(spec.tps, 1.0), now]

    def spec_for(self, tenant):
        """The tenant's :class:`TenantSpec` (a cached default-class spec
        for unknown names; ``None`` maps to the name ``"default"``)."""
        name = "default" if tenant is None else str(tenant)
        spec = self.tenants.get(name)
        if spec is not None:
            return spec
        spec = self._defaults.get(name)
        if spec is None:
            spec = self._defaults[name] = TenantSpec(
                name, self.default_class)
        return spec

    def rank(self, tenant):
        return self.spec_for(tenant).rank

    def weight(self, tenant):
        return self.spec_for(tenant).weight

    def effective_rank(self, rank, enqueued_at, now):
        """The rank admission ordering uses: batch promoted to standard
        once queued past the aging window (anti-starvation)."""
        if rank is None:
            rank = self.default_rank
        if (rank >= BATCH_RANK and self.aging_s > 0
                and now - enqueued_at >= self.aging_s):
            return _RANK["standard"]
        return rank

    @staticmethod
    def _refill(bucket, rate, now):
        level, t0 = bucket
        level = min(level + (now - t0) * rate, max(rate, 1.0))
        bucket[0] = level
        bucket[1] = now
        return level

    def check_admit(self, tenant, now=None):
        """Spend one request-rate token; raise :class:`QuotaExceededError`
        when the tenant is over either quota. No-op for quota-free
        tenants."""
        spec = self.spec_for(tenant)
        if spec.rps is None and spec.tps is None:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            if spec.tps is not None:
                level = self._refill(self._tok[spec.name], spec.tps, now)
                if level <= 0:
                    raise QuotaExceededError(
                        f"tenant {spec.name!r} over its token-rate quota "
                        f"({spec.tps:g} tok/s): retry after the bucket "
                        "refills")
            if spec.rps is not None:
                bucket = self._req[spec.name]
                level = self._refill(bucket, spec.rps, now)
                if level < 1.0:
                    raise QuotaExceededError(
                        f"tenant {spec.name!r} over its request-rate "
                        f"quota ({spec.rps:g} req/s): shed or defer this "
                        "tenant's load")
                bucket[0] = level - 1.0

    def charge_tokens(self, tenant, n, now=None):
        """Debit ``n`` delivered tokens against the tenant's token-rate
        bucket (may go negative — new admissions block until refill)."""
        spec = self.spec_for(tenant)
        if spec.tps is None:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._tok[spec.name]
            self._refill(bucket, spec.tps, now)
            bucket[0] -= n

    def slo_specs(self):
        """One TTFT p99 objective spec per DECLARED tenant (class-default
        targets) — what :func:`attach_slo` feeds the burn tracker."""
        return [
            f"qos.ttft_us|tenant={spec.name}:"
            f"p99<{_CLASS_TTFT_MS[spec.cls]:g}ms"
            for _, spec in sorted(self.tenants.items())]


def labeled_metric(name, spec):
    """The tenant/class-labeled telemetry name for ``spec`` — rendered
    by ``prom_text`` as ``mxnet_<name>{tenant="...",class="..."}``."""
    return telemetry.labeled(name, tenant=spec.name,
                             **{"class": spec.cls})


# ---------------------------------------------------------------------------
# Active-registry lifecycle
# ---------------------------------------------------------------------------

_lock = analysis.make_lock("qos.active")
_registry = None
_resolved = False


def active():
    """The process's active :class:`TenantRegistry`, or None when QoS is
    off. Resolved once from ``MXNET_QOS_SPEC`` (empty = off) unless
    :func:`install` overrode it; queues and engines capture the result
    at construction, so set the spec (or install) BEFORE building
    servers."""
    global _registry, _resolved
    if _resolved:
        return _registry
    with _lock:
        if not _resolved:
            spec = getenv("MXNET_QOS_SPEC")
            _registry = TenantRegistry(parse_spec(spec)) if spec else None
            _resolved = True
    return _registry


def install(registry):
    """Activate ``registry`` programmatically (tests / bench), overriding
    ``MXNET_QOS_SPEC`` until :func:`clear`. Returns the registry."""
    global _registry, _resolved
    with _lock:
        _registry = registry
        _resolved = True
    return registry


def clear():
    """Forget the active registry; the next :func:`active` re-reads
    ``MXNET_QOS_SPEC``."""
    global _registry, _resolved
    with _lock:
        _registry = None
        _resolved = False


def attach_slo(registry=None, tracker=None):
    """Append one per-tenant TTFT burn objective per declared tenant to
    the health SLO tracker (idempotent; no-op while QoS or the health
    layer is off). Returns the number of objectives added."""
    from .. import health

    registry = active() if registry is None else registry
    if registry is None or not health._enabled:
        return 0
    tracker = health.tracker() if tracker is None else tracker
    if tracker is None:
        return 0
    added = 0
    with tracker._lock:
        have = {o.spec for o in tracker.objectives}
        for spec in registry.slo_specs():
            if spec in have:
                continue
            obj = health.Objective(spec)
            tracker.objectives.append(obj)
            tracker._samples.setdefault(obj.key, collections.deque())
            added += 1
    return added
