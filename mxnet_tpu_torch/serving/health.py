"""Serving-side health probes: the port of the request-level half of
`mxnet_tpu/serving/health.py`.

* :func:`attach_engine`: a `GenerationEngine` registers a liveness probe
  (its scheduler worker alive) and a readiness probe (warmed, the intake
  queue below the watermark, not draining), which the `GenerationRouter`
  consults for placement when the health layer is on, and gets its tick
  beacon for the stall watchdog;
* :func:`attach_predictor`: a `Predictor` registers a readiness probe
  (warm-up run, or a bucket already bound by traffic);
* :func:`attach_batcher`: a `DynamicBatcher` registers a liveness probe
  (its worker thread alive) and a readiness probe (not draining, the
  predictor warmed, the intake queue below the watermark).

Registration happens at construction (weak references, a few dict
entries); :mod:`mxnet_tpu_torch.health` aggregates the probes and its
watchdog reads the beacons.
"""
from __future__ import annotations

import itertools

from .. import health
from ..base import getenv

__all__ = ["attach_engine", "attach_batcher", "attach_predictor",
           "queue_watermark", "queue_ready"]

_seq = itertools.count()


def queue_watermark():
    """The readiness watermark fraction (``MXNET_HEALTH_QUEUE_WATERMARK``
    of the admission bound)."""
    return float(getenv("MXNET_HEALTH_QUEUE_WATERMARK"))


def queue_ready(queue):
    """(ok, detail) for one admission queue against the watermark."""
    depth = len(queue)
    limit = queue.max_depth * queue_watermark()
    if depth >= limit:
        return False, (f"queue depth {depth} >= watermark "
                       f"{limit:.0f} (of {queue.max_depth})")
    return True, f"queue {depth}/{queue.max_depth}"


def _engine_live(e):
    return e.healthy()


def _engine_ready(e):
    return e.ready()


def attach_engine(engine):
    """Register one generation engine's probes and tick beacon. Returns
    the (engine-unique) probe name, which is also the beacon's, and the
    beacon."""
    name = f"generation.engine.{next(_seq)}"
    health.register_liveness(name, engine, _engine_live)
    health.register_readiness(name, engine, _engine_ready)
    return name, health.beacon(name, owner=engine)


def _batcher_live(b):
    return b.healthy()


def _batcher_ready(b):
    return b.ready()


def attach_batcher(batcher):
    name = f"serving.batcher.{next(_seq)}"
    health.register_liveness(name, batcher, _batcher_live)
    health.register_readiness(name, batcher, _batcher_ready)
    return name


def _predictor_ready(p):
    # a predictor whose buckets traffic already bound counts as warmed: a
    # deployment that skipped warmup() but serves must not report unready
    if not p._warmed and not p._execs:
        return False, "warmup not run"
    return True, f"buckets bound: {sorted(p._execs)}"


def attach_predictor(predictor):
    name = f"serving.predictor.{next(_seq)}"
    health.register_readiness(name, predictor, _predictor_ready)
    return name
