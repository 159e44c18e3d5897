"""mxnet_tpu_torch.serving: the port of `mxnet_tpu.serving`, the inference
serving subsystem. It turns a trained ``(symbol, params)`` checkpoint (or a
bound `Module`) into a thread-safe server, and serves `TransformerLM`
generation:

* `Predictor`: ``grad_req="null"`` executors bound per batch-size bucket
  (``MXNET_SERVING_BUCKETS``), each bucket's forward ONE CUDA graph on a
  card, requests padded up to the smallest fitting bucket, every build in
  one `CompileCache("serving")`; `load` and `from_module` fold
  Convolution -> BatchNorm (-> ReLU) chains (``TPU_FUSE``) by default;
* `DynamicBatcher`: queues requests and coalesces them into padded
  batches, flushing on a full largest bucket or
  ``MXNET_SERVING_MAX_WAIT_MS``, each caller getting exactly its own rows
  back; caller-runs assist and the ``MXNET_OVERLAP`` staging lane;
* admission control: ``MXNET_SERVING_MAX_QUEUE`` bounds the queue
  (synchronous `QueueFullError`), per-request deadlines
  (`DeadlineExceededError`), graceful ``close()`` drain
  (`ServerClosedError`), transient failures retried but never past a
  deadline;
* `warmup`: builds every bucket (or every program of a generation engine)
  ahead of traffic, so steady state captures nothing;
* `rollout`: versioned CRC-verified `WeightSet` publishes over a watched
  directory (``MXNET_ROLLOUT_DIR``, also fed by `model.save_checkpoint`)
  and live `Predictor.swap_weights` with nothing captured again;
* `health`: liveness and readiness probes of predictors, batchers and
  generation engines;
* `qos`: multi-tenant QoS (`TenantRegistry` from ``MXNET_QOS_SPEC``):
  class-ordered admission with per-tenant quotas (`QuotaExceededError`),
  preemption of batch sessions into the generation slab's park region;
* `generation`: continuous-batching autoregressive serving over a KV slot
  slab (`GenerationEngine` with its prefix-cache, speculative,
  weight-swap and QoS lanes, `GenerationRouter` with class placement,
  parked-session migration and the SLO-gated `rolling_swap`,
  `GenerationStream`).

Quick start::

    pred = serving.Predictor.load("model", data_shapes=[("data", (1, 3, 224, 224))])
    serving.warmup(pred)                     # capture every bucket now
    with serving.DynamicBatcher(pred) as srv:
        fut = srv.submit(batch_of_rows, timeout=0.5)
        probs = fut.result()

Every layer here reports into the observability planes (`telemetry`,
`tracing`, `health`, `observatory`, `memory`) when they are on.
"""
from . import generation
from . import qos
from . import rollout
from .admission import (AdmissionQueue, DeadlineExceededError, QueueFullError,
                        Request, ServerClosedError, ServingError)
from .batcher import DynamicBatcher
from .generation import (GenerationEngine, GenerationRouter,
                         GenerationStream)
from .predictor import Predictor, bucket_ladder
from .qos import QuotaExceededError, TenantRegistry
from .rollout import (RolloutSubscriber, RolloutWatcher, WeightSet, publish,
                      publish_checkpoint)
from .warmup import warmup

__all__ = ["Predictor", "DynamicBatcher", "AdmissionQueue", "Request",
           "ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "QuotaExceededError", "bucket_ladder",
           "warmup", "generation", "GenerationEngine", "GenerationRouter",
           "GenerationStream", "qos", "TenantRegistry", "rollout",
           "WeightSet",
           "RolloutSubscriber", "RolloutWatcher", "publish",
           "publish_checkpoint"]
