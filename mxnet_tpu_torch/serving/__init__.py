"""mxnet_tpu_torch.serving: the port of `mxnet_tpu.serving`, so far its
generation plane.

* :mod:`generation`: continuous-batching autoregressive serving over a KV
  slot slab (`GenerationEngine`, `GenerationStream`);
* admission control: the bounded intake queue (`AdmissionQueue`,
  ``MXNET_SERVING_MAX_QUEUE``) with synchronous `QueueFullError`
  backpressure, per-session deadlines (`DeadlineExceededError`) and a
  graceful ``close()`` drain (`ServerClosedError` for new work);
* `warmup`: build every program of an engine ahead of traffic;
* `bucket_ladder`: the bucket-spec parser of the predictor.

Not ported yet: `Predictor`, `DynamicBatcher`, QoS, rollout, the router,
the prefix cache and speculative decoding.
"""
from . import generation
from .admission import (AdmissionQueue, DeadlineExceededError, QueueFullError,
                        Request, ServerClosedError, ServingError)
from .generation import GenerationEngine, GenerationStream
from .predictor import bucket_ladder
from .warmup import warmup

__all__ = ["AdmissionQueue", "Request", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError", "bucket_ladder",
           "warmup", "generation", "GenerationEngine", "GenerationStream"]
