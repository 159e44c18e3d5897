"""mxnet_tpu_torch.serving.generation: continuous-batching autoregressive
serving, the port of `mxnet_tpu.serving.generation`.

* `GenerationEngine`: a slot-based KV-cache session store (one
  preallocated slab, fixed shapes, admission and eviction a slot-index
  write) driven by a token-level scheduler: each tick runs ONE decode step
  over every live session, evicts finished, EOS and expired sequences and
  admits queued prefills into the freed slots mid-stream. On the card every
  program is a CUDA graph captured once and replayed. Its lanes: the
  prefix cache (`RadixPrefixCache`, fork + suffix prefill), speculative
  decoding (`NgramDraft`, `CheckpointDraft`, one verify program), live
  weight swaps with version cohorts (`swap_weights`) and, with a QoS
  registry active, preemption of batch sessions into park rows and their
  bit-exact resume (`eject_parked` / `adopt` move them between replicas);
  on by default, the overlap tick order (``MXNET_OVERLAP``);
* `GenerationRouter`: places sessions over engine replicas by prefix
  affinity, then QoS class, then load; migrates parked sessions
  (`rebalance_parked`) and rolls new weights through the fleet behind the
  SLO burn gate (`rolling_swap`);
* `GenerationStream`: ``submit() -> iterator of tokens`` with caller-runs
  assist, plus ``result()`` for collectors; failures raise in band.

Quick start::

    lm = TransformerLM(cfg)                  # on cuda
    eng = generation.GenerationEngine(lm, max_slots=16)
    serving.warmup(eng)                      # capture prefill + decode
    for tok in eng.submit(prompt_ids, max_new_tokens=64, timeout=2.0):
        ...
"""
from . import speculative
from .engine import GenerationEngine, prefill_ladder
from .prefix_cache import RadixPrefixCache
from .router import GenerationRouter
from .session import GenerationStream
from .speculative import (CheckpointDraft, NgramDraft, load_draft,
                          save_draft)

__all__ = ["GenerationEngine", "GenerationRouter", "GenerationStream",
           "RadixPrefixCache", "NgramDraft", "CheckpointDraft",
           "save_draft", "load_draft", "prefill_ladder", "speculative"]
