"""Speculative decoding drafts: propose k tokens per tick, let the slab
verify them.

The port of `mxnet_tpu/serving/generation/speculative.py`. Plain
continuous batching advances every session ONE token per tick; the
engine's speculative lane advances up to ``k + 1``: a cheap *draft*
proposes k tokens per live slot, the target model checks all of them in
ONE fixed-shape verify program (`TransformerLM.verify_step`, k + 1
unrolled decode steps, so greedy output stays bit-exact with the plain
lane), and the engine commits the longest agreeing prefix plus the
target's own next token. The draft never changes WHAT is generated, only
how many verify positions pay off.

Two drafts:

* `NgramDraft` (the default): host-side prompt lookup, proposing the
  continuation of the most recent earlier occurrence of the session's own
  trailing n-gram. No device state, no programs.
* `CheckpointDraft`: a small `TransformerLM` loaded from
  ``MXNET_GENERATION_DRAFT`` (`save_draft` / `load_draft` ``.npz``
  checkpoints, in the JAX package's format, so a draft saved by either
  package loads in the other). It keeps its OWN fixed-shape KV slab
  mirroring the engine's slots, and its programs live in the engine's
  cache: one prefill a bucket (admission) and ONE fused draft step that
  ingests the tick's committed tokens and then rolls k greedy proposal
  steps; on the card each is a CUDA graph captured once.

The engine calls drafts through a small lifecycle protocol (`Draft`):
``attach``, ``warm``, ``on_admit`` / ``on_evict`` / ``on_commit``,
``reset``, ``swap_params`` and ``propose``.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ... import memory
from ...base import MXNetError, getenv, register_env
from ...compile_cache import GraphProgram

__all__ = ["Draft", "NgramDraft", "CheckpointDraft", "save_draft",
           "load_draft", "default_draft"]

register_env("MXNET_GENERATION_SPEC_K", 0,
             "speculative decoding draft length k (tokens proposed per "
             "tick; the verify advances each slot by up to k+1). 0 "
             "disables the speculative lane (plain one-token decode)")
register_env("MXNET_GENERATION_DRAFT", "",
             "path to a save_draft() .npz checkpoint for the speculative "
             "draft model; empty = the host-side n-gram (prompt-lookup) "
             "fallback draft")

# bound the n-gram scan window: proposals are free to be wrong (the verify
# corrects), so an O(history) scan per slot per tick buys nothing past the
# recent context
_NGRAM_WINDOW = 256


class Draft:
    """Draft lifecycle protocol (no-op defaults; subclass what you need)."""

    def attach(self, engine):
        """Called once from the engine constructor with the owning engine
        (slots, max_len, buckets, program cache, device)."""

    def warm(self):
        """Build every draft program ahead of traffic; return the number
        built (0 for host-side drafts)."""
        return 0

    def on_admit(self, slot, prompt, first_tok):
        """A session entered ``slot`` with ``prompt`` and its prefill
        produced ``first_tok`` (committed but not yet fed anywhere)."""

    def on_commit(self, slot, committed):
        """The verify tick committed ``committed`` (list of ints, length
        1..k+1) for ``slot``."""

    def on_evict(self, slot):
        """The session in ``slot`` ended."""

    def reset(self):
        """The engine zeroed its slab after a failed tick; drop any
        per-slot device state the same way."""

    def swap_params(self, params):
        """A weight rollout published new draft parameters; flip to them
        (host dict, same names and shapes). Returns True when the draft
        has parameters to swap (False for host-side drafts)."""
        return False

    def propose(self, k, sessions):
        """Return an int32 [S, k] proposal block (rows of dead slots are
        ignored). ``sessions`` is the engine's slot list (None = dead);
        each live session exposes ``.prompt`` and ``.stream.tokens``."""
        raise NotImplementedError


class NgramDraft(Draft):
    """Prompt-lookup draft: continue the most recent earlier occurrence
    of the session's trailing n-gram (n = 3, 2, 1), falling back to
    repeating the last token. Pure host work on metadata the engine
    already keeps."""

    def __init__(self, max_ngram=3):
        self._n = int(max_ngram)

    def _propose_one(self, hist, k):
        n = hist.size
        lo = max(n - _NGRAM_WINDOW, 0)
        for g in range(min(self._n, n - 1), 0, -1):
            pat = hist[n - g:]
            # most recent earlier occurrence with at least one
            # continuation token
            for i in range(n - g - 1, lo - 1, -1):
                if np.array_equal(hist[i:i + g], pat):
                    cont = hist[i + g:i + g + k]
                    if cont.size:
                        out = list(cont)
                        while len(out) < k:
                            out.append(out[-1])
                        return out
        return [int(hist[-1])] * k

    def propose(self, k, sessions):
        out = np.zeros((len(sessions), k), np.int32)
        for s, sess in enumerate(sessions):
            if sess is None:
                continue
            hist = np.concatenate(
                [sess.prompt, np.asarray(sess.stream.tokens, np.int32)])
            out[s] = self._propose_one(hist, k)
        return out


class CheckpointDraft(Draft):
    """A small `TransformerLM` draft with its own fixed-shape KV slab.

    Per engine tick it runs ONE fused draft step: an unrolled ingest of
    the tick's committed block (per-slot valid counts; invalid trailing
    rows land beyond the slot's frontier and are overwritten by the next
    ingest before anything attends them) followed by k unrolled greedy
    proposal steps whose K/V writes are speculative in the same way. The
    draft slab therefore needs ``max_len + 2k`` rows of positional range;
    `attach` raises when the draft model's ``max_len`` cannot cover it.

    `model` is the port's `TransformerLM` on the engine's device; `params`
    (a state dict, as `load_draft` returns it) is loaded into it when
    given. The draft's programs read the model's parameters in place.
    """

    def __init__(self, model, params=None):
        if params is not None:
            model.load_state_dict(params)
        self._model = model
        self._eng = None
        self._dk = self._dv = None
        self._len = None          # per-slot draft frontier
        self._pending = None      # per-slot committed-not-ingested tokens

    @property
    def model(self):
        return self._model

    def attach(self, engine):
        if self._model.device != engine.device:
            raise MXNetError(f"draft model on {self._model.device}, engine "
                             f"on {engine.device}")
        self._eng = engine
        need = engine.max_len + 2 * engine.spec_k
        if need > self._model.cfg.max_len:
            raise MXNetError(
                f"draft model positional range {self._model.cfg.max_len} < "
                f"engine max_len {engine.max_len} + 2*k ({need} rows needed "
                "for speculative scratch); lower MXNET_GENERATION_MAX_LEN / "
                "MXNET_GENERATION_SPEC_K or train a longer draft")
        self._slab_len = need
        self._dk, self._dv = self._model.init_cache(engine.total_slots, need)
        self._len = np.zeros(engine.total_slots, np.int32)
        self._pending = [[] for _ in range(engine.total_slots)]
        # the draft's own slab, beside the engine's in the census
        memory.register_provider("kv_cache", self, lambda d: [d._dk, d._dv])

    def slab_bytes(self):
        return int(self._dk.nbytes) + int(self._dv.nbytes)

    # -- built programs ------------------------------------------------------

    def _prefill_fn(self, bucket):
        model, dk, dv, eng = self._model, self._dk, self._dv, self._eng

        def fn(tokens, length, slot):
            logits, _, _ = model.prefill(dk, dv, tokens, length, slot)
            return (logits.argmax().reshape(1),)

        def build():
            return GraphProgram(fn, [(bucket,), (1,), (1,)], model.device,
                                eng._pool)

        return eng.cache.get_or_build(
            ("draft_prefill", bucket, eng.total_slots, self._slab_len), build)

    def _step_fn(self, k):
        model, dk, dv, eng = self._model, self._dk, self._dv, self._eng
        n_slots = eng.total_slots

        def fn(tokens, counts, positions):
            # phase 1: ingest the committed block (k + 1 unrolled decode
            # steps), keeping each step's greedy argmax
            nxt = torch.stack(
                [model.decode_step(dk, dv, tokens[:, i], positions + i)[0]
                 .argmax(-1) for i in range(k + 1)], dim=1)      # [S, k+1]
            # the first proposal continues the LAST VALID ingested token
            # (index counts - 1; dead slots read index 0: garbage the
            # engine discards)
            idx = (counts - 1).clamp(min=0)[:, None]
            cur = nxt.gather(1, idx)[:, 0]
            props = [cur]
            # phase 2: k - 1 more greedy steps feeding the proposals; their
            # writes start at the post-ingest frontier and are speculative
            for j in range(k - 1):
                lg = model.decode_step(dk, dv, cur, positions + counts + j)[0]
                cur = lg.argmax(-1)
                props.append(cur)
            return (torch.stack(props, dim=1),)

        def build():
            return GraphProgram(fn, [(n_slots, k + 1), (n_slots,),
                                     (n_slots,)], model.device, eng._pool)

        return eng.cache.get_or_build(
            ("draft_step", k, n_slots, self._slab_len), build)

    # -- lifecycle -----------------------------------------------------------

    def warm(self):
        eng = self._eng
        misses0 = eng.cache.misses
        for b in eng.prefill_buckets:
            self._prefill_fn(b)(np.zeros(b, np.int64), 1, 0)
        k = eng.spec_k
        zeros = np.zeros(eng.total_slots, np.int64)
        self._step_fn(k)(np.zeros((eng.total_slots, k + 1), np.int64), zeros,
                         zeros)
        # warm garbage lands in rows the next real prefill or ingest
        # overwrites before attending (the frontier argument); lengths
        # were never advanced, so there is no state to undo
        return eng.cache.misses - misses0

    def on_admit(self, slot, prompt, first_tok):
        eng = self._eng
        n = int(prompt.size)
        bucket = eng.bucket_for(n)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = prompt
        self._prefill_fn(bucket)(padded, n, slot)
        self._len[slot] = n
        self._pending[slot] = [int(first_tok)]

    def on_commit(self, slot, committed):
        self._pending[slot] = [int(t) for t in committed]

    def on_evict(self, slot):
        self._len[slot] = 0
        self._pending[slot] = []

    def reset(self):
        # in place: the draft's graphs keep the slab's pointers
        self._dk.zero_()
        self._dv.zero_()
        self._len[:] = 0
        self._pending = [[] for _ in range(self._eng.total_slots)]

    def swap_params(self, params):
        """Flip the draft to new weights at once, written into its
        parameters (the graphs read them in place, so nothing is captured
        again); the slab survives. Rows ingested under the old weights
        only lower the acceptance until overwritten (the target's verify
        decides every token). Names (the port's or the JAX package's)
        and shapes must match; values are cast to the bound dtypes."""
        from ...models.convert import state_like

        placed = state_like(self._model, params, "draft swap_params")
        with torch.no_grad():
            for name, p in self._model.named_parameters():
                p.copy_(placed[name])
        return True

    def propose(self, k, sessions):
        n_slots = len(sessions)
        tokens = np.zeros((n_slots, k + 1), np.int64)
        counts = np.zeros(n_slots, np.int64)
        for s, sess in enumerate(sessions):
            if sess is None:
                continue
            pend = self._pending[s]
            tokens[s, :len(pend)] = pend
            counts[s] = len(pend)
        props = self._step_fn(k)(tokens, counts, self._len)
        self._len += counts.astype(np.int32)
        for s, sess in enumerate(sessions):
            if sess is not None:
                self._pending[s] = []
        return props


# ---------------------------------------------------------------------------
# Checkpoint format
# ---------------------------------------------------------------------------


def save_draft(path, model, params=None):
    """Persist a `TransformerLM` draft as one ``.npz`` in the JAX
    package's format: the config as JSON under ``__config__`` and every
    parameter under its JAX name (``l0.wqkv``). `params` (a state dict)
    defaults to the model's own. bf16 values are written as float32
    arrays, which hold them exactly (numpy has no bf16 of its own)."""
    from ...models.convert import params_to_jax

    arrays = params_to_jax(model.state_dict() if params is None else params)
    np.savez(path, __config__=json.dumps(dataclasses.asdict(model.cfg)),
             **arrays)


def load_draft(path, device=None):
    """Load a `save_draft` checkpoint of either package: returns
    ``(model, params)``, the port's `TransformerLM` on `device` (``cuda``
    unless the caller says otherwise) holding the parameters, each cast to
    the config's dtype, and its state dict."""
    from ...models import TransformerLM, TransformerLMConfig
    from ...models.convert import params_from_jax

    with np.load(path, allow_pickle=False) as z:
        cfg = TransformerLMConfig(**json.loads(str(z["__config__"])))
        arrays = {name: z[name] for name in z.files if name != "__config__"}
    model = TransformerLM(cfg, device=device)
    params = params_from_jax(arrays, device=model.device,
                             dtype=getattr(torch, cfg.dtype))
    model.load_state_dict(params)
    return model, model.state_dict()


def default_draft(device=None):
    """The draft the engine uses when none is passed: a `CheckpointDraft`
    from ``MXNET_GENERATION_DRAFT`` when set, else the `NgramDraft`
    fallback."""
    path = str(getenv("MXNET_GENERATION_DRAFT")).strip()
    if path:
        return CheckpointDraft(*load_draft(path, device))
    return NgramDraft()
