"""GenerationStream: the client half of one autoregressive session.

The port of `mxnet_tpu/serving/generation/session.py`.
``engine.submit(prompt)`` returns one of these at once; the engine's
scheduler delivers tokens into it as they are decoded. Two ways to read it:

* **streaming**: iterate the stream; each ``__next__`` yields the next
  token as soon as it exists. A blocking iterator is also a CALLER-RUNS
  assistant: while its token queue is empty it tries to run engine ticks
  inline instead of waiting for the worker thread;
* **collecting**: ``result(timeout)`` blocks for the complete token list
  (a ``concurrent.futures.Future``, also the future the admission queue
  watches, so a stream failed while queued is dropped unadmitted).

Failure surfaces in band: a session evicted on its deadline raises
`DeadlineExceededError` from the iterator and from ``result()``; an engine
error raises the original exception the same way.
"""
from __future__ import annotations

import queue
import time
from concurrent.futures import Future

__all__ = ["GenerationStream"]

_TOK, _END, _ERR = 0, 1, 2


class GenerationStream:
    """Iterator of generated tokens for one submitted prompt."""

    def __init__(self, engine, prompt_len, max_new_tokens, deadline=None,
                 tenant=None):
        self._engine = engine       # reassigned when a parked session
        #                             migrates to a peer replica (the
        #                             caller-runs assist then drives the
        #                             adopting engine's ticks)
        self._q = queue.Queue()
        self._future = Future()
        self._stop = False          # iterator side: terminal item consumed
        self.tokens = []            # delivered so far (the engine appends)
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.submitted_at = time.monotonic()
        self.first_token_at = None
        self.tenant = tenant        # QoS tenant name (None = default class)
        self.cached_prefix_len = 0  # prompt tokens forked from the cache
        self.weights_version = None  # pinned at admission (swap_weights)

    # -- engine side ---------------------------------------------------------

    def _push(self, tok):
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.tokens.append(tok)
        self._q.put((_TOK, tok))

    def _finish(self):
        if not self._future.done():
            self._future.set_result(list(self.tokens))
        self._q.put((_END, None))

    def _fail(self, exc):
        if not self._future.done():
            self._future.set_exception(exc)
        self._q.put((_ERR, exc))

    # -- client side ---------------------------------------------------------

    @property
    def done(self):
        """True once the session reached a terminal state (all tokens
        delivered, or failed)."""
        return self._future.done()

    def result(self, timeout=None):
        """Block for the COMPLETE generation: the list of all generated
        tokens (raises the failure's exception for a failed session)."""
        return self._future.result(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop:
            raise StopIteration
        while True:
            try:
                kind, val = self._q.get_nowait()
                break
            except queue.Empty:
                # caller-runs assist: drive the engine inline while our
                # queue is empty; when another thread holds the tick lock
                # (the worker mid-tick), wait briefly on the queue instead
                if not self._engine._assist_once():
                    try:
                        kind, val = self._q.get(timeout=0.005)
                        break
                    except queue.Empty:
                        continue
        if kind == _TOK:
            return val
        self._stop = True
        if kind == _ERR:
            raise val
        raise StopIteration
