"""Resilience: transient-fault retry, the checkpoint-integrity error, atomic
file replacement and a deterministic fault-injection harness.

The port of the parts of `mxnet_tpu/resilience.py` the serving stack uses:

* :func:`retry_call`: jittered exponential backoff with a bounded retry
  budget, for idempotent operations (the batcher's forward retries);
* :class:`CorruptCheckpointError`: raised by `nd.load` when a CRC32/length
  footer does not match;
* :func:`durable_replace`: the rename-then-fsync tail of an atomic writer
  (the rollout manifest);
* :func:`inject` / :func:`fault_scope`: fault points compiled from
  ``MXNET_FAULT_SPEC``. The grammar is the JAX package's, rules separated
  by ``;``, ``key=value`` fields by ``,``::

      point=publish,path=*.manifest.json,error=CORRUPT

  Fields: ``point`` (open|read|write|prefetch|shm|publish, required),
  ``path`` (fnmatch pattern, default ``*``), ``nth`` (first matching event
  to fault, 1-based, default 1), ``times`` (consecutive events to fault,
  ``inf`` allowed, default 1), ``error`` (errno name, default EIO; ``KILL``
  raises :class:`ThreadKilled`), ``truncate`` (byte count). The port fires
  the ``publish`` point (`serving.rollout.publish`), and ``open`` (through
  :func:`open_checked`) and ``read`` in `recordio`. Errno rules raise;
  three publish-only modes return the rule for the publisher to enact on
  its own output: ``truncate=K`` tears the manifest at K bytes,
  ``error=CORRUPT`` flips a payload byte after the CRC footers land, and
  ``error=STALE`` stamps the manifest with an already-published version.

Not ported yet (ROADMAP.md queue A, item A.8): `wrap_retry`,
`WorkerLostError` and the other fault points' call sites.
"""
from __future__ import annotations

import errno as _errno
import fnmatch
import os
import random
import threading
import time

from .base import MXNetError, getenv, register_env
from .log import get_logger

__all__ = ["CorruptCheckpointError", "ThreadKilled", "FaultRule",
           "retry_call", "inject", "fault_scope", "reset_fault_counters",
           "durable_replace", "open_checked"]

register_env("MXNET_IO_RETRY_BUDGET", 3,
             "retries after the first failed IO attempt")
register_env("MXNET_IO_RETRY_BACKOFF", 0.05, "initial retry backoff seconds")
register_env("MXNET_IO_RETRY_BACKOFF_MAX", 2.0,
             "retry backoff ceiling seconds")
register_env("MXNET_FAULT_SPEC", "",
             "deterministic IO fault-injection spec (tests)")


def durable_replace(tmp, dst):
    """Atomically publish a fully written (and fsync'd) temp file: rename,
    then fsync the containing directory so a host crash right after cannot
    lose the rename itself."""
    os.replace(tmp, dst)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(dst)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # platform without directory fsync


class CorruptCheckpointError(MXNetError):
    """A saved array file failed integrity verification (bad CRC, short
    read, or torn payload)."""


class ThreadKilled(Exception):
    """Injected 'thread dies silently' fault (``error=KILL``)."""


def _logger():
    return get_logger("mxnet_tpu_torch.resilience")


# deterministic outcomes a retry can never change
_NO_RETRY_ERRNOS = frozenset(
    getattr(_errno, name) for name in
    ("ENOENT", "EISDIR", "ENOTDIR", "EACCES", "EPERM", "EROFS",
     "ENAMETOOLONG") if hasattr(_errno, name))


def retry_call(fn, *args, desc=None, retries=None, backoff=None,
               backoff_max=None, retry_on=(OSError,), **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` exception retry up to
    ``retries`` more times, sleeping ``backoff * 2**attempt`` (jittered to
    50-100 %, capped at ``backoff_max``) between attempts. Deterministic
    OSErrors (missing file, permissions) raise at once. Only for idempotent
    operations: a replayed call must be harmless."""
    retries = getenv("MXNET_IO_RETRY_BUDGET") if retries is None else retries
    backoff = getenv("MXNET_IO_RETRY_BACKOFF") if backoff is None else backoff
    backoff_max = (getenv("MXNET_IO_RETRY_BACKOFF_MAX")
                   if backoff_max is None else backoff_max)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if isinstance(e, OSError) and e.errno in _NO_RETRY_ERRNOS:
                raise
            if attempt >= retries:
                raise
            delay = min(backoff * (2 ** attempt), backoff_max)
            delay *= 0.5 + 0.5 * random.random()
            attempt += 1
            _logger().warning(
                "transient failure on %s (attempt %d/%d, retrying in "
                "%.3fs): %s", desc or getattr(fn, "__name__", "?"), attempt,
                retries, delay, e)
            time.sleep(delay)


class FaultRule:
    """One compiled ``MXNET_FAULT_SPEC`` rule and its event counter."""

    __slots__ = ("point", "path", "nth", "times", "error", "truncate",
                 "count")

    def __init__(self, point, path="*", nth=1, times=1, error="EIO",
                 truncate=None):
        if point not in ("open", "read", "write", "prefetch", "shm",
                         "publish"):
            raise MXNetError(
                f"MXNET_FAULT_SPEC: unknown fault point {point!r}")
        if error in ("CORRUPT", "STALE"):
            if point != "publish":
                raise MXNetError(
                    f"MXNET_FAULT_SPEC: error={error} is only valid at "
                    f"point=publish, not {point!r}")
        elif error != "KILL" and not hasattr(_errno, error):
            raise MXNetError(
                f"MXNET_FAULT_SPEC: unknown errno name {error!r}")
        self.point = point
        self.path = path
        self.nth = int(nth)
        self.times = (float("inf") if times in ("inf", float("inf"))
                      else int(times))
        self.error = error
        self.truncate = None if truncate is None else int(truncate)
        self.count = 0

    def matches(self, path):
        return (fnmatch.fnmatch(path, self.path) or
                fnmatch.fnmatch(os.path.basename(path), self.path))

    def fire(self, path):
        """Raise (or return self for the self-inflicted rules) when this
        event falls in the [nth, nth + times) window of matching events."""
        self.count += 1
        if not (self.nth <= self.count < self.nth + self.times):
            return None
        if self.truncate is not None or self.error in ("CORRUPT", "STALE"):
            _logger().warning("fault injection: %s at %s of %s",
                              self.error if self.truncate is None
                              else f"truncate={self.truncate}",
                              self.point, path)
            return self
        if self.error == "KILL":
            raise ThreadKilled(
                f"fault injection: killed at {self.point} of {path}")
        raise OSError(getattr(_errno, self.error),
                      f"fault injection: {self.error} at {self.point} of "
                      f"{path}")

    def __repr__(self):
        return (f"FaultRule(point={self.point}, path={self.path!r}, "
                f"nth={self.nth}, times={self.times}, error={self.error}, "
                f"truncate={self.truncate})")


def _parse_spec(spec):
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = {}
        for kv in chunk.split(","):
            key, eq, val = kv.strip().partition("=")
            if not eq:
                raise MXNetError(
                    f"MXNET_FAULT_SPEC: expected key=value, got {kv!r}")
            if key not in ("point", "path", "nth", "times", "error",
                           "truncate"):
                raise MXNetError(f"MXNET_FAULT_SPEC: unknown field {key!r}")
            fields[key] = val
        if "point" not in fields:
            raise MXNetError(
                f"MXNET_FAULT_SPEC: rule missing point=: {chunk!r}")
        try:
            rules.append(FaultRule(**fields))
        except ValueError as e:  # non-integer nth/times/truncate
            raise MXNetError(
                f"MXNET_FAULT_SPEC: bad rule {chunk!r}: {e}") from e
    return rules


_fault_lock = threading.Lock()
_fault_spec = None   # the env string the compiled rules came from
_fault_rules = []


def _rules():
    """Compiled rules for the CURRENT env value; counters survive as long
    as the spec string is unchanged (recompiled, and reset, on a change)."""
    global _fault_spec, _fault_rules
    spec = os.environ.get("MXNET_FAULT_SPEC", "")
    if spec == _fault_spec:
        return _fault_rules
    with _fault_lock:
        if spec != _fault_spec:
            _fault_rules = _parse_spec(spec)
            _fault_spec = spec
    return _fault_rules


def open_checked(path, mode="rb"):
    """`open` with the ``open`` fault point and transient-fault retry: the
    entry point of the recordio and image file opens."""
    def attempt():
        inject("open", path)
        return open(path, mode)
    return retry_call(attempt, desc=f"open {path}")


def reset_fault_counters():
    """Restart every rule's event counter (tests reuse one spec)."""
    with _fault_lock:
        for r in _fault_rules:
            r.count = 0


def inject(point, path=""):
    """Fault point hook: a no-op unless an active rule matches. Raises the
    rule's OSError / :class:`ThreadKilled`, or returns the rule that the
    caller enacts on its own output (truncate, CORRUPT, STALE)."""
    rules = _rules()
    if not rules:
        return None
    with _fault_lock:
        for rule in rules:
            if rule.point == point and rule.matches(path):
                fired = rule.fire(path)
                if fired is not None:
                    return fired
    return None


class fault_scope:
    """Context manager installing a fault spec (with fresh counters) for a
    block, restoring the previous spec on exit."""

    def __init__(self, spec):
        self._spec = spec
        self._prev = None

    def __enter__(self):
        self._prev = os.environ.get("MXNET_FAULT_SPEC")
        os.environ["MXNET_FAULT_SPEC"] = self._spec
        try:
            _rules()  # compile now so a bad spec fails at scope entry
        except Exception:
            self.__exit__()  # a rejected spec must not stay in the env
            raise
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            os.environ.pop("MXNET_FAULT_SPEC", None)
        else:
            os.environ["MXNET_FAULT_SPEC"] = self._prev
        _rules()
        return False
