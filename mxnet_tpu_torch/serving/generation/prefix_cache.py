"""RadixPrefixCache — refcounted radix trie over prompt tokens whose
payloads are KV rows living IN the engine's slot slab.

The port of `mxnet_tpu/serving/generation/prefix_cache.py`, whole: its
``<metric_prefix>.prefix.inserts`` / ``.evictions`` counters and
``.cached_tokens`` gauge go to the telemetry registry when it is on (the
engine counts hits and misses).

A fleet serving millions of users sees the same system prompt thousands of
times; without this module every session pays a full prefill for it. The
cache makes shared prefixes a one-time cost:

* **structure** — a radix (compressed) trie keyed on prompt token
  sequences. Edges hold token subsequences; a node with a *payload* owns
  one slab slot whose rows ``[0, length)`` are the K/V of that node's full
  prefix. Because the K/V of a prefix is a prefix of the K/V, a prompt
  that diverges MID-edge from a cached entry still hits: the longest
  common prefix of the prompt with *any* entry is usable, served by any
  payload slot in the subtree below the divergence point (every entry
  down there shares those first ``m`` tokens).
* **in-slab payloads** — cached entries occupy ordinary slots of the
  engine's existing KV slab, not a second allocation: a hit is ONE fork
  program (a CUDA graph on the card copying the source slot's rows to the
  session's slot, captured once) followed by a suffix prefill of only the
  unmatched tail.
* **refcounts + LRU** — ``acquire``/``release`` pin an entry while a fork
  is reading its slot (an eviction mid-copy would hand the row to a new
  prefill); eviction is LRU over refcount-ZERO entries only, runs when the
  ENGINE needs a slot for a live session (sessions always outrank cache),
  and is journaled through the health event ring (``prefix_evict``) so a
  thrashing cache is visible in ``/events``.

The trie itself is host-side metadata (a few hundred bytes per entry);
all device bytes stay in the slab. Thread-safe: the router's
prefix-affinity probe calls :meth:`match_len` from submitter threads while
the engine's tick loop mutates entries.
"""
from __future__ import annotations

import time

import numpy as np

from ... import analysis, health, telemetry

__all__ = ["RadixPrefixCache"]


def _common_len(edge, tail):
    """Token-wise common-prefix length of an edge with a prompt tail
    (compared over the shorter of the two)."""
    k = min(len(edge), len(tail))
    eq = edge[:k] == tail[:k]
    return k if bool(np.all(eq)) else int(np.argmin(eq))


class _Node:
    """One radix-trie node: ``edge`` tokens lead here from the parent;
    ``slot`` (when not None) is the slab slot holding this prefix's KV."""

    __slots__ = ("edge", "parent", "children", "length", "slot", "refs",
                 "last_used", "payloads", "version")

    def __init__(self, edge, parent, length):
        self.edge = edge              # np.int32 [e] tokens from parent
        self.parent = parent
        self.children = {}            # first token -> _Node
        self.length = length          # total prefix tokens at this node
        self.slot = None              # payload slab slot (None = internal)
        self.refs = 0                 # active borrowers (forks in flight)
        self.last_used = 0.0          # LRU clock (payload nodes)
        self.payloads = 0             # payload nodes in subtree incl. self
        self.version = 0              # weights version the KV was computed
        #                               under (rollout: a fork must never
        #                               attend old-weight KV with new-weight
        #                               logits)


class RadixPrefixCache:
    """Refcounted radix prefix cache over one engine's slot slab.

    ``owner`` labels health journal entries; ``metric_prefix`` names the
    telemetry series.
    """

    def __init__(self, metric_prefix="serving.generation", owner=""):
        self._root = _Node(np.zeros(0, np.int32), None, 0)
        self._slots = {}              # slot -> payload _Node
        self._lock = analysis.make_rlock("generation.prefix_cache")
        self._owner = owner
        self._prefix = metric_prefix

    # -- introspection -------------------------------------------------------

    def __len__(self):
        """Number of cached entries (payload nodes)."""
        with self._lock:
            return len(self._slots)

    def slots(self):
        """The slab slots the cache currently owns (the engine subtracts
        these from its free list)."""
        with self._lock:
            return set(self._slots)

    def cached_tokens(self):
        """Total real KV rows pinned across entries (the
        ``prefix.cached_tokens`` gauge)."""
        with self._lock:
            return sum(n.length for n in self._slots.values())

    def entries(self):
        """[(prefix_length, slot, refs)] for tests/debugging."""
        with self._lock:
            return sorted((n.length, s, n.refs)
                          for s, n in self._slots.items())

    # -- matching ------------------------------------------------------------

    def _walk(self, prompt):
        """Longest token match: returns (deepest fully-entered node,
        matched token count). The match may end mid-edge; ``node`` is the
        last node whose subtree contains every entry sharing the match."""
        node = self._root
        m = 0
        n = len(prompt)
        while m < n:
            child = node.children.get(int(prompt[m]))
            if child is None:
                return node, m
            e = child.edge
            eq = _common_len(e, prompt[m:])
            m += eq
            if eq < len(e):
                # diverged (or prompt ended) mid-edge: every entry below
                # `child` still shares the first m tokens
                return child, m
            node = child
        return node, m

    def _payload_below(self, node, version=None):
        """Any payload node at or below ``node`` stamped with weights
        ``version`` (None = any), depth-first through subtrees that
        report payloads."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n.slot is not None and (version is None
                                       or n.version == version):
                return n
            stack.extend(c for c in n.children.values() if c.payloads)
        return None

    def match(self, prompt, version=None):
        """Longest usable cached prefix of ``prompt``: returns
        ``(payload_node, matched_len)`` or ``(None, 0)``. The matched
        length is capped at ``len(prompt) - 1`` — at least one suffix
        token must remain to produce the first sampled logits. With
        ``version`` only entries stamped with that weights version
        qualify (the engine passes its current version, so a post-swap
        fork can never splice old-weight KV under new-weight logits).
        Does NOT count telemetry or touch LRU; callers decide (the
        router probes without consuming)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            node, m = self._walk(prompt)
            m = min(m, prompt.size - 1)
            if m <= 0:
                return None, 0
            pay = self._payload_below(node, version)
            if pay is None:
                return None, 0
            return pay, m

    def match_len(self, prompt, version=None):
        """Matched token count only (the router's affinity probe)."""
        _, m = self.match(prompt, version)
        return m

    def acquire(self, node):
        """Pin ``node`` against eviction (a fork is about to read its
        slot) and touch its LRU clock."""
        with self._lock:
            node.refs += 1
            node.last_used = time.monotonic()

    def release(self, node):
        with self._lock:
            node.refs = max(node.refs - 1, 0)

    # -- insertion -----------------------------------------------------------

    def insert(self, prompt, slot, version=0):
        """Register ``slot`` as holding the KV of the full ``prompt``
        prefix, stamped with the weights ``version`` it was computed
        under. Returns the payload node, or None when the exact prefix is
        already cached at the same version (the caller keeps its slot
        free — dedupe, don't hoard); an entry cached under a DIFFERENT
        version is replaced, its old-weight rows dropped. Splits edges at
        divergence points; split nodes are internal (payload-less) until
        some insert lands exactly there."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            return None
        with self._lock:
            node = self._root
            m = 0
            n = prompt.size
            while m < n:
                child = node.children.get(int(prompt[m]))
                if child is None:
                    child = _Node(prompt[m:].copy(), node, n)
                    node.children[int(prompt[m])] = child
                    node = child
                    m = n
                    break
                e = child.edge
                eq = _common_len(e, prompt[m:])
                if eq < len(e):
                    # split the edge at the divergence point
                    mid = _Node(e[:eq].copy(), node, child.length
                                - (len(e) - eq))
                    node.children[int(e[0])] = mid
                    child.edge = e[eq:].copy()
                    child.parent = mid
                    mid.children[int(child.edge[0])] = child
                    mid.payloads = child.payloads
                    node = mid
                else:
                    node = child
                m += eq
            if node.slot is not None:
                if node.version == int(version):
                    node.last_used = time.monotonic()  # already cached: touch
                    return None
                # same prefix, different weights: the cached rows are
                # stale logits-wise — replace the payload outright (no
                # pruning: the node immediately carries the new payload)
                self._drop_payload(node, "version_replace", prune=False)
            node.slot = int(slot)
            node.version = int(version)
            node.last_used = time.monotonic()
            self._slots[int(slot)] = node
            p = node
            while p is not None:
                p.payloads += 1
                p = p.parent
            if telemetry._enabled:
                telemetry.counter(f"{self._prefix}.prefix.inserts").inc()
                telemetry.gauge(f"{self._prefix}.prefix.cached_tokens").set(
                    self.cached_tokens())
            return node

    # -- eviction ------------------------------------------------------------

    def _drop_payload(self, node, reason, prune=True):
        slot = node.slot
        tokens = int(node.length)
        node.slot = None
        del self._slots[slot]
        p = node
        while p is not None:
            p.payloads -= 1
            p = p.parent
        # prune now-useless leaf chains so the trie stays O(entries) —
        # skipped when the caller is about to repopulate the same node
        # (version_replace re-inserts in place)
        while (prune and node is not self._root and node.slot is None
               and not node.children):
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node = parent
        if telemetry._enabled:
            telemetry.counter(f"{self._prefix}.prefix.evictions").inc()
            telemetry.gauge(f"{self._prefix}.prefix.cached_tokens").set(
                self.cached_tokens())
        if health._enabled:
            health.event("prefix_evict", engine=self._owner, slot=slot,
                         tokens=tokens, reason=reason)
        return slot

    def evict_lru(self, reason="pressure"):
        """Free the least-recently-used refcount-ZERO entry's slot and
        return it (None when every entry is pinned or the cache is
        empty). The engine calls this when a session needs a slot and
        none is free — live sessions always outrank cached prefixes."""
        with self._lock:
            victim = None
            for node in self._slots.values():
                if node.refs == 0 and (victim is None
                                       or node.last_used < victim.last_used):
                    victim = node
            if victim is None:
                return None
            return self._drop_payload(victim, reason)

    def evict_slot(self, slot, reason="explicit"):
        """Drop the entry holding ``slot`` (tests, engine teardown).
        Returns True when an entry was dropped."""
        with self._lock:
            node = self._slots.get(int(slot))
            if node is None:
                return False
            self._drop_payload(node, reason)
            return True

    def evict_other_versions(self, version, reason="weights_swap"):
        """Drop every entry NOT stamped with weights ``version`` (the
        engine calls this at swap time: entries computed under the old
        weights would otherwise serve forks whose prefix logits no
        longer match the model). Returns the number dropped."""
        with self._lock:
            victims = [s for s, n in self._slots.items()
                       if n.version != int(version)]
            for slot in victims:
                self.evict_slot(slot, reason)
            return len(victims)

    def clear(self, reason="clear"):
        """Drop every entry (the engine zeroes its slab after a failed
        tick, and the cached rows with it)."""
        with self._lock:
            for slot in list(self._slots):
                self.evict_slot(slot, reason)

    def stats(self):
        with self._lock:
            return {"entries": len(self._slots),
                    "cached_tokens": self.cached_tokens(),
                    "slots": sorted(self._slots)}
