"""Automatic naming of blocks and symbols: the port's own copy of
`mxnet_tpu/name.py` (parity `python/mxnet/name.py`)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """Hands out ``hint0``, ``hint1``, ... for unnamed objects; ``with``
    makes it the thread's current manager."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """A manager that prepends ``prefix`` to every name it hands out."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The thread's current manager (a fresh one at first use)."""
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
