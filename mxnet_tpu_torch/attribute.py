"""Symbol attribute scoping: the port's own copy of
`mxnet_tpu/attribute.py` (parity `python/mxnet/attribute.py`)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    """``with AttrScope(group='4'):`` attaches attrs to symbols created
    inside."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be string")
        self._attr = kwargs

    def get(self, attr):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope
        AttrScope._current.value = self._old_scope


def current():
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
