"""The overlap switch of `mxnet_tpu/io/staging.py`.

``MXNET_OVERLAP`` turns every overlap lane on or off at once. The port has
one so far: the serving batcher stages its next flush while the current
one runs on the card (`serving/batcher.py`). ``0`` restores lockstep.
Not ported yet (ROADMAP.md queue A, item A.3): the `DeviceStager` ring and
the other lanes (`fit`, the generation tick).
"""
from __future__ import annotations

from ..base import getenv, register_env

__all__ = ["overlap_enabled"]

register_env("MXNET_OVERLAP", 1,
             "overlap host work (the serving batcher's next flush) with "
             "the card's in-flight work; 0 = lockstep")


def overlap_enabled():
    """One switch for every overlap lane."""
    return bool(int(getenv("MXNET_OVERLAP") or 0))
