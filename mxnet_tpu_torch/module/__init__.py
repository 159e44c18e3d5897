"""mx.mod: the Module API (parity `mxnet_tpu/module/`). `BucketingModule`
is not ported yet (ROADMAP.md queue A, item A.6)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
