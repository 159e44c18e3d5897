"""mx.mod: the Module API (parity `mxnet_tpu/module/`): Module and
BucketingModule."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
