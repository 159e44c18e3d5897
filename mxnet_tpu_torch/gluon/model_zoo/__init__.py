"""gluon.model_zoo (parity `mxnet_tpu/gluon/model_zoo/__init__.py`)."""
from . import model_store
from . import vision
from .vision import get_model

__all__ = ["model_store", "vision", "get_model"]
