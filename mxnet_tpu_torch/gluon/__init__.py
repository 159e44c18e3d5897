"""gluon, the imperative and hybrid neural-network API (parity
`mxnet_tpu/gluon/__init__.py`): Parameter, Block and HybridBlock, the
layers, the contrib layers (`contrib.nn`), the recurrent cells and layers
(`rnn`, `contrib.rnn`), the losses, the vision model zoo, utilities, the
Trainer, and `data` (datasets, samplers, `DataLoader`, vision datasets
and transforms).
"""
from . import parameter
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import rnn
from . import loss
from . import utils
from . import trainer
from .trainer import Trainer
from . import model_zoo
from . import contrib
from . import data

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "nn", "rnn", "contrib", "loss", "utils", "Trainer",
           "model_zoo", "data"]
