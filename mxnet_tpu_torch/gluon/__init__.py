"""gluon, the imperative and hybrid neural-network API (parity
`mxnet_tpu/gluon/__init__.py`): Parameter, Block and HybridBlock, the
layers, the losses, the ResNet model zoo, utilities and the Trainer.

Not ported yet (ROADMAP.md queue A): `gluon.rnn`, `gluon.data`,
`gluon.contrib` and the model zoo's other families.
"""
from . import parameter
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from . import utils
from . import trainer
from .trainer import Trainer
from . import model_zoo

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "nn", "loss", "utils", "Trainer", "model_zoo"]
