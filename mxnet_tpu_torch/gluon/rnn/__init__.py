"""gluon.rnn: the port of `mxnet_tpu/gluon/rnn/` (parity
`python/mxnet/gluon/rnn/__init__.py`): the recurrent cells and the fused
RNN, LSTM and GRU layers."""
from . import rnn_cell, rnn_layer
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
