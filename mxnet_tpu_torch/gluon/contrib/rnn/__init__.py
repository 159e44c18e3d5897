"""gluon.contrib.rnn: the port of `mxnet_tpu/gluon/contrib/rnn/` (parity
`python/mxnet/gluon/contrib/rnn/`): the Conv{1,2,3}D RNN, LSTM and GRU
cells, VariationalDropoutCell and LSTMPCell."""
from .conv_rnn_cell import *  # noqa: F401,F403
from .rnn_cell import *       # noqa: F401,F403
from . import conv_rnn_cell   # noqa: F401
from . import rnn_cell        # noqa: F401
