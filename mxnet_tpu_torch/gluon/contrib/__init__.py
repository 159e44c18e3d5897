"""gluon.contrib: the port of `mxnet_tpu/gluon/contrib/` (parity
`python/mxnet/gluon/contrib/__init__.py`): the contrib layers (`nn`) and
recurrent cells (`rnn`)."""
from . import nn   # noqa: F401
from . import rnn  # noqa: F401
