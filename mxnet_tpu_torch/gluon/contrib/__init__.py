"""gluon.contrib: the port of `mxnet_tpu/gluon/contrib/`, its recurrent
cells (`rnn`) so far. `gluon.contrib.nn` is not ported yet (ROADMAP.md
queue A, item A.6)."""
from . import rnn  # noqa: F401
