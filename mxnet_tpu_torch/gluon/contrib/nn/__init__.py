"""gluon.contrib.nn: the port of `mxnet_tpu/gluon/contrib/nn/` (parity
`python/mxnet/gluon/contrib/nn/basic_layers.py`): Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm and
PixelShuffle1D/2D/3D."""
from .basic_layers import *  # noqa: F401,F403
from . import basic_layers   # noqa: F401
