"""gluon.data.vision: the port of `mxnet_tpu/gluon/data/vision/` (parity
`python/mxnet/gluon/data/vision/`): datasets and transforms."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
