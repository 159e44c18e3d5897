"""gluon.data: the port of `mxnet_tpu/gluon/data/` (parity
`python/mxnet/gluon/data/__init__.py`): datasets, samplers, the
`DataLoader`, and `vision` (datasets from local files and transforms)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403

from . import dataset
from . import sampler
from . import dataloader
from . import vision
