"""Image decode, resize, crop and augmentation, and the image iterators:
the port of `mxnet_tpu/image/` (parity `python/mxnet/image/`), also
``mx.img``. `image/detection.py` (`ImageDetIter`, the ``Det*`` augmenters)
is not ported yet (ROADMAP.md queue A, item A.4, with the detection ops)."""
from .image import *  # noqa: F401,F403
