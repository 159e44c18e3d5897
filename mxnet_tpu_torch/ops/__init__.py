"""The port's operators. Importing this package registers every op of the
NDArray frontend (`registry`): plain torch functions, one module per family
as in `mxnet_tpu/ops/` (the fused `RNN` op in `rnn`, over cuDNN on a card;
the subgraph control flow in `control_flow_ops`; the image ops and
the host codec ops in `image_ops`). Beside them sit the
hand-written CUDA kernels of the JAX package's Pallas kernels, each with
its plain PyTorch version (`flash_attention`; `gradient_compression` at the
package root), which no registered op reaches."""
from . import registry
from .registry import register, get_op, list_ops, invoke

from . import elemwise       # noqa: F401
from . import broadcast      # noqa: F401
from . import reduce         # noqa: F401
from . import shape_ops      # noqa: F401
from . import indexing       # noqa: F401
from . import linalg         # noqa: F401
from . import init_ops       # noqa: F401
from . import nn             # noqa: F401
from . import vision         # noqa: F401
from . import random_ops     # noqa: F401
from . import ctc            # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import subgraph_ops   # noqa: F401
from . import rnn            # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import image_ops      # noqa: F401

# legacy v1 op names (reference `convolution_v1.cc` / `pooling_v1.cc`)
registry.alias("Convolution_v1", "Convolution")
registry.alias("Pooling_v1", "Pooling")
