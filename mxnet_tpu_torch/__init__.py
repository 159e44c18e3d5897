"""mxnet_tpu_torch: the PyTorch and CUDA port of `mxnet_tpu`.

``import mxnet_tpu_torch as mx`` gives the core of the JAX package's public
surface: `mx.nd` (NDArray, its op namespace and `save`/`load`),
`mx.autograd`, `mx.random`, and the contexts `mx.cpu()` / `mx.gpu(i)`.
The default context is ``gpu(0)``: without a card, an array asked for with
no explicit ``ctx=mx.cpu()`` raises.

The port runs on one NVIDIA Hopper card. Plain tensor code is PyTorch; each
kernel the JAX package wrote in Pallas for the TPU is a kernel written by
hand for Hopper, under `ops/csrc/`, built with nvcc at first use. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``, and raise
when no card is present.

Ported so far: the NDArray runtime, the op registry with the elementwise,
broadcast, reduction, shape, indexing, creation, neural-network, random,
CTC and optimizer-update op families, and autograd on torch's engine
(`ndarray`, `ops`, `autograd`, `random`, `context`); every optimizer of
the JAX package (`optimizer`, SGD, NAG and Adam with a fused multi-tensor
update); `models.transformer.TransformerLM` (dense forward, loss and
the Adam train step) with the flash-attention forward kernel
(`ops.flash_attention`); data-parallel training through the kvstore
(`gluon.Trainer`, `kvstore`, `parallel.dist`, `optimizer`, `model`) with
2-bit gradient compression, whose quantizer is a kernel
(`gradient_compression`); sequence parallelism by ring attention over the
`sp` axis of a mesh that one process holds (`parallel.mesh`,
`parallel.ring_attention`, `TransformerLM(..., mesh=...)`), whose hop is a
kernel (`ops.flash_attention.flash_block_partials`); generation serving
(`serving.generation.GenerationEngine` over the KV-cache methods of
`TransformerLM`, `serving.admission`, `serving.warmup`), whose prefill and
decode programs are CUDA graphs captured once (`compile_cache`); its path
runs no TPU kernel's port, as the JAX engine's runs no Pallas kernel; and
the gluon training path (`gluon`: Parameter, Block and HybridBlock, whose
`hybridize` captures the forward and backward as CUDA graphs (`_cached_op`),
the layers, losses and ResNet model zoo; `initializer`, `io.NDArrayIter`,
`metric`, `lr_scheduler`, and the fused multi-tensor SGD update of
`optimizer`), which runs no TPU kernel's port either; and the symbolic
path (`mx.sym`: Symbol, its op namespace, shape inference, JSON and the
`Executor`; `mx.mod`: `Module` with `fit`, whose training step is one
captured CUDA graph a signature on a card; checkpoints in `model`;
`callback`, `monitor`, `AttrScope`; the symbolic ResNet of
`models.resnet`; `gluon.HybridBlock.export` and `gluon.SymbolBlock`),
which runs no TPU kernel's port either; and the serving stack of that path
(`serving.Predictor`, one captured CUDA graph a batch-size bucket, with
the ``TPU_FUSE`` conv+BN folding of `symbol.subgraph` / `symbol.fusion`;
`serving.DynamicBatcher`; `serving.rollout` with live weight swaps;
`health` probes; `resilience`), which runs no TPU kernel's port either;
and the observability planes every path above reports into, each off
unless its switch is set (`telemetry`, `tracing`, the lock-order recorder
`analysis`, `health` with the beacons, watchdog, SLO tracker and
autoscale signal, `profiler` over torch.profiler, the memory census
`memory`, the roofline `observatory`, and `compile_cache`'s accounting);
and the recurrent path (the fused `RNN` op over cuDNN, `gluon.rnn` and
`gluon.contrib.rnn`, `nd.contrib` / `sym.contrib` foreach, while_loop and
cond, `rnn.BucketSentenceIter` and `mod.BucketingModule`), which runs no
TPU kernel's port either; and the image input pipeline (`recordio`,
`image` / `img` with the augmenters, `ImageIter` and `ImageRecordIter`,
`gluon.data` with the `DataLoader` and the vision datasets and
transforms, the ``_image_*`` ops) and the whole vision model zoo, which
runs no TPU kernel's port either.
"""
from . import autograd, ndarray, random
from . import ndarray as nd
from . import initializer
from . import initializer as init
from . import name, lr_scheduler, optimizer, metric, io, gluon
from . import attribute, symbol, module, model, callback, monitor
from . import analysis, telemetry, tracing, profiler, memory, observatory
from . import resilience, health, serving
from . import rnn
from . import recordio, image
from . import image as img
from . import symbol as sym
from . import module as mod
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus, \
    resolve_device, tpu
from .symbol import Symbol

__all__ = ["nd", "ndarray", "autograd", "random", "initializer", "init",
           "name", "lr_scheduler", "optimizer", "metric", "io", "gluon",
           "attribute", "symbol", "sym", "Symbol", "module", "mod", "model",
           "callback", "monitor", "AttrScope", "resilience", "health",
           "serving", "analysis", "telemetry", "tracing", "profiler",
           "memory", "observatory", "rnn", "recordio", "image", "img",
           "cpu", "gpu", "tpu", "num_gpus", "Context", "current_context",
           "MXNetError", "resolve_device"]
