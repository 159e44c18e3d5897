"""Contrib layers: the port of `mxnet_tpu/gluon/contrib/nn/basic_layers.py`
(parity `python/mxnet/gluon/contrib/nn/basic_layers.py`).

`Concurrent` runs its children on one input and concatenates their
outputs; hybridized, the branches are one captured program. `SyncBatchNorm`
is `_contrib_SyncBatchNorm`, whose statistics are those of one process's
batch, as the JAX op's are of one device's.
"""
from __future__ import annotations

from ...block import Block, HybridBlock
from ...nn import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Run the children on the same input and concatenate their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as F

        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable `Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """The identity: a placeholder branch of a `Concurrent`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """An Embedding whose gradient is row-sparse: backward gives a
    `RowSparseNDArray` of the touched rows only, and SGD's or Adam's lazy
    update moves those rows alone, so a lookup into a 1,000,001-row table
    costs O(batch) in backward and update, never O(table)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": True}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype,
                                      grad_stype="row_sparse")

    def forward(self, x):
        from .... import ndarray as F

        return F.Embedding(x, self.weight.data(x.context), **self._kwargs)

    def __repr__(self):
        s = "{block_name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(block_name=self.__class__.__name__, **self._kwargs)


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm (parity contrib
    basic_layers.py:152, `_contrib_SyncBatchNorm`); in one process its
    statistics are the batch's, as BatchNorm's."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.contrib.SyncBatchNorm(
            x, gamma, beta, running_mean, running_var,
            eps=self._kwargs["eps"], momentum=self._kwargs["momentum"],
            fix_gamma=self._kwargs["fix_gamma"],
            use_global_stats=self._kwargs["use_global_stats"], name="fwd")


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        try:
            self._factors = tuple(int(f) for f in factor)
        except TypeError:
            self._factors = (int(factor),) * ndim
        if len(self._factors) != ndim:
            raise ValueError(f"wrong factor length {self._factors} for "
                             f"{ndim}d pixel shuffle")

    def __repr__(self):
        return f"{self.__class__.__name__}({self._factors})"


class PixelShuffle1D(_PixelShuffle):
    """(N, C*f, W) -> (N, C, W*f), the sub-pixel upsampling."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)

    def hybrid_forward(self, F, x):
        f, = self._factors
        x = F.reshape(x, (0, -4, -1, f, 0))      # (N, C, f, W)
        x = F.transpose(x, (0, 1, 3, 2))          # (N, C, W, f)
        return F.reshape(x, (0, 0, -3))           # (N, C, W*f)


class PixelShuffle2D(_PixelShuffle):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        x = F.reshape(x, (0, -4, -1, f1 * f2, 0, 0))
        x = F.reshape(x, (0, 0, -4, f1, f2, 0, 0))
        x = F.transpose(x, (0, 1, 4, 2, 5, 3))
        return F.reshape(x, (0, 0, -3, -3))


class PixelShuffle3D(_PixelShuffle):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3), one factor at
    a time so that no intermediate exceeds 6 dimensions."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        x = F.reshape(x, (0, -4, -1, f3, 0, 0, 0))  # N, C f1 f2, f3, D, H, W
        x = F.transpose(x, (0, 1, 3, 4, 5, 2))      # N, C f1 f2, D, H, W, f3
        x = F.reshape(x, (0, 0, 0, 0, -3))          # N, C f1 f2, D, H, W f3
        x = F.reshape(x, (0, -4, -1, f2, 0, 0, 0))  # N, C f1, f2, D, H, W f3
        x = F.transpose(x, (0, 1, 3, 4, 2, 5))      # N, C f1, D, H, f2, W f3
        x = F.reshape(x, (0, 0, 0, -3, 0))          # N, C f1, D, H f2, W f3
        x = F.reshape(x, (0, -4, -1, f1, 0, 0, 0))  # N, C, f1, D, H f2, W f3
        x = F.transpose(x, (0, 1, 3, 2, 4, 5))      # N, C, D, f1, H f2, W f3
        return F.reshape(x, (0, 0, -3, 0, 0))       # N, C, D f1, H f2, W f3
