"""Data iterators (parity `mxnet_tpu/io/`)."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter"]
