"""Data parallelism across worker processes over `torch.distributed` (see
`parallel.dist`)."""
from .dist import KVStoreDistTPUSync, init_process_group

__all__ = ["KVStoreDistTPUSync", "init_process_group"]
