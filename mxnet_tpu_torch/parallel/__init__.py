"""Parallelism: data parallelism across worker processes over
`torch.distributed` (`parallel.dist`), and sequence parallelism by ring
attention over the `sp` positions of a mesh that one process holds
(`parallel.mesh`, `parallel.collectives`, `parallel.ring_attention`)."""
from .collectives import ring_shift
from .dist import KVStoreDistTPUSync, init_process_group
from .mesh import (AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP,
                   DeviceMesh, axis_size, create_mesh)
from .ring_attention import ring_attention, ring_self_attention

__all__ = ["AXIS_DP", "AXIS_EP", "AXIS_FSDP", "AXIS_PP", "AXIS_SP",
           "AXIS_TP", "DeviceMesh", "KVStoreDistTPUSync", "axis_size",
           "create_mesh", "init_process_group", "ring_attention",
           "ring_self_attention", "ring_shift"]
