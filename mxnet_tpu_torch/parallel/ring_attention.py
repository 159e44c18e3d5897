"""Ring attention: exact attention over a sequence sharded across the `sp`
positions of a mesh. The port of `mxnet_tpu/parallel/ring_attention.py`.

Each position keeps its query block and passes its K/V block around the ring
(`collectives.ring_shift`), combining the partial attention of every hop
with the streaming-softmax update. The JAX package runs this inside
`shard_map`, one program for all positions; the port runs it in one process
that holds every position's shard, hop by hop over all positions, on the
positions' devices. Every hop is `ops.flash_attention.block_partials`: the
hand-written kernel on a CUDA tensor, the plain `_block_attn` on a CPU
tensor, and a raise on any other device. The schedule is the reference's, so that rounding follows it: hop 0
on a position's own block, then sp - 1 shifts, K/V block
(my_idx - i - 1) % sp at hop i + 1, every hop computed (fully masked ones
too), and the final o / l in q's dtype.
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import block_partials
from .collectives import ring_shift
from .mesh import AXIS_SP, axis_size

__all__ = ["ring_attention", "ring_self_attention"]

_NEG_INF = -1e30  # finite: a fully masked block drops out with weight 0


def _block_attn(q, k, v, bias=None, scale=None):
    """One Q-block x K/V-block partial attention: the plain version of the
    ring-hop kernel. Returns (o, m, l): o = exp(s - m) @ v unnormalized
    [B, Lq, H, D] in v's dtype, m the row max and l the row sum-exp
    [B, H, Lq, 1] fp32, for s = q k^T * scale (+ bias) in fp32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.detach())
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m, l


def _bhql_to_bqhl(x):
    # [B, H, Lq, 1] scaling factor applied to [B, Lq, H, D]
    return x.permute(0, 2, 1, 3)


def _combine(o1, m1, l1, o2, m2, l2):
    """Merge two streaming-softmax partials (the flash-attention rescale).
    The max shift carries no gradient, as `_block_attn`'s does not: the
    shift cancels exactly in the softmax."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1.detach() - m.detach())
    a2 = torch.exp(m2.detach() - m.detach())
    l = l1 * a1 + l2 * a2
    o = (o1 * _bhql_to_bqhl(a1).to(o1.dtype)
         + o2 * _bhql_to_bqhl(a2).to(o2.dtype))
    return o, m, l


def _full_causal_bias(lq, lk, q0=0, k0=0, device=None):
    """The additive causal mask [1, 1, Lq, Lk] of query positions q0.. against
    key positions k0..: 0 where q >= k, else the finite -1e30 (-inf would
    make a fully masked block's max -inf and the combine inf - inf = nan)."""
    q_pos = q0 + torch.arange(lq, device=device)[:, None]
    k_pos = k0 + torch.arange(lk, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, _NEG_INF)[None, None].float()


def ring_attention(qs, ks, vs, causal=False, scale=None):
    """Exact attention where K/V circulate the ring of positions.

    `qs`, `ks` and `vs` list each position's LOCAL sequence shard in ring
    order, each on its position's device: q [B, Lq, H, D], k and v
    [B, Lk, H, D]. ``causal`` masks by GLOBAL position (position i holds rows
    [i*Lq, (i+1)*Lq)). Returns each position's output shard, in q's dtype,
    on its device."""
    n = len(qs)
    lq, lk = qs[0].shape[1], ks[0].shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])

    def bias_for(my_idx, kv_idx):
        if not causal:
            return None
        return _full_causal_bias(lq, lk, my_idx * lq, kv_idx * lk,
                                 qs[my_idx].device)

    parts = [block_partials(qs[r], ks[r], vs[r], bias_for(r, r), scale)
             for r in range(n)]
    for i in range(n - 1):
        ks, vs = ring_shift(ks), ring_shift(vs)
        for r in range(n):
            kv_idx = (r - i - 1) % n
            o2, m2, l2 = block_partials(qs[r], ks[r], vs[r],
                                        bias_for(r, kv_idx), scale)
            parts[r] = _combine(*parts[r], o2, m2, l2)
    return [(o / _bhql_to_bqhl(l).to(o.dtype)).to(q.dtype)
            for (o, _, l), q in zip(parts, qs)]


def ring_self_attention(q, k, v, mesh=None, axis_name=AXIS_SP, causal=False,
                        scale=None):
    """Attention over GLOBAL [B, L, H, D] tensors with the sequence sharded
    over the `axis_name` positions of `mesh`: q, k and v are split along L,
    each shard sent to its position's device, the ring run, and the output
    joined on q's device. With no mesh, or an axis of size 1, it is one hop
    over the whole sequence (the kernel on a CUDA tensor). Raises ValueError
    when L is not divisible by the axis size."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        bias = (_full_causal_bias(q.shape[1], k.shape[1], device=q.device)
                if causal else None)
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        o, _, l = block_partials(q, k, v, bias, scale)
        return (o / _bhql_to_bqhl(l).to(o.dtype)).to(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[1] % n:
            raise ValueError(f"ring attention: {name}'s sequence length "
                             f"{t.shape[1]} is not divisible by the "
                             f"{axis_name} axis size {n}")
    # every other axis has size 1, so the mesh's positions are the ring's
    qs, ks, vs = ([s.to(d) for s, d in zip(t.chunk(n, dim=1), mesh.devices)]
                  for t in (q, k, v))
    outs = ring_attention(qs, ks, vs, causal=causal, scale=scale)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
