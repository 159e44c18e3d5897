"""Transformer language model: the port of `mxnet_tpu/models/transformer.py`
(dense branch on one card).

The JAX package's `TransformerLM` is a pure function of a flat parameter
dict bound to a mesh; here it is an `nn.Module` on one device. Parameters
keep the JAX layouts (``x @ w``, `wqkv` as [D, 3D], the tied head as
``embed.T``) so weights cross over by copy (`models.convert`). Local
attention goes through `ops.flash_attention`: the hand-written kernel on a
CUDA tensor, the plain version on a CPU tensor. With a mesh whose `sp`
axis is above 1, attention is ring attention over the mesh's positions
(`parallel.ring_attention`, whose hops are the ring-hop kernel on a CUDA
tensor), as the JAX model's `_attention` takes it.

The incremental-decoding methods serve the generation engine
(`serving.generation`): `init_cache` allocates the KV slot slab,
`prefill` fills one slot from a prompt, `prefill_at` fills a slot's rows
past a forked prefix from the prompt's tail, `decode_step` extends every
slot by one token and `verify_step` by k + 1 (speculative decoding).
Their attention is plain products over the slab, as in the JAX package
(no Pallas kernel there, so no kernel here). They write the slab in
place, since a captured CUDA graph keeps its pointers, and take their
slot, length, offset, token and position operands as device tensors, so
one graph serves every slot and position. Not ported: the other mesh axes
and the sharding constraints, and the MoE FFN.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.mesh import AXIS_SP, axis_size
from ..parallel.ring_attention import ring_self_attention

__all__ = ["TransformerLMConfig", "TransformerLM"]

# the additive mask of the slab attention: large and finite, never -inf, so
# a row that masks every key gives finite garbage, not NaN
_MASKED = -1e9


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 4
    max_len: int = 2048
    dtype: str = "bfloat16"
    causal: bool = True
    tie_embeddings: bool = True
    # the Mixture-of-Experts fields of the JAX config; the port takes only
    # moe_experts == 0 (dense FFN)
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_loss: float = 0.01


def _scores(a, b):
    """``a @ b`` over a batch, in fp32: the JAX package's score products
    take ``preferred_element_type=float32``. A bf16 product on the card
    keeps its operands and writes fp32 (`bmm`'s ``out_dtype``); the CPU
    has no kernel for that, so there the operands are upcast, which gives
    the same exact products summed in fp32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _index(x, device):
    """A slot, length or position operand as a 1-D int64 tensor on
    `device`; a tensor is used as it is (the engine's static buffers)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    return torch.tensor([int(x)], dtype=torch.int64, device=device)


def _empty(device, dtype):
    return lambda *shape: nn.Parameter(
        torch.empty(shape, device=device, dtype=dtype))


class _Layer(nn.Module):
    """One pre-LN block's parameters, named as the JAX package's ``l{i}.*``."""

    def __init__(self, c, device, dtype):
        super().__init__()
        p = _empty(device, dtype)
        d, f = c.d_model, c.d_ff
        self.ln1_scale, self.ln1_bias = p(d), p(d)
        self.wqkv, self.wo = p(d, 3 * d), p(d, d)
        self.ln2_scale, self.ln2_bias = p(d), p(d)
        self.w1, self.b1 = p(d, f), p(f)
        self.w2, self.b2 = p(f, d), p(d)


class TransformerLM(nn.Module):
    """Decoder-only transformer LM on one device.

    `device` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the CPU. Parameters are created in the config's
    compute dtype and initialised from `generator` (a `torch.Generator`,
    seeded 0 on `device` when omitted). `mesh` (a `parallel.DeviceMesh`)
    with an `sp` axis above 1 shards attention's sequence over its
    positions, whose devices must be of `device`'s type; the parameters and
    the rest of the model stay on `device`."""

    def __init__(self, config, device=None, generator=None, mesh=None):
        super().__init__()
        if config.moe_experts:
            raise NotImplementedError(
                "the port's TransformerLM has no MoE FFN (moe_experts > 0)")
        if config.d_model % config.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        self.cfg = config
        self.device = resolve_device(device)
        if axis_size(mesh, AXIS_SP) > 1 and any(
                d.type != self.device.type for d in mesh.devices):
            raise ValueError(f"mesh positions {mesh.devices} are not all "
                             f"on {self.device.type} devices, as the model "
                             f"({self.device}) is")
        self.mesh = mesh
        dt = getattr(torch, config.dtype)
        c = config
        p = _empty(self.device, dt)
        self.embed = p(c.vocab_size, c.d_model)
        self.pos_embed = p(c.max_len, c.d_model)
        self.ln_f_scale, self.ln_f_bias = p(c.d_model), p(c.d_model)
        self.layers = nn.ModuleList(
            _Layer(c, self.device, dt) for _ in range(c.n_layers))
        if not c.tie_embeddings:
            self.lm_head = p(c.d_model, c.vocab_size)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init_params(generator)

    # -- parameters ---------------------------------------------------------

    @torch.no_grad()
    def init_params(self, generator):
        """The JAX package's rule: scales one, biases zero, every matrix
        normal / sqrt(fan_in), in the compute dtype. Draws on the
        generator's device, in sorted parameter-name order. The values
        differ from the JAX package's, whose generator is another."""
        for name, p in sorted(self.named_parameters()):
            if name.endswith("_scale"):
                p.fill_(1)
            elif name.endswith(("_bias", ".b1", ".b2")):
                p.zero_()
            else:
                x = torch.randn(p.shape, generator=generator,
                                device=generator.device, dtype=torch.float32)
                p.copy_(x / math.sqrt(p.shape[0]))

    # -- forward ------------------------------------------------------------

    @staticmethod
    def _ln(x, scale, bias):
        """LayerNorm in fp32 with the population variance, eps 1e-5."""
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        out = (x32 - mu) * torch.rsqrt(var + 1e-5)
        return (out * scale.float() + bias.float()).to(x.dtype)

    def _ffn(self, h, layer):
        """The block's second half: h + FFN(LayerNorm(h)), tanh GELU."""
        ln2 = self._ln(h, layer.ln2_scale, layer.ln2_bias)
        ff = F.gelu(ln2 @ layer.w1 + layer.b1, approximate="tanh")
        return h + ff @ layer.w2 + layer.b2

    def _attention(self, q, k, v):
        """Ring attention when the mesh's `sp` axis is above 1 (q, k and v
        split along L over its positions, the output joined on the model's
        device), else local attention; each runs its kernel on a CUDA
        tensor and its plain version on a CPU tensor."""
        if axis_size(self.mesh, AXIS_SP) > 1:
            return ring_self_attention(q, k, v, mesh=self.mesh,
                                       causal=self.cfg.causal)
        return flash_attention(q, k, v, causal=self.cfg.causal)

    def forward(self, tokens):
        """tokens [B, L] integer -> logits [B, L, V] in the compute dtype."""
        c = self.cfg
        b, seq = tokens.shape
        hd = c.d_model // c.n_heads
        h = F.embedding(tokens, self.embed) + self.pos_embed[None, :seq]
        for layer in self.layers:
            ln1 = self._ln(h, layer.ln1_scale, layer.ln1_bias)
            q, k, v = (ln1 @ layer.wqkv).split(c.d_model, dim=-1)
            # strided views of the projection: the kernel reads them in place
            q, k, v = (t.view(b, seq, c.n_heads, hd) for t in (q, k, v))
            attn = self._attention(q, k, v).reshape(b, seq, c.d_model)
            h = self._ffn(h + attn @ layer.wo, layer)
        h = self._ln(h, self.ln_f_scale, self.ln_f_bias)
        head = self.embed.t() if c.tie_embeddings else self.lm_head
        return h @ head

    # -- incremental decoding (serving/generation) ---------------------------

    def init_cache(self, max_slots, max_len=None):
        """The KV slot slab: two zeroed tensors (keys, values) of shape
        ``[max_slots, n_layers, n_heads, max_len, head_dim]`` in the compute
        dtype on the model's device, the JAX package's layout. In memory
        the layer is the outermost axis, so one layer's page
        ``cache[:, i]`` is contiguous and its slots and heads form one
        batch of the score products. Slot contents are garbage until a
        `prefill` claims the slot; reads are masked by the slot's length.
        Raises ValueError past ``cfg.max_len``."""
        c = self.cfg
        max_len = c.max_len if max_len is None else int(max_len)
        if max_len > c.max_len:
            raise ValueError(f"cache max_len {max_len} exceeds the model's "
                             f"positional range {c.max_len}")
        hd = c.d_model // c.n_heads
        shape = (c.n_layers, int(max_slots), c.n_heads, max_len, hd)
        return tuple(torch.zeros(shape, dtype=self.embed.dtype,
                                 device=self.device).transpose(0, 1)
                     for _ in range(2))

    def _head_logits(self, h):
        """Final LayerNorm and head, logits in fp32."""
        c = self.cfg
        h = self._ln(h, self.ln_f_scale, self.ln_f_bias)
        head = self.embed.t() if c.tie_embeddings else self.lm_head
        return (h @ head).float()

    @torch.inference_mode()
    def prefill(self, cache_k, cache_v, tokens, length, slot):
        """Full-prompt forward for ONE session: writes its K/V into rows
        ``[0, Lb)`` of slot `slot` of the slab, in place, and returns the
        logits at the last real token (position ``length - 1``).

        tokens : int [Lb]  the prompt padded (with anything) to its bucket;
                           the padded rows' K/V stay masked forever
        length : the real prompt length, 1 <= length <= Lb
        slot   : the slab slot to fill

        `length` and `slot` may be ints or one-element int64 tensors on the
        model's device; a captured graph needs the tensors. Returns
        ``(logits [V] fp32, cache_k, cache_v)``, the JAX method's shape."""
        c = self.cfg
        lb = tokens.shape[0]
        hd = c.d_model // c.n_heads
        scale = 1.0 / math.sqrt(hd)
        slot = _index(slot, self.device)
        length = _index(length, self.device)
        h = F.embedding(tokens, self.embed) + self.pos_embed[:lb]
        ar = torch.arange(lb, device=self.device)
        causal = torch.where(ar[:, None] >= ar[None, :], 0.0, _MASKED)
        for i, layer in enumerate(self.layers):
            ln1 = self._ln(h, layer.ln1_scale, layer.ln1_bias)
            # [H, Lb, hd] each
            q, k, v = ((ln1 @ layer.wqkv).view(lb, 3, c.n_heads, hd)
                       .permute(1, 2, 0, 3).unbind(0))
            cache_k[:, i, :, :lb].index_copy_(0, slot, k[None])
            cache_v[:, i, :, :lb].index_copy_(0, slot, v[None])
            s = _scores(q, k.transpose(1, 2)) * scale           # [H,Lb,Lb]
            p = torch.softmax(s + causal, dim=-1).to(h.dtype)
            attn = torch.bmm(p, v).transpose(0, 1).reshape(lb, c.d_model)
            h = self._ffn(h + attn @ layer.wo, layer)
        last = h.index_select(0, length - 1)                      # [1, D]
        return self._head_logits(last)[0], cache_k, cache_v

    @torch.inference_mode()
    def prefill_at(self, cache_k, cache_v, tokens, length, slot, offset):
        """Suffix prefill: the prompt's tail after a prefix-cache fork.
        Rows ``[0, offset)`` of slot `slot` already hold the K/V of the
        prompt's first `offset` tokens; this forward consumes the `length`
        remaining tokens, writes their K/V into rows
        ``[offset, offset + Lb)`` in place and returns the logits at the
        last real suffix token. Each layer scores the suffix queries
        against the slot's whole slab row, masked to ``j <= offset + i``.

        tokens : int [Lb]  the suffix padded to its bucket
        length : the real suffix length, 1 <= length <= Lb
        slot   : the slab slot
        offset : the forked prefix's length

        The rows written must lie in the slab (``offset + Lb`` at most its
        length): unlike JAX's clamping update, a row out of range is a
        device fault here, so the engine falls back to a full prefill
        where the suffix's bucket would overhang. Positions past the
        model's range read its last positional row, as JAX's clipping
        gather does (garbage the mask hides). `length`, `slot` and
        `offset` may be ints or one-element int64 tensors on the model's
        device. Returns ``(logits [V] fp32, cache_k, cache_v)``."""
        c = self.cfg
        lb, n_rows = tokens.shape[0], cache_k.shape[3]
        hd = c.d_model // c.n_heads
        scale = 1.0 / math.sqrt(hd)
        slot = _index(slot, self.device)
        length = _index(length, self.device)
        pos = _index(offset, self.device) + torch.arange(lb,
                                                         device=self.device)
        h = (F.embedding(tokens, self.embed)
             + self.pos_embed[pos.clamp(max=c.max_len - 1)])
        mask = torch.where(torch.arange(n_rows, device=self.device)[None, :]
                           <= pos[:, None], 0.0, _MASKED)          # [Lb, L]
        slots = slot.expand(lb)
        for i, layer in enumerate(self.layers):
            ln1 = self._ln(h, layer.ln1_scale, layer.ln1_bias)
            # [H, Lb, hd] each
            q, k, v = ((ln1 @ layer.wqkv).view(lb, 3, c.n_heads, hd)
                       .permute(1, 2, 0, 3).unbind(0))
            # rows pos of the slot: an index write, as a captured graph
            # cannot slice at a device-tensor offset ([S, L, H, hd] views)
            cache_k[:, i].transpose(1, 2).index_put_(
                (slots, pos), k.transpose(0, 1))
            cache_v[:, i].transpose(1, 2).index_put_(
                (slots, pos), v.transpose(0, 1))
            ck = cache_k[:, i].index_select(0, slot)[0]           # [H,L,hd]
            cv = cache_v[:, i].index_select(0, slot)[0]
            s = _scores(q, ck.transpose(1, 2)) * scale            # [H,Lb,L]
            p = torch.softmax(s + mask, dim=-1).to(h.dtype)
            attn = torch.bmm(p, cv).transpose(0, 1).reshape(lb, c.d_model)
            h = self._ffn(h + attn @ layer.wo, layer)
        last = h.index_select(0, length - 1)                      # [1, D]
        return self._head_logits(last)[0], cache_k, cache_v

    @torch.inference_mode()
    def decode_step(self, cache_k, cache_v, tokens, positions):
        """One step over the WHOLE slab: slot s consumes ``tokens[s]``,
        writes its K/V at row ``positions[s]``, in place, and attends over
        rows ``[0, positions[s]]``.

        tokens    : int [S] the token extending each slot (dead slots:
                    anything; the engine discards their output)
        positions : int [S] the row each token occupies, the slot's current
                    length (dead slots: a row no session owns)

        Every position must be below the slab's length: unlike JAX's
        clamping updates, an index out of range is a device fault here.
        Returns ``(logits [S, V] fp32, cache_k, cache_v)``."""
        c = self.cfg
        n_slots, n_rows = cache_k.shape[0], cache_k.shape[3]
        hd = c.d_model // c.n_heads
        scale = 1.0 / math.sqrt(hd)
        h = F.embedding(tokens, self.embed) + self.pos_embed[positions]
        slots = torch.arange(n_slots, device=self.device)
        # attend j <= positions[s]: the token just written attends to itself
        mask = torch.where(
            torch.arange(n_rows, device=self.device)[None, :]
            <= positions[:, None], 0.0, _MASKED)[:, None, None, :]
        for i, layer in enumerate(self.layers):
            ln1 = self._ln(h, layer.ln1_scale, layer.ln1_bias)
            # [S, H, 1, hd] each
            q, k, v = ((ln1 @ layer.wqkv).view(n_slots, 3, c.n_heads, 1, hd)
                       .unbind(1))
            ck, cv = cache_k[:, i], cache_v[:, i]                # [S,H,L,hd]
            ck[slots, :, positions] = k[:, :, 0]
            cv[slots, :, positions] = v[:, :, 0]
            batch = n_slots * c.n_heads
            s = _scores(q.reshape(batch, 1, hd),
                        ck.reshape(batch, n_rows, hd).transpose(1, 2))
            s = s.view(n_slots, c.n_heads, 1, n_rows) * scale + mask
            p = torch.softmax(s, dim=-1).to(h.dtype).view(batch, 1, n_rows)
            attn = torch.bmm(p, cv.reshape(batch, n_rows, hd))
            h = self._ffn(h + attn.view(n_slots, c.d_model) @ layer.wo,
                          layer)
        return self._head_logits(h), cache_k, cache_v

    @torch.inference_mode()
    def verify_step(self, cache_k, cache_v, tokens, positions):
        """Speculative-decoding verify: every slot consumes a block of
        ``K = k + 1`` tokens (its last committed token, then the draft's
        k proposals) starting at row ``positions[s]``; logits row ``i`` is
        the next-token distribution after ``tokens[:, :i + 1]``.

        The structure is K unrolled `decode_step` calls chained through
        the slab, not one K-query attention block: the per-token
        arithmetic is then that of the plain decode step, which keeps
        speculative greedy output bit-exact with the plain lane. Every
        row ``positions[s] + K - 1`` must lie in the slab (the engine's
        speculative scratch rows). Returns ``(logits [S, K, V] fp32,
        cache_k, cache_v)``."""
        steps = [self.decode_step(cache_k, cache_v, tokens[:, i],
                                  positions + i)[0]
                 for i in range(tokens.shape[1])]
        return torch.stack(steps, dim=1), cache_k, cache_v

    # -- training -----------------------------------------------------------

    def loss(self, tokens, targets):
        """Mean next-token negative log-likelihood, the softmax in fp32."""
        logp = torch.log_softmax(self.forward(tokens).float(), dim=-1)
        return -logp.gather(-1, targets[..., None]).mean()

    def make_train_step(self, lr=1e-3):
        """Return (step, init_opt), the JAX package's Adam train step.

        ``init_opt()`` gives the Adam state, {name: (m, v)} in fp32.
        ``step(opt_state, tokens, targets, step_no)`` takes one step and
        returns the loss. Unlike the JAX step it updates the parameters and
        the state in place. As there, the parameters stay in the compute
        dtype (no fp32 master copy): each update is computed in fp32 from
        the parameter and cast back, with t = step_no + 1."""
        b1, b2, eps = 0.9, 0.999, 1e-8

        def init_opt():
            return {name: (torch.zeros_like(p, dtype=torch.float32),
                           torch.zeros_like(p, dtype=torch.float32))
                    for name, p in self.named_parameters()}

        def step(opt_state, tokens, targets, step_no):
            params = dict(self.named_parameters())
            for p in params.values():
                p.grad = None
            loss = self.loss(tokens, targets)
            loss.backward()
            with torch.no_grad():
                t = torch.tensor(float(step_no) + 1, dtype=torch.float32,
                                 device=self.device)
                bc1 = 1 - torch.pow(b1, t)
                bc2 = 1 - torch.pow(b2, t)
                for name, p in params.items():
                    g = p.grad.float()
                    m, v = opt_state[name]
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    upd = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    p.copy_((p.float() - upd).to(p.dtype))
                    p.grad = None
            return loss.detach()

        return step, init_opt
