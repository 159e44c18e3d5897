"""Random samplers: the port of `mxnet_tpu/ops/random_ops.py`
(`src/operator/random/sample_op.cc` ``_random_*``, `multisample_op.cc`
``_sample_*`` with one set of parameters a row, `sample_multinomial_op.cc`,
`shuffle_op.cc`, `unique_sample_op.cc`).

Every op is ``needs_rng``: the frontend passes the `torch.Generator` of
the output's device (`mxnet_tpu_torch.random`), so `mx.random.seed` makes
draws repeat; the streams are torch's, not threefry's. Each op returns the
JAX op's dtype (float32 by default; ``randint`` and ``multinomial`` int32).
Every sampler here is one that a CUDA graph can capture (no host
synchronization): the categorical draw of ``multinomial`` and the
permutation of ``shuffle`` are argmax / argsort over uniform draws (the
Gumbel-max trick and random keys), not `torch.multinomial` or
`torch.randperm`.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ._utils import as_tuple, is_none, parse_bool
from .registry import register


def _dt(dtype, default="float32"):
    return torch_dtype(default if is_none(dtype) else dtype)


def _shape(shape):
    return as_tuple(shape) or ()


def _uniform(gen, shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        generator=gen)


def _normal(gen, shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(
        generator=gen)


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws, one per element of the fp32 tensor
    ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


def _full(value, shape, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


@register("_random_uniform", aliases=["random_uniform", "uniform"],
          needs_rng=True)
def _random_uniform(gen, low=0.0, high=1.0, shape=(), dtype="float32",
                    ctx=None, device=None, **kw):
    """U(low, high) draws of ``shape``."""
    out = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    return out.uniform_(float(low), float(high), generator=gen).to(_dt(dtype))


@register("_random_normal", aliases=["random_normal", "normal"],
          needs_rng=True)
def _random_normal(gen, loc=0.0, scale=1.0, shape=(), dtype="float32",
                   ctx=None, device=None, **kw):
    """N(loc, scale^2) draws of ``shape``."""
    out = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    return out.normal_(float(loc), float(scale), generator=gen).to(
        _dt(dtype))


@register("_random_gamma", aliases=["random_gamma"], needs_rng=True)
def _random_gamma(gen, alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  ctx=None, device=None, **kw):
    """Gamma draws of shape ``alpha`` and scale ``beta``."""
    return (_gamma(gen, _full(alpha, _shape(shape), device))
            * float(beta)).to(_dt(dtype))


@register("_random_exponential", aliases=["random_exponential"],
          needs_rng=True)
def _random_exponential(gen, lam=1.0, shape=(), dtype="float32", ctx=None,
                        device=None, **kw):
    """Exponential draws of rate ``lam``."""
    out = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    return out.exponential_(float(lam), generator=gen).to(_dt(dtype))


@register("_random_poisson", aliases=["random_poisson"], needs_rng=True)
def _random_poisson(gen, lam=1.0, shape=(), dtype="float32", ctx=None,
                    device=None, **kw):
    """Poisson draws of rate ``lam``, as floats."""
    return _poisson(gen, _full(lam, _shape(shape), device)).to(_dt(dtype))


def _nb(gen, k, p):
    """NB(k, p) as the gamma-Poisson mixture: lambda ~ Gamma(k) (1-p)/p,
    the draw ~ Poisson(lambda)."""
    return _poisson(gen, _gamma(gen, k) * (1.0 - p) / p)


def _gnb(gen, mu, alpha):
    """Generalized NB(mu, alpha): lambda ~ Gamma(1/alpha) mu alpha."""
    return _poisson(gen, _gamma(gen, 1.0 / alpha) * (mu * alpha))


@register("_random_negative_binomial", aliases=["random_negative_binomial"],
          needs_rng=True)
def _random_negative_binomial(gen, k=1, p=1.0, shape=(), dtype="float32",
                              ctx=None, device=None, **kw):
    """Negative binomial draws: failures before the ``k``-th success of
    probability ``p``."""
    shape = _shape(shape)
    return _nb(gen, _full(k, shape, device), float(p)).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial"], needs_rng=True)
def _random_gnb(gen, mu=1.0, alpha=1.0, shape=(), dtype="float32", ctx=None,
                device=None, **kw):
    """Generalized negative binomial draws of mean ``mu`` and dispersion
    ``alpha``."""
    shape = _shape(shape)
    return _gnb(gen, float(mu), _full(alpha, shape, device)).to(_dt(dtype))


@register("_random_randint", aliases=["random_randint", "randint"],
          needs_rng=True)
def _random_randint(gen, low=0, high=1, shape=(), dtype="int32", ctx=None,
                    device=None, **kw):
    """Integers uniform on [low, high)."""
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         dtype=_dt(dtype, "int32"), device=device)


# -- _sample_*: one set of parameters a row ----------------------------------

def _per_row(draw):
    """An op over parameter tensors of one shape P: ``shape`` more draws
    for each element, an output of P + shape."""
    def impl(gen, *params, shape=(), dtype="float32", **kw):
        out_shape = tuple(params[0].shape) + _shape(shape)
        extra = (1,) * (len(out_shape) - params[0].dim())
        ps = [p.to(torch.float32).reshape(tuple(p.shape) + extra)
              for p in params]
        return draw(gen, ps, out_shape, params[0].device).to(_dt(dtype))

    return impl


def _bcast(p, shape):
    return p.expand(shape).contiguous()


register("_sample_uniform", aliases=["sample_uniform"], needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _uniform(gen, s, dev) * (p[1] - p[0])
             + p[0]))
register("_sample_normal", aliases=["sample_normal"], needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _normal(gen, s, dev) * p[1] + p[0]))
register("_sample_gamma", aliases=["sample_gamma"], needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _gamma(gen, _bcast(p[0], s)) * p[1]))
register("_sample_exponential", aliases=["sample_exponential"],
         needs_rng=True)(
    _per_row(lambda gen, p, s, dev: torch.empty(
        s, dtype=torch.float32, device=dev).exponential_(generator=gen)
        / p[0]))
register("_sample_poisson", aliases=["sample_poisson"], needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _poisson(gen, _bcast(p[0], s))))
register("_sample_negative_binomial", aliases=["sample_negative_binomial"],
         needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _nb(gen, _bcast(p[0], s), p[1])))
register("_sample_generalized_negative_binomial",
         aliases=["sample_generalized_negative_binomial"], needs_rng=True)(
    _per_row(lambda gen, p, s, dev: _gnb(gen, p[0], _bcast(p[1], s))))


def _gumbel(gen, shape, device):
    """Standard Gumbel draws, -log(-log U)."""
    return -torch.log(-torch.log(_uniform(gen, shape, device)))


@register("_sample_multinomial", aliases=["sample_multinomial"],
          needs_rng=True)
def _sample_multinomial(gen, data, shape=(), get_prob=False, dtype="int32",
                        **kw):
    """Category indices drawn from the last axis of ``data``
    (probabilities), ``shape`` of them per distribution, by the Gumbel-max
    trick; with ``get_prob`` also the log-probability of each draw."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    logits = torch.log(torch.clamp(data.to(torch.float32), min=1e-30))
    flat = logits.reshape(-1, logits.shape[-1])
    noise = _gumbel(gen, (flat.shape[0], max(n, 1), flat.shape[-1]),
                    data.device)
    idx = torch.argmax(flat[:, None, :] + noise, dim=-1)
    out_shape = (tuple(data.shape[:-1]) + shape) if data.dim() > 1 else shape
    out = idx.reshape(out_shape).to(_dt(dtype, "int32"))
    if parse_bool(get_prob):
        lp = torch.gather(torch.log_softmax(flat, dim=-1), 1, idx)
        return out, lp.reshape(out_shape)
    return out


@register("_shuffle", aliases=["shuffle"], needs_rng=True)
def _shuffle(gen, data, **kw):
    """``data`` permuted along its first axis: the order of uniform
    keys."""
    keys = _uniform(gen, (data.shape[0],), data.device)
    return data[torch.argsort(keys)]


@register("_sample_unique_zipfian", needs_rng=True, num_outputs=2)
def _sample_unique_zipfian(gen, range_max=1, shape=(), device=None, **kw):
    """Zipfian draws without replacement over [0, range_max), P(k) =
    (log(k+2) - log(k+1)) / log(range_max + 1), and each row's count of
    tries. As in the JAX package, the draw is exact (the top n of log P
    plus Gumbel noise) and the tries are the expected count, solved by 25
    Newton steps of sum(1 - (1-p)^t) = n, rounded up."""
    shape = _shape(shape)
    batch, n = shape if len(shape) == 2 else (1, shape[-1] if shape else 1)
    rm = int(range_max)
    ks = torch.arange(rm, dtype=torch.float32, device=device)
    # fp32 scalars made on the device (a host copy cannot be captured)
    norm = torch.log(torch.log(torch.full((), float(rm) + 1.0,
                                          device=device)))
    logp = torch.log(torch.log(ks + 2.0) - torch.log(ks + 1.0)) - norm
    _, idx = torch.topk(logp + _gumbel(gen, (batch, rm), device), n, dim=-1)
    samples = idx.to(torch.int32).reshape(shape if len(shape) == 2
                                          else (n,))
    log1mp = torch.clamp(torch.log1p(-torch.exp(logp)), min=-30.0)
    t = torch.full((), float(n), dtype=torch.float32, device=device)
    for _ in range(25):
        e = torch.exp(t * log1mp)
        f = torch.sum(1.0 - e) - n
        fp = torch.sum(-log1mp * e)
        t = t - f / torch.clamp(fp, min=1e-12)
    trials = torch.full((batch,), 0.0, device=device) + torch.ceil(t)
    return samples, trials.to(torch.int32)
