"""Elementwise ops: the port of `mxnet_tpu/ops/elemwise.py` (the reference's
`elemwise_unary_op_basic.cc`, `elemwise_binary_op*.cc`,
`elemwise_binary_scalar_op*.cc` and the functors of `mshadow_op.h`).
"""
from __future__ import annotations

import functools

import torch

from ..base import torch_dtype
from ._utils import as_tuple
from .registry import alias, register


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": torch.round,  # half to even, as jnp.rint
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "round": torch.round,  # half to even, as the JAX package's jnp.round
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": torch.relu,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register(_name)((lambda f: lambda x, **kw: f(x))(_f))


@register("negative", aliases=["_np_negative"])
def _negative(x, **kw):
    return -x


@register("identity", aliases=["_copy", "stop_gradient_identity"])
def _identity(x, **kw):
    return x


@register("BlockGrad", aliases=["stop_gradient"])
def _block_grad(x, **kw):
    return x.detach()


@register("make_loss")
def _make_loss(x, **kw):
    return x


@register("zeros_like")
def _zeros_like(x, **kw):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x, **kw):
    return torch.ones_like(x)


@register("shape_array")
def _shape_array(x, **kw):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register("size_array")
def _size_array(x, **kw):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("Cast", aliases=["cast"])
def _cast(x, dtype="float32", **kw):
    return x.to(torch_dtype(dtype))


@register("amp_cast")
def _amp_cast(x, dtype="float32", **kw):
    return x.to(torch_dtype(dtype))


@register("amp_multicast",
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def _amp_multicast(*xs, num_outputs=1, **kw):
    widest = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return tuple(x.to(widest) for x in xs)


@register("clip")
def _clip(x, a_min=None, a_max=None, **kw):
    return torch.clamp(x, float(a_min), float(a_max))


# ---------------------------------------------------------------------------
# binary elemwise (same shape): `elemwise_add` etc.
# ---------------------------------------------------------------------------

_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.true_divide,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_power": torch.pow,
    "_hypot": torch.hypot,
    "_mod": torch.remainder,  # python-style, as jnp.mod
}

for _name, _f in _BINARY.items():
    register(_name)((lambda f: lambda a, b, **kw: f(a, b))(_f))

alias("_plus", "elemwise_add")
alias("_add", "elemwise_add")
alias("_sub", "elemwise_sub")
alias("_minus", "elemwise_sub")
alias("_mul", "elemwise_mul")
alias("_div", "elemwise_div")
alias("_Plus", "elemwise_add")


def _cmp(f):
    def impl(a, b, **kw):
        return f(a, b).to(torch.promote_types(a.dtype, b.dtype))

    return impl


register("_equal")(_cmp(torch.eq))
register("_not_equal")(_cmp(torch.ne))
register("_greater")(_cmp(torch.gt))
register("_greater_equal")(_cmp(torch.ge))
register("_lesser")(_cmp(torch.lt))
register("_lesser_equal")(_cmp(torch.le))
register("_logical_and")(_cmp(torch.logical_and))
register("_logical_or")(_cmp(torch.logical_or))
register("_logical_xor")(_cmp(torch.logical_xor))


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5, **kw):
    """max(0, min(1, alpha*x + beta)) (`elemwise_unary_op_basic.cc:109`)."""
    return torch.clamp(float(alpha) * x + float(beta), 0.0, 1.0)


@register("add_n", aliases=["ElementWiseSum", "_sum"])
def _add_n(*xs, num_args=None, **kw):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# scalar ops: the `_plus_scalar` family
# ---------------------------------------------------------------------------

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, torch.full_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, torch.full_like(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, torch.full_like(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: ((x != 0) & bool(s)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: ((x != 0) | bool(s)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: ((x != 0) ^ bool(s)).to(x.dtype),
    "_scatter_plus_scalar": lambda x, s: x + s,
    "_scatter_minus_scalar": lambda x, s: x - s,
}


def _scalar_operand(x, scalar):
    """The scalar is parsed AS the array's dtype, as the reference's C++
    static_cast<DType> does: an integer array keeps integer arithmetic and
    a fractional scalar truncates. A float array keeps the python float,
    which does not widen its dtype."""
    s = float(scalar)
    if not x.is_floating_point() and x.dtype != torch.bool:
        return int(s)
    return s


for _name, _f in _SCALAR.items():
    register(_name)(
        (lambda f: lambda x, scalar=0.0, **kw: f(
            x, _scalar_operand(x, scalar)))(_f))


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0, **kw):
    s2 = float(scalar) ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


# ---------------------------------------------------------------------------
# storage-aware aliases and gradient-routing identities: distinct names in
# the reference's graphs, the same arithmetic here
# ---------------------------------------------------------------------------


@register("_grad_add")
def _grad_add(lhs, rhs, **kw):
    """Gradient accumulation add (`elemwise_binary_op_basic.cc` _grad_add)."""
    return lhs + rhs


@register("_copyto")
def _copyto(x, **kw):
    """Cross-context copy node; placement is the frontend's concern."""
    return x


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs, **kw):
    """Identity on lhs, attrs taken from rhs (`elemwise_unary_op_basic.cc:352`)."""
    return lhs


@register("_zeros_without_dtype")
def _zeros_without_dtype(shape=None, ctx=None, dtype=-1, device=None, **kw):
    """Zeros whose dtype defaults at graph-build time (-1 → float32)."""
    dt = "float32" if dtype in (-1, "-1", None, "None") else dtype
    return torch.zeros(as_tuple(shape) or (), dtype=torch_dtype(dt),
                       device=device)


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs, **kw):
    """Division of the stored entries of a sparse lhs; dense here, where
    0/x keeps the zeros."""
    return lhs / rhs


@register("_contrib_quadratic", aliases=["contrib_quadratic"])
def _contrib_quadratic(data, a=0.0, b=0.0, c=0.0, **kw):
    """f(x) = a*x^2 + b*x + c (`contrib/quadratic_op.cc:31`)."""
    return float(a) * torch.square(data) + float(b) * data + float(c)


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.view_as(data)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.scalar, None


@register("_contrib_gradientmultiplier",
          aliases=["contrib_gradientmultiplier"])
def _contrib_gradientmultiplier(data, scalar=1.0, **kw):
    """Identity forward, gradient scaled by `scalar` on the way back
    (`contrib/gradient_multiplier_op.cc`)."""
    return _GradientMultiplier.apply(data, float(scalar))
