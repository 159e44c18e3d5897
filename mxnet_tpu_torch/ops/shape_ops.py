"""Shape-manipulation ops: the port of `mxnet_tpu/ops/shape_ops.py`
(`matrix_op.cc`: Reshape with its special codes, transpose, slice, tile,
...; `concat.cc`, `split.cc`, `pad.cc`)."""
from __future__ import annotations

import ast

import torch
import torch.nn.functional as F

from ._utils import as_tuple, is_none, parse_bool
from .registry import register


def infer_reshape(src_shape, target, reverse=False):
    """MXNet Reshape special codes (reference `matrix_op-inl.h`
    ReshapeInferShape): 0 copies a dim; -1 infers one; -2 copies all the
    remaining; -3 merges two dims; -4 splits one into the next two entries
    (either may be -1). ``reverse`` matches the codes from the right."""
    target = list(target)
    src = list(src_shape)
    if reverse:
        return tuple(infer_reshape(src[::-1], target[::-1])[::-1])
    out = []
    src_i = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_i])
            src_i += 1
        elif t == -1:
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif t == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            if d1 == -1:
                d1 = src[src_i] // d2
            if d2 == -1:
                d2 = src[src_i] // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(t)
            src_i += 1
        i += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=["reshape"])
def _reshape(x, shape=None, reverse=False, target_shape=None,
             keep_highest=False, **kw):
    if shape is None and target_shape is not None:  # legacy params
        shape = target_shape
    return torch.reshape(x, infer_reshape(x.shape, as_tuple(shape),
                                          parse_bool(reverse)))


@register("Flatten", aliases=["flatten"])
def _flatten(x, **kw):
    return torch.reshape(x, (x.shape[0], -1))


@register("transpose")
def _transpose(x, axes=None, **kw):
    axes = as_tuple(axes)
    if not axes:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(axes)


@register("expand_dims")
def _expand_dims(x, axis=0, **kw):
    axis = int(axis)
    return torch.unsqueeze(x, axis if axis >= 0 else axis + x.dim() + 1)


@register("squeeze")
def _squeeze(x, axis=None, **kw):
    axis = as_tuple(axis)
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=axis)


@register("Concat", aliases=["concat"])
def _concat(*xs, dim=1, num_args=None, **kw):
    return torch.cat(xs, dim=int(dim))


@register("stack")
def _stack(*xs, axis=0, num_args=None, **kw):
    return torch.stack(xs, dim=int(axis))


def _parts(parts, axis, squeeze):
    if squeeze:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("SliceChannel", aliases=["split"],
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    axis = int(axis) % x.dim()
    return _parts(torch.chunk(x, int(num_outputs), dim=axis), axis,
                  parse_bool(squeeze_axis))


def _split_v2_nout(attrs):
    sections = int(attrs.get("sections", 0) or 0)
    if sections > 0:
        return sections
    return len(as_tuple(attrs.get("indices")) or ()) + 1


def _split_v2(x, indices=(), axis=0, squeeze_axis=False, sections=0, **kw):
    """numpy-style split: by equal `sections` or at explicit `indices`
    (`matrix_op.cc:1147`)."""
    axis = int(axis) % x.dim()
    sections = int(sections or 0)
    if sections > 0:
        parts = torch.tensor_split(x, sections, dim=axis)
    else:
        parts = torch.tensor_split(
            x, [int(i) for i in (as_tuple(indices) or ())], dim=axis)
    return _parts(parts, axis, parse_bool(squeeze_axis))


register("split_v2", num_outputs=_split_v2_nout)(_split_v2)
register("_split_v2", num_outputs=_split_v2_nout)(_split_v2)


def _opt_int_tuple(v):
    """Like as_tuple, but entries may be None (open slice bounds); takes the
    string form the Symbol/JSON path writes ("(1, None)")."""
    if is_none(v):
        return ()
    if isinstance(v, str):
        v = ast.literal_eval(v.replace("L", ""))
    if not isinstance(v, (tuple, list)):
        v = (v,)
    return tuple(None if is_none(e) else int(e) for e in v)


def _slice_tuple(x, begin, end, step):
    """Python slices from MXNet begin/end/step attrs (reference
    `matrix_op-inl.h` GetIndexRange)."""
    begin, end = _opt_int_tuple(begin), list(_opt_int_tuple(end))
    step = tuple(1 if s is None else s for s in _opt_int_tuple(step)) \
        or (1,) * len(begin)
    slices = []
    for i in range(x.dim()):
        if i < len(begin):
            e = end[i] if i < len(end) else None
            s = step[i] if i < len(step) else 1
            slices.append(slice(begin[i], e, int(s) if s else 1))
        else:
            slices.append(slice(None))
    return tuple(slices)


def negative_step_grid(shape, key):
    """For a key of ints and slices with a negative step, which torch's
    indexing refuses: (an open grid of index tensors that selects the same
    elements, the selection's shape without the int axes); else None."""
    keys = key if isinstance(key, tuple) else (key,)
    if len(keys) > len(shape) or not all(
            isinstance(k, slice) or (isinstance(k, int)
                                     and not isinstance(k, bool))
            for k in keys) or not any(
            isinstance(k, slice) and (k.step or 1) < 0 for k in keys):
        return None
    idx, kept = [], []
    for d, n in enumerate(shape):
        k = keys[d] if d < len(keys) else slice(None)
        pos = range(n)[k]
        if isinstance(k, slice):
            kept.append(len(pos))
        idx.append(torch.tensor(pos if isinstance(k, slice) else [pos]))
    return torch.meshgrid(*idx, indexing="ij"), tuple(kept)


def read_key(x, key):
    """x[key], negative slice steps included."""
    grid = negative_step_grid(x.shape, key)
    if grid is None:
        return x[key]
    index, kept = grid
    return x[tuple(i.to(x.device) for i in index)].reshape(kept)


def write_key(x, key, value):
    """A copy of x with x[key] = value (a tensor or a number), negative
    slice steps included: differentiable in both under grad."""
    out = x.clone()
    if isinstance(value, torch.Tensor):
        value = value.to(out.device, out.dtype)
    grid = negative_step_grid(x.shape, key)
    if grid is not None:
        index, kept = grid
        key = tuple(i.to(x.device) for i in index)
        value = torch.as_tensor(value, dtype=out.dtype,
                                device=out.device).expand(kept).reshape(
            index[0].shape)
    out[key] = value
    return out


@register("slice", aliases=["crop"])
def _slice(x, begin=None, end=None, step=None, **kw):
    return read_key(x, _slice_tuple(x, begin, end, step))


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None, **kw):
    axis = int(axis) % x.dim()
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(int(begin), None if is_none(end) else int(end))
    return x[tuple(sl)]


@register("slice_like")
def _slice_like(x, like, axes=(), **kw):
    axes = as_tuple(axes) or tuple(range(min(x.dim(), like.dim())))
    sl = [slice(None)] * x.dim()
    for a in axes:
        sl[a % x.dim()] = slice(0, like.shape[a % like.dim()])
    return x[tuple(sl)]


@register("reverse", aliases=["flip"])
def _reverse(x, axis=(), **kw):
    return torch.flip(x, dims=as_tuple(axis))


@register("tile")
def _tile(x, reps=(), **kw):
    return torch.tile(x, as_tuple(reps))


@register("repeat")
def _repeat(x, repeats=1, axis=None, **kw):
    if is_none(axis):
        return torch.repeat_interleave(x.reshape(-1), int(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=int(axis))


@register("Pad", aliases=["pad"])
def _pad(x, mode="constant", pad_width=(), constant_value=0.0, **kw):
    pw = as_tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    flat = [p for pair in reversed(pairs) for p in pair]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=float(constant_value))
    # edge/reflect pad the spatial axes; the first two pairs are (0, 0)
    spatial = [p for pair in reversed(pairs[2:]) for p in pair]
    return F.pad(x, spatial, mode={"edge": "replicate",
                                   "reflect": "reflect"}[mode])


@register("depth_to_space")
def _depth_to_space(x, block_size=1, **kw):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(x, block_size=1, **kw):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("SwapAxis", aliases=["swapaxes"])
def _swapaxes(x, dim1=0, dim2=0, **kw):
    return torch.transpose(x, int(dim1), int(dim2))


@register("diag")
def _diag(x, k=0, axis1=0, axis2=1, **kw):
    if x.dim() == 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, offset=int(k), dim1=int(axis1), dim2=int(axis2))


@register("_arange_like", aliases=["contrib_arange_like"])
def _arange_like(x, start=0.0, step=1.0, repeat=1, axis=None, **kw):
    n = x.numel() if is_none(axis) else x.shape[int(axis)]
    out = torch.arange(n, dtype=x.dtype, device=x.device) * float(step) \
        + float(start)
    return out.reshape(x.shape) if is_none(axis) else out


@register("_slice_assign", aliases=["_crop_assign"])
def _slice_assign(lhs, rhs, begin=None, end=None, step=None, **kw):
    """lhs with lhs[begin:end:step] replaced by rhs (`matrix_op.cc:477`):
    gradients flow to lhs outside the window and to rhs inside it."""
    return write_key(lhs, _slice_tuple(lhs, begin, end, step), rhs)


@register("_slice_assign_scalar", aliases=["_crop_assign_scalar"])
def _slice_assign_scalar(lhs, begin=None, end=None, step=None, scalar=0.0,
                         **kw):
    """lhs with the slice window filled by a scalar (`matrix_op.cc:527`)."""
    return write_key(lhs, _slice_tuple(lhs, begin, end, step), float(scalar))


@register("reshape_like")
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None, **kw):
    """Reshape lhs to rhs's shape; the optional [lhs_begin, lhs_end) dims of
    lhs are replaced by the [rhs_begin, rhs_end) dims of rhs
    (`elemwise_unary_op_basic.cc:392`)."""

    def canon(v, ndim, default):
        if is_none(v):
            return default
        v = int(v)
        return v + ndim if v < 0 else v

    lb = canon(lhs_begin, lhs.dim(), 0)
    le = canon(lhs_end, lhs.dim(), lhs.dim())
    rb = canon(rhs_begin, rhs.dim(), 0)
    re = canon(rhs_end, rhs.dim(), rhs.dim())
    return torch.reshape(lhs, lhs.shape[:lb] + rhs.shape[rb:re]
                         + lhs.shape[le:])
