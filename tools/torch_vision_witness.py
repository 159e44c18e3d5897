"""How far the small mobilenets' fp32 training step lies from its float64
step, on the CPU and on a CUDA card under several convolution routes.

For each of `chip_smoke.VISION_SMALL`'s witnessed nets: one SGD step in
float64 on the CPU (the witness), in fp32 on the CPU, and in fp32 on the
card with cuDNN's deterministic algorithms (check (c)'s route), with
cuDNN's default choice, and with cuDNN off; then the float64 step on the
card; then the fp32 step on the card with BatchNorm's training forward
computed in float64, and through cuDNN's kernel; then, with ``--split``, the fp32 step on the CPU with the ops of
one kind (an op name; a grouped Convolution apart) run on the card, its
inputs copied there and its outputs back, kind by kind. For each run,
every array's error over its scale (`chip_smoke.vision_witness_errors`):
the worst, the five worst arrays, the output's and the count past 1e-3;
and for the CPU's and the card's fp32 steps, the elements that lie on
the other side of a ReLU or ReLU6 kink than in the witness. Beside them,
the witness's own spread: the float64 step with its input moved by about
one fp32 rounding (relative 1e-7). Prints one JSON line; ``--out``
keeps it.

    python tools/torch_vision_witness.py --split --out witness.json
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def cudnn(enabled, deterministic):
    import torch

    saved = (torch.backends.cudnn.enabled,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.enabled = enabled
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def op_kind(name, attrs):
    if name == "Convolution" and int(attrs.get("num_group", 1)) > 1:
        return "Convolution (grouped)"
    return name


@contextlib.contextmanager
def split(kinds, seen=None):
    """Ops of ``kinds`` run on the card inside a CPU run (their inputs
    copied there, their outputs back: both copies differentiable, so
    their backward runs there too); every kind invoked is added to
    ``seen``."""
    import torch

    from mxnet_tpu_torch.ops import registry

    invoke = registry.invoke

    def move(x, device):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    def split_invoke(name, *tensors, **attrs):
        kind = op_kind(name, attrs)
        if seen is not None:
            seen.add(kind)
        if kind not in kinds:
            return invoke(name, *tensors, **attrs)
        out = invoke(name, *(move(t, "cuda") for t in tensors), **attrs)
        if isinstance(out, (tuple, list)):
            return type(out)(move(o, "cpu") for o in out)
        return move(out, "cpu")

    registry.invoke = split_invoke
    try:
        yield
    finally:
        registry.invoke = invoke


@contextlib.contextmanager
def batch_norm_route(route):
    """BatchNorm's training forward on the card computed another way:
    ``"float64"`` (the native kernels on float64 copies) or ``"cudnn"``
    (`torch.cudnn_batch_norm`); the moving statistics as the port's op
    moves them."""
    import torch

    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.ops.nn import parse_bool

    op = registry.get_op("BatchNorm")
    native = op.fn

    def fn(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
           momentum=0.9, fix_gamma=True, use_global_stats=False,
           _train=False, **kw):
        if not (data.is_cuda and parse_bool(_train)) or \
                parse_bool(use_global_stats) or int(kw.get("axis", 1)) != 1:
            return native(data, gamma, beta, moving_mean, moving_var,
                          eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats, _train=_train,
                          **kw)
        eps, momentum = float(eps), float(momentum)
        if parse_bool(fix_gamma):
            gamma = gamma * 0 + 1
        if route == "float64":
            out, mean, invstd = torch.ops.aten.native_batch_norm(
                data.double(), gamma.double(), beta.double(), None, None,
                True, 0.0, eps)
            out = out.to(data.dtype)
        else:
            out, mean, invstd, _ = torch.cudnn_batch_norm(
                data, gamma, beta, moving_mean.detach().clone(),
                moving_var.detach().clone(), True, 0.0, eps)
        with torch.no_grad():
            new_mean = torch.lerp(mean.to(moving_mean.dtype), moving_mean,
                                  momentum)
            new_var = torch.lerp(invstd.to(moving_var.dtype) ** -2 - eps,
                                 moving_var, momentum)
        return out, new_mean, new_var

    op.fn = fn
    try:
        yield
    finally:
        op.fn = native


@contextlib.contextmanager
def record_kinks(into):
    """Record, for each ReLU (``Activation``) and ReLU6 (``clip``) call,
    which side of each kink (0, and 6 for ``clip``) every input element
    lies on."""
    from mxnet_tpu_torch.ops import registry

    invoke = registry.invoke

    def recording_invoke(name, *tensors, **attrs):
        if name in ("Activation", "clip"):
            x = tensors[0].detach().cpu()
            sides = [x > 0] + ([x < float(attrs.get("a_max", 6))]
                               if name == "clip" else [])
            into.append(sides)
        return invoke(name, *tensors, **attrs)

    registry.invoke = recording_invoke
    try:
        yield
    finally:
        registry.invoke = invoke


def kink_flips(run, witness):
    """Elements on the other side of a kink than in the witness run: the
    total and the count of calls with any."""
    assert len(run) == len(witness)
    flips = [sum(int((a != b).sum()) for a, b in zip(r, w))
             for r, w in zip(run, witness)]
    return {"elements": sum(flips), "calls": sum(f > 0 for f in flips),
            "of_calls": len(flips),
            "last_call_with_flips": max((i for i, f in enumerate(flips)
                                         if f), default=None)}


def perturbed_input(delta, seed=5):
    """`np.random.RandomState` whose ``uniform`` moves each draw by a
    relative ``delta`` times a normal draw (before `vision_small_step`
    rounds it to fp32)."""
    import numpy as np

    base = np.random.RandomState

    class Perturbed(base):
        def uniform(self, low, high, size):
            x = base.uniform(self, low, high, size)
            return x * (1 + delta * np.random.default_rng(seed)
                        .standard_normal(size))

    return Perturbed


def summary(state, witness):
    errs = cs.vision_witness_errors(state, witness,
                                    cs.VISION_WITNESS_TOL["floor"])
    worst = sorted(errs, key=errs.get, reverse=True)
    return {"worst_of_scale": errs[worst[0]],
            "worst_arrays": {k: errs[k] for k in worst[:5]},
            "output": errs["output"], "loss": errs["loss"],
            "arrays_over_1e-3": sum(e > 1e-3 for e in errs.values()),
            "arrays": len(errs)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--split", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.is_available()
    result = {"card": cs.card_line() if card else None}
    with tempfile.TemporaryDirectory() as folder:
        for name, (_, _, mode) in cs.VISION_SMALL.items():
            if mode != "witness":
                continue
            path = os.path.join(folder, f"{name}.params")
            cs.vision_small_step(mx, mx.cpu(), name, path)  # the weights
            kinds, k64, k32 = set(), [], []
            with split((), kinds), record_kinks(k32):
                cpu32 = cs.vision_small_step(mx, mx.cpu(), name, path)
            with record_kinks(k64):
                w64 = cs.vision_small_step(mx, mx.cpu(), name, path,
                                           "float64")
            runs = {"cpu_fp32": dict(summary(cpu32, w64),
                                     kink_flips=kink_flips(k32, k64))}
            # the witness's own spread: the float64 step with its fp32
            # input moved by about one rounding
            saved = np.random.RandomState
            np.random.RandomState = perturbed_input(1e-7)
            try:
                kp = []
                with record_kinks(kp):
                    moved = cs.vision_small_step(mx, mx.cpu(), name, path,
                                                 "float64")
            finally:
                np.random.RandomState = saved
            runs["cpu_float64_input_moved_1e-7"] = dict(
                summary(moved, w64), kink_flips=kink_flips(kp, k64))
            if card:
                for label, enabled, det in (
                        ("card_fp32_cudnn_deterministic", True, True),
                        ("card_fp32_cudnn_default", True, False),
                        ("card_fp32_cudnn_off", False, False)):
                    kc = []
                    with cudnn(enabled, det), record_kinks(kc):
                        runs[label] = dict(summary(cs.vision_small_step(
                            mx, mx.gpu(0), name, path), w64),
                            kink_flips=kink_flips(kc, k64))
                with cudnn(True, True):
                    runs["card_float64"] = summary(cs.vision_small_step(
                        mx, mx.gpu(0), name, path, "float64"), w64)
                for route in ("float64", "cudnn"):
                    with cudnn(True, True), batch_norm_route(route):
                        runs[f"card_fp32, BatchNorm {route}"] = summary(
                            cs.vision_small_step(mx, mx.gpu(0), name, path),
                            w64)
                if args.split:
                    for kind in sorted(kinds):
                        with cudnn(True, True), split({kind}):
                            runs[f"cpu_fp32, {kind} on the card"] = summary(
                                cs.vision_small_step(mx, mx.cpu(), name,
                                                     path), w64)
            result[name] = runs
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
