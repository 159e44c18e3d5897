#!/usr/bin/env python3
"""Build the port's CUDA kernels, drive its main path on one card, and check
both.

    python3 chip_smoke.py [--profile OUT.json]

Phases, each printed as one JSON line:
  card     the card's name and power limit (nvidia-smi), torch and CUDA
           versions, compute capability;
  build    nvcc of every `mxnet_tpu_torch/ops/csrc/*.cu`, one process each;
  train    the main path: 3 Adam steps of `TransformerLM` at the default
           `TransformerLMConfig` width (bf16, 4 layers, d_model 512, 8 heads,
           vocab 32768) on one batch of 8 x 2048 tokens, with every kernel's
           launch count set to 0 just before and read just after; then the
           same path on a small fp32 input on the card and on the CPU;
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it and at extra cases, with times
           (CUDA events, warmed up, median), the plain version's, one
           PyTorch library call's as a yardstick, and the least time the
           card could take (`bound_ms`, H100 SXM peaks);
and last {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero and prints no last line; so does a machine without a
CUDA card. `--profile` also writes a torch.profiler breakdown of one more
train step, by kernel, to OUT.json.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# input type (bf16 on the tensor cores, fp32 on the FMA pipes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_LEN = 8, 2048


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of fn() on the card, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(b, lq, lk, h, d, dtype, causal):
    """(ms, "bytes" | "operations"): the least time for one attention call,
    counting q, k, v read once and o written once, and the 2*2*d FLOP of
    QK^T and PV for each (query, key) pair the mask keeps."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * h * d * b * (2 * lq + 2 * lk)
    pairs = b * h * (lq * (lq + 1) // 2 if causal else lq * lk)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 4 * d * pairs / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def train_phase(torch, fa):
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig

    cfg = TransformerLMConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = TransformerLM(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in lm.parameters())
    step, init_opt = lm.make_train_step(lr=1e-3)
    state = init_opt()
    shape = (TRAIN_BATCH, TRAIN_LEN)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    targets = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.flash_attention_fwd_kernel.launches = 0
    losses, seconds = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(state, tokens, targets, i)
        losses.append(float(loss))  # waits for the step
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {"flash_attention_fwd": fa.flash_attention_fwd_kernel.launches}

    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # one batch repeated: three Adam steps must bring its loss down
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in lm.parameters()),
          "non-finite parameter after training")
    want = TRAIN_STEPS * cfg.n_layers
    check(launches["flash_attention_fwd"] == want,
          f"flash_attention_fwd launched {launches} times, want {want}")
    tail = statistics.median(seconds[1:])
    result = {
        "config": "TransformerLMConfig() defaults", "params": n_params,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "steps": TRAIN_STEPS,
        "losses": losses, "step_s": seconds,
        "tokens_per_s": TRAIN_BATCH * TRAIN_LEN / tail,
        "tokens_per_s_from": "median of steps 2..3",
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernel_launches": launches,
    }
    return result, (lm, step, state, tokens, targets)


def small_reference_phase(torch):
    """The main path on a small fp32 input, on the card (through the kernel)
    and on the CPU (through the plain version), from the same weights."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig

    cfg = TransformerLMConfig(vocab_size=512, d_model=128, n_heads=2,
                              d_ff=256, n_layers=2, max_len=256,
                              dtype="float32")
    gen = torch.Generator().manual_seed(1)
    cpu = TransformerLM(cfg, device="cpu", generator=gen)
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen)
    with torch.no_grad():
        want = cpu(tokens)
        got = gpu(tokens.cuda()).cpu()
        loss_cpu = float(cpu.loss(tokens, targets))
        loss_gpu = float(gpu.loss(tokens.cuda(), targets.cuda()))
    check(got.shape == (2, 200, cfg.vocab_size), f"logits shape {got.shape}")
    err = float((got - want).abs().max())
    tol = 1e-4  # fp32 on both, sums in another order: a few ulp per layer
    check(err <= tol, f"small fp32 logits card vs CPU: max err {err} > {tol}")
    check(abs(loss_gpu - loss_cpu) <= tol,
          f"small fp32 loss card {loss_gpu} vs CPU {loss_cpu}")
    return {"shape": [2, 200], "config": "vocab 512, d_model 128, 2 heads, "
            "2 layers, fp32", "logits_max_abs_err": err, "tol": tol,
            "loss_card": loss_gpu, "loss_cpu": loss_cpu}


def attention_case(torch, fa, F, *, b, l, h, d, dtype, causal, tol, timed):
    """Kernel vs plain version on inputs shaped as the transformer makes
    them: q, k, v strided views of one [B, L, 3*H*D] projection."""
    gen = torch.Generator(device="cuda").manual_seed(l * d + causal)
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen,
                      dtype=torch.float32).to(getattr(torch, dtype))
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    scale = 1.0 / math.sqrt(d)
    out = fa.flash_attention_fwd_kernel(q, k, v, causal, scale)
    ref = fa.reference_attention(q, k, v, causal, scale)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # allclose with atol = rtol = tol, the JAX package's kernel-test bound
    ok = bool((diff <= tol + tol * ref.float().abs()).all())
    name = f"{dtype} B={b} L={l} H={h} D={d} {'causal' if causal else 'full'}"
    check(out.shape == q.shape and out.dtype == q.dtype, f"{name}: output")
    check(ok, f"{name}: kernel vs plain max abs err {err} beyond {tol}")
    case = {"case": name, "max_abs_err": err, "tol": tol}
    if timed:
        bound_ms, bound_by = attention_bound(b, l, l, h, d, dtype, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        case.update(
            ms=cuda_ms(lambda: fa.flash_attention_fwd_kernel(
                q, k, v, causal, scale)),
            plain_ms=cuda_ms(lambda: fa.reference_attention(
                q, k, v, causal, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)),
            library="torch.nn.functional.scaled_dot_product_attention",
            bound_ms=bound_ms, bound_by=bound_by)
    return case


def kernels_phase(torch, fa, launches):
    import torch.nn.functional as F

    main = attention_case(torch, fa, F, b=TRAIN_BATCH, l=TRAIN_LEN, h=8, d=64,
                          dtype="bfloat16", causal=True, tol=2e-2, timed=True)
    extra = [
        attention_case(torch, fa, F, b=2, l=1000, h=4, d=64, dtype="float32",
                       causal=False, tol=1e-5, timed=True),
        attention_case(torch, fa, F, b=2, l=77, h=3, d=32, dtype="float32",
                       causal=True, tol=1e-5, timed=False),
        attention_case(torch, fa, F, b=1, l=300, h=2, d=128, dtype="bfloat16",
                       causal=True, tol=2e-2, timed=False),
        attention_case(torch, fa, F, b=1, l=130, h=2, d=128, dtype="float32",
                       causal=False, tol=1e-5, timed=False),
    ]
    entry = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:66",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": main["max_abs_err"], "tol": main["tol"],
        "ms": main["ms"], "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
        "library": main["library"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "case": main["case"],
        "extra_cases": extra,
    }
    return [entry]


KERNEL_GROUPS = (  # substring of a device kernel's name -> its group
    ("flash_attention_fwd_kernel", "K1 flash_attention_fwd"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("softmax", "softmax"), ("SoftMax", "softmax"),
    ("reduce", "reductions"), ("Reduce", "reductions"),
    ("Memcpy", "copies"), ("copy", "copies"),
)
RANGES = ("_FlashAttentionBackward", "_FlashAttention")


def profile_step(torch, path, lm_state):
    """One more train step under torch.profiler (after one warm-up step under
    it): device time by kernel and by group, the inclusive device time of
    the attention forward and backward, and the device's idle share of the
    step's wall time (which the profiler itself lengthens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    _, step, state, tokens, targets = lm_state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, tokens, targets, TRAIN_STEPS + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    kernels = {}
    for ev in prof.events():
        # device work only: skip the step's own range on the device track
        if (ev.device_type == DeviceType.CUDA
                and not ev.name.startswith("ProfilerStep")
                and not getattr(ev, "is_user_annotation", False)):
            row = kernels.setdefault(ev.name, {"name": ev.name,
                                               "device_ms": 0.0, "count": 0})
            row["device_ms"] += ev.time_range.elapsed_us() / 1e3
            row["count"] += 1
    rows = sorted(kernels.values(), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups = {}
    for r in rows:
        group = next((g for key, g in KERNEL_GROUPS if key in r["name"]),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + r["device_ms"]
    ranges = {}
    for ev in prof.key_averages():
        for name in RANGES:
            if ev.key.endswith(name):
                ranges[name] = ev.device_time_total / 1e3
    result = {"step_wall_ms": wall_ms, "device_busy_ms": busy,
              "idle_share": max(0.0, 1 - busy / wall_ms),
              "groups_ms": groups, "ranges_device_ms": ranges}
    check(groups.get("K1 flash_attention_fwd", 0) > 0,
          "the profiled step ran no flash_attention_fwd kernel")
    with open(path, "w") as f:
        json.dump(dict(result, kernels=rows), f, indent=1)
    return dict(result, path=path, top=[
        {"name": r["name"][:80], "device_ms": r["device_ms"],
         "count": r["count"]} for r in rows[:8]])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT.json",
                        help="also profile one train step into OUT.json")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    # fp32 comparisons on the card are full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = card_line()
    emit(card={"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "capability": list(torch.cuda.get_device_capability(0)),
               "device_count": torch.cuda.device_count()})

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    built = _build.build(names)
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for n in names for line in _build.build_log(n)
             .splitlines() if "registers" in line or "spill" in line]
    emit(build={"seconds": build_s, "sources": names, "built": built,
                "ptxas": ptxas})

    train, lm_state = train_phase(torch, fa)
    small = small_reference_phase(torch)
    kernels = kernels_phase(torch, fa, train["kernel_launches"])
    emit(kernels=kernels)
    emit(train=train, small_reference=small)
    if args.profile:
        emit(profile=profile_step(torch, args.profile, lm_state))
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
