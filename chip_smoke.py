#!/usr/bin/env python3
"""Build the port's CUDA kernels, drive its main path on one card, and check
both.

    python3 chip_smoke.py [--profile OUT.json] [--deadline SECONDS]

Phases, each printed as one JSON line:
  card     the card's name and power limit (nvidia-smi), torch and CUDA
           versions, compute capability;
  build    nvcc of every `mxnet_tpu_torch/ops/csrc/*.cu`, one process each,
           ptxas's register report, and the count of tensor-core (HGMMA)
           instructions in each library's SASS where `cuobjdump` exists;
  train    slice 1's path: 3 Adam steps of `TransformerLM` at the default
           `TransformerLMConfig` width (bf16, 4 layers, d_model 512, 8 heads,
           vocab 32768) on one batch of 8 x 2048 tokens; then the same path
           on a small fp32 input on the card and on the CPU;
  ring     slice 3's path: the same model, weights and batch trained 3 steps
           with a 4-way `sp` mesh whose positions all sit on cuda:0, so
           attention is ring attention: per layer and step 4 x 4 K2 hops
           and their streaming combine, the backward through the ring; then
           the small fp32 input with sp = 4 on the card and on the CPU;
  trainer  slice 2's path: the same model and batch trained 3 steps by
           `gluon.Trainer` (multi-precision Adam) through a `dist_sync`
           kvstore with 2-bit gradient compression, in a one-rank NCCL
           process group opened on a free localhost port: per parameter a
           K3 quantize, an all-gather of the packed words, a dequantize and
           a pull; the group is destroyed at the end of the phase;
  generate slice 5's path, run before the trainer: `GenerationEngine` over
           the default model (weights from seed 0) with a 32 x 2048 KV slab
           (512 MiB) and the prefill ladder 8, 16, ..., 2048, served by its
           worker thread. Warm-up captures 10 CUDA graphs (9 prefill, 1
           decode), a second warm-up none; a burst of 64 sessions (prompts
           of 16-1024 tokens, 128 new tokens each), half of them queued;
           one 512-token stream for flatness (the median gap of its last
           third over its first third). Checks, each raising: (a) steady
           state builds and captures nothing; (b) 8 burst sessions rerun
           alone give the same tokens; (c) one replayed decode tick against
           an eager `decode_step` on a copy of the slab (equal greedy
           tokens, logits within 2e-2); (d) the small fp32 model served on
           the card and on the CPU (equal streams over 8 sessions, prefill
           and decode logits within 1e-4); (e) no kernel launched. Prints
           tokens/s, TTFT p50 and p99, the median tick, the decode graph's
           time against its bound (the slab and the weights read once a
           tick), each prefill bucket's graph time, peak memory, and the
           card's name and power limit;
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it and at extra cases (every head dim
           and dtype variant of K1 and K2), with times (`cuda_ms`: many calls
           back to back between one pair of CUDA events, queued behind a
           sleep on the card so that it never waits on the host; `call_ms`:
           one call between two events, host time of the wrapper included),
           the plain version's, one PyTorch library call's as a yardstick
           where one exists, the least time the card could take (`bound_ms`,
           H100 SXM peaks), its share of `ms`, and the achieved TFLOP/s;
and last {"ok": true, "device": {...}}. Every kernel's launch count is set
to 0 just before each path and read just after; each path must launch its
own kernels and no other. Any failed check raises, so the script exits
non-zero and prints no last line; so does a machine without a CUDA card.
`--profile` also writes a torch.profiler breakdown of one more step of each
training path and of 20 decode ticks over a full slab, by kernel, to
OUT.json; each profile must hold every launch of the port's kernels that
its step made. A run not over after `--deadline` seconds (default 1100)
dumps every thread's stack and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
import os
import socket
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
COMPRESSION = {"type": "2bit", "threshold": 0.5}  # MXNet's default threshold
RING_SP = 4
# the ring's first loss against the train path's: the same weights and
# tokens, attention rounded to bf16 at other places (K2 hops and the combine
# against K1), over 4 layers
RING_FIRST_LOSS_TOL = 2e-2


def emit(**obj):
    print(json.dumps(obj), flush=True)


def progress(phase):
    """A phase's end on stderr: where a run that is cut stopped."""
    print(f"chip_smoke: {phase} done", file=sys.stderr, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def kernel_wrappers():
    """{kernel name: its wrapper}, each wrapper counting its launches."""
    from mxnet_tpu_torch import gradient_compression as gcm
    from mxnet_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
            "flash_block_partials": fa.flash_block_partials_kernel,
            "quantize_2bit": gcm.quantize_2bit_kernel}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, reps=20, warmup=3):
    """Median time of one fn() call between two CUDA events: the kernel and
    whatever host time of the wrapper the card waits for."""
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


SM_HZ = 1.98e9  # H100 SXM boost clock, to size the sleep in cycles


def cuda_ms(fn, reps=5, warmup=3, batch_ms=20.0):
    """Device time of one fn() call: n calls back to back between one pair
    of CUDA events, queued behind `torch.cuda._sleep` long enough to cover
    the host's enqueueing of all n, so the card never waits on the host;
    the median over `reps` batches of the elapsed time over n."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n = max(1, min(200, int(batch_ms / max(call_ms(fn, reps=3), 1e-3))))
    t0 = time.perf_counter()
    fn()  # the host's time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(min(1e9, max(1e6, 2 * n * host_s * SM_HZ)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def rates(ms, bound_ms, flop):
    """The share of the bound that `ms` reaches and the achieved TFLOP/s."""
    return {"bound_share": bound_ms / ms, "tflops": flop / (ms * 1e-3) / 1e12}


def attention_bound(b, lq, lk, h, d, dtype, causal, bias=False,
                    stats=False):
    """(ms, "bytes" | "operations", FLOP): the least time for one attention
    call and the operations it counts,
    counting q, k, v read once and o written once, and the 2*2*d FLOP of
    QK^T and PV for each (query, key) pair the causal mask keeps (every
    pair when `causal` is false: a bias is data, and K2 computes every
    tile). `bias` adds the read of one (lq, lk) fp32 bias, `stats` the
    writes of the fp32 row max and sum-exp ([b, h, lq] each)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * h * d * b * (2 * lq + 2 * lk)
    nbytes += 4 * lq * lk * bias + 2 * 4 * b * h * lq * stats
    pairs = b * h * (lq * (lq + 1) // 2 if causal else lq * lk)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 4 * d * pairs / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", 4 * d * pairs)


def default_model_and_batch(torch, mesh=None):
    """The default `TransformerLM` on cuda from seed 0 and one batch of
    tokens and targets drawn after its weights: the same weights and tokens
    for every path."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig

    cfg = TransformerLMConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = TransformerLM(cfg, device="cuda", generator=gen, mesh=mesh)
    shape = (TRAIN_BATCH, TRAIN_LEN)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device="cuda")
    targets = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device="cuda")
    return cfg, lm, tokens, targets


def train_phase(torch, mesh=None):
    """3 Adam steps of the default model (`make_train_step`); with a mesh
    whose sp axis is above 1, attention is ring attention over it (slice
    3), else the local flash-attention forward (slice 1)."""
    from mxnet_tpu_torch.parallel import axis_size

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg, lm, tokens, targets = default_model_and_batch(torch, mesh)
    sp = axis_size(mesh, "sp")
    n_params = sum(p.numel() for p in lm.parameters())
    step, init_opt = lm.make_train_step(lr=1e-3)
    state = init_opt()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    losses, seconds = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(state, tokens, targets, i)
        losses.append(float(loss))  # waits for the step
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = read_launches()

    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # one batch repeated: three Adam steps must bring its loss down
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in lm.parameters()),
          "non-finite parameter after training")
    attention = TRAIN_STEPS * cfg.n_layers
    want = {"flash_attention_fwd": attention if sp == 1 else 0,
            # every position against every K/V block, in every layer
            "flash_block_partials": attention * sp * sp if sp > 1 else 0,
            "quantize_2bit": 0}
    check(launches == want, f"path launched {launches}, want {want}")
    tail = statistics.median(seconds[1:])
    result = {
        "config": "TransformerLMConfig() defaults", "params": n_params,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN, "steps": TRAIN_STEPS,
        "losses": losses, "step_s": seconds,
        "tokens_per_s": TRAIN_BATCH * TRAIN_LEN / tail,
        "tokens_per_s_from": "median of steps 2..3",
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "held_before_gb": held, "kernel_launches": launches,
    }
    if mesh is not None:
        result["mesh"] = {"shape": mesh.shape,
                          "positions": [str(d) for d in mesh.devices]}
    return result, (lm, step, state, tokens, targets)


def ring_phase(torch, train):
    """Slice 3's path: the train phase's model, weights and batch with a
    4-way sp mesh whose positions all sit on cuda:0. Its first loss must be
    the train phase's, up to bf16 rounding: the same function, with
    attention through K2 and the combine instead of K1."""
    from mxnet_tpu_torch.parallel import create_mesh

    mesh = create_mesh(devices=[torch.device("cuda", 0)] * RING_SP,
                       sp=RING_SP)
    ring, ring_state = train_phase(torch, mesh)
    diff = abs(ring["losses"][0] - train["losses"][0])
    check(diff <= RING_FIRST_LOSS_TOL,
          f"ring first loss {ring['losses'][0]} vs the train path's "
          f"{train['losses'][0]}: {diff} > {RING_FIRST_LOSS_TOL}")
    ring.update(first_loss_vs_train=diff,
                first_loss_tol=RING_FIRST_LOSS_TOL)
    return ring, ring_state


def small_reference_phase(torch, sp=1):
    """The main path on a small fp32 input, on the card (through the
    kernels) and on the CPU (through the plain versions), from the same
    weights; with `sp` > 1, ring attention over that many positions, on
    cuda:0 and on the CPU."""
    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.parallel import create_mesh

    cfg = TransformerLMConfig(vocab_size=512, d_model=128, n_heads=2,
                              d_ff=256, n_layers=2, max_len=256,
                              dtype="float32")

    def mesh(device):
        return create_mesh(devices=[device] * sp, sp=sp) if sp > 1 else None

    gen = torch.Generator().manual_seed(1)
    cpu = TransformerLM(cfg, device="cpu", generator=gen, mesh=mesh("cpu"))
    gpu = TransformerLM(cfg, device="cuda", mesh=mesh("cuda:0"))
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
            "2 layers, fp32", "sp": sp, "logits_max_abs_err": err, "tol": tol,
            "loss_card": loss_gpu, "loss_cpu": loss_cpu}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group_env():
    """The environment of a one-rank process group on a free localhost port,
    restored on exit."""
    env = {"MXNET_COORDINATOR": f"127.0.0.1:{free_port()}",
           "MXNET_NUM_PROCESSES": "1", "MXNET_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nonzero_code_share(packs, n_values):
    """Share of the n_values whose 2-bit code is not 0, over packed words."""
    import torch

    shifts = torch.arange(16, dtype=torch.int32, device=packs[0].device) * 2
    nonzero = sum(int((((p.unsqueeze(-1) >> shifts) & 3) != 0).sum())
                  for p in packs)
    return nonzero / n_values


def trainer_phase(torch, profile=False):
    """Slice 2's path: `gluon.Trainer` over a compressed `dist_sync` store in
    a one-rank NCCL group, at the default config. Returns the result and,
    when `profile`, the profile of one more step (else None)."""
    import torch.distributed as dist

    from mxnet_tpu_torch import gradient_compression as gcm
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.parallel import KVStoreDistTPUSync

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg, lm, tokens, targets = default_model_and_batch(torch)
    n_tokens = TRAIN_BATCH * TRAIN_LEN
    n_keys = len(list(lm.parameters()))  # the tied head is embed itself
    n_values = sum(p.numel() for p in lm.parameters())

    # observe the packed words the store hands to the all-gather, to count
    # the codes that fired; the launches still go through the kernel wrapper
    packs = []
    real_quantize = gcm.GradientCompression.quantize

    def observed(self, key, grad):
        packed = real_quantize(self, key, grad)
        packs.append(packed)
        return packed

    def one_step(trainer):
        from torch.profiler import record_function

        with record_function("forward_backward"):
            loss = lm.loss(tokens, targets) * n_tokens  # sum of token NLLs
            loss.backward()
        with record_function("trainer.step"):
            trainer.step(n_tokens)  # rescale_grad = 1/batch, after the push
        return loss

    with one_rank_group_env() as env:
        try:
            trainer = Trainer(dict(lm.named_parameters()), "adam",
                              {"learning_rate": 1e-3,
                               "multi_precision": True},
                              kvstore="dist_sync",
                              compression_params=COMPRESSION)
            gcm.GradientCompression.quantize = observed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            losses, seconds, shares = [], [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                loss = one_step(trainer)
                losses.append(float(loss.detach()) / n_tokens)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                shares.append(nonzero_code_share(packs, n_values))
                packs.clear()
            launches = read_launches()
            gcm.GradientCompression.quantize = real_quantize
            kv = trainer._kvstore
            check(isinstance(kv, KVStoreDistTPUSync) and kv.num_workers == 1
                  and dist.get_backend() == "nccl",
                  "the trainer's store is not a one-rank NCCL dist store")
            check(not trainer._update_on_kvstore,
                  "a dist store must update on the worker")
            peak = torch.cuda.max_memory_allocated() / 1e9
            check(all(math.isfinite(x) for x in losses),
                  f"non-finite trainer loss {losses}")
            check(losses[-1] < losses[0], f"trainer loss did not fall: "
                  f"{losses} (nonzero code shares {shares})")
            check(all(bool(torch.isfinite(p).all())
                      for p in lm.parameters()),
                  "non-finite parameter after trainer steps")
            want = {"quantize_2bit": n_keys * TRAIN_STEPS,
                    "flash_attention_fwd": cfg.n_layers * TRAIN_STEPS,
                    "flash_block_partials": 0}
            check(launches == want,
                  f"trainer path launched {launches}, want {want}")
            profiled = profile_step(
                torch, lambda: one_step(trainer),
                must_run=("K1 flash_attention_fwd", "K3 quantize_2bit")) \
                if profile else None
        finally:
            gcm.GradientCompression.quantize = real_quantize
            if dist.is_initialized():
                dist.destroy_process_group()
    tail = statistics.median(seconds[1:])
    return {
        "config": "TransformerLMConfig() defaults", "params": n_values,
        "keys": n_keys, "batch": TRAIN_BATCH, "seq_len": TRAIN_LEN,
        "steps": TRAIN_STEPS, "optimizer": "adam, lr 1e-3, multi_precision",
        "kvstore": "dist_sync, one rank, NCCL",
        "coordinator": env["MXNET_COORDINATOR"],
        "compression": COMPRESSION,
        "losses_are": "mean token NLL (the summed loss over B*L)",
        "losses": losses, "step_s": seconds,
        "tokens_per_s": n_tokens / tail,
        "tokens_per_s_from": "median of steps 2..3",
        "nonzero_code_share": shares,
        "peak_mem_gb": peak, "held_before_gb": held,
        "kernel_launches": launches,
    }, profiled


GEN_SLOTS, GEN_MAX_LEN = 32, 2048          # docs/faq/perf.md:495
GEN_BURST, GEN_NEW = 64, 128
GEN_PROMPT_LENS = (16, 1024)               # uniform, RandomState(0)
GEN_RERUN = 8
FLAT_PROMPT, FLAT_NEW = 4, 512
GEN_LOGIT_TOL = 2e-2  # bf16 logits of a graph replay vs an eager call
GEN_PROFILE_TICKS = 20


def percentile_ms(values, q):
    import numpy as np

    return float(np.percentile(values, q)) * 1e3


def decode_bound(lm, eng):
    """(ms, "bytes" | "operations", bytes): the least time of one decode
    tick, reading the slab and every weight once (of `pos_embed` only the
    slots' rows), and doing 2 FLOP a weight and slot plus QK^T and PV over
    every slab row, at the bf16 tensor-core rate."""
    cfg = lm.cfg
    weights = sum(p.nbytes for p in lm.parameters())
    weights -= lm.pos_embed.nbytes - GEN_SLOTS * lm.pos_embed[0].nbytes
    nbytes = eng.kv_slab_bytes() + weights
    params = sum(p.numel() for p in lm.parameters()) - lm.pos_embed.numel()
    flop = 2 * params * GEN_SLOTS + \
        4 * GEN_SLOTS * cfg.n_layers * cfg.d_model * GEN_MAX_LEN
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flop / PEAK_FLOPS[cfg.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes)


def graph_vs_eager(torch, lm, eng, rng):
    """Check (c): one graph-replayed decode tick against an eager
    `decode_step` on a copy of the same slab and inputs. The engine must be
    idle; every slot is written at a random row, as garbage a later
    session's prefill and decode overwrite before reading."""
    prog = eng._decode_fn()
    tokens = rng.randint(0, lm.cfg.vocab_size, GEN_SLOTS)
    positions = rng.randint(0, GEN_MAX_LEN, GEN_SLOTS)
    ck, cv = eng._ck.clone(), eng._cv.clone()
    got = prog(tokens, positions)
    graph_logits = prog.outputs[1].clone()
    eager, _, _ = lm.decode_step(ck, cv, torch.from_numpy(tokens).cuda(),
                                 torch.from_numpy(positions).cuda())
    del ck, cv
    diff = float((eager - graph_logits).abs().max())
    same = bool((eager.argmax(-1).cpu().numpy() == got).all())
    check(same, "graph-replayed decode's greedy tokens differ from eager "
          "decode_step's")
    check(diff <= GEN_LOGIT_TOL, f"graph-replayed decode logits differ from "
          f"eager decode_step's by {diff} > {GEN_LOGIT_TOL}")
    return {"tokens_equal": same, "max_abs_logit_diff": diff,
            "tol": GEN_LOGIT_TOL}


def profile_ticks(torch, eng, prompts):
    """A profile of GEN_PROFILE_TICKS ticks over a full slab, all run by
    this thread with the tick lock held from before the sessions are
    admitted until after the profiler stops: on an H100 with torch 2.11,
    stopping the profiler while the worker thread replayed a graph
    deadlocked, and the worker, which retakes the lock at once after each
    tick, kept this thread from taking it for a whole session."""
    with eng._tick_lock:
        streams = [eng.submit(p[:16], max_new_tokens=4 * GEN_PROFILE_TICKS)
                   for p in prompts[:GEN_SLOTS]]
        while eng.live_slots < GEN_SLOTS:   # each tick admits >= 1
            eng._tick()

        def window():
            for _ in range(GEN_PROFILE_TICKS):
                eng._tick()
            check(eng.live_slots == GEN_SLOTS,
                  "a profiled session ended inside the window")

        prof = profile_step(torch, window, must_run=("matmul",))
    for s in streams:
        s.result(timeout=300)
    return prof


def generate_phase(torch, card, profile=False):
    """Slice 5's path: `GenerationEngine` over the default model with a
    32 x 2048 slab, served by its worker thread. Returns the result and,
    when `profile`, a profile of 20 decode ticks (else None)."""
    import numpy as np

    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving import warmup
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    cfg = TransformerLMConfig()
    lm = TransformerLM(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    lens = rng.randint(GEN_PROMPT_LENS[0], GEN_PROMPT_LENS[1] + 1, GEN_BURST)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    eng = GenerationEngine(lm, max_slots=GEN_SLOTS, max_len=GEN_MAX_LEN)
    try:
        ticks = []  # wall seconds of every tick the engine runs
        real_tick = eng._tick

        def timed_tick():
            t0 = time.perf_counter()
            real_tick()
            ticks.append(time.perf_counter() - t0)

        eng._tick = timed_tick
        n_programs = len(eng.prefill_buckets) + 1
        warm = [warmup(eng), warmup(eng)]
        check(len(eng.prefill_buckets) == 9, f"prefill ladder "
              f"{eng.prefill_buckets}, want 8, 16, ..., 2048")
        check(warm[0]["compiles"] == warm[0]["captures"] == n_programs,
              f"first warm-up {warm[0]}: want {n_programs} captures")
        check(warm[1]["compiles"] == warm[1]["captures"] == 0,
              f"second warm-up {warm[1]}: want no capture")
        misses0, captures0 = eng.cache.misses, eng.captures

        ticks.clear()
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=GEN_NEW) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        burst_ticks = list(ticks)
        check(all(len(o) == GEN_NEW for o in outs),
              "a burst session ended early")
        ttft = [s.first_token_at - s.submitted_at for s in streams]

        # O(1) flatness: one long stream alone, inter-token gap late / early
        gaps, t_prev = [], time.perf_counter()
        for _ in eng.submit(prompts[0][:FLAT_PROMPT],
                            max_new_tokens=FLAT_NEW):
            now = time.perf_counter()
            gaps.append(now - t_prev)
            t_prev = now
        check(len(gaps) == FLAT_NEW, f"flatness stream gave {len(gaps)}")
        third = len(gaps) // 3
        flatness = (statistics.median(gaps[-third:])
                    / statistics.median(gaps[1:1 + third]))

        # (b) sessions of both admission waves rerun alone, bit for bit
        rerun = list(range(0, GEN_BURST, GEN_BURST // GEN_RERUN))
        for i in rerun:
            alone = eng.generate(prompts[i], max_new_tokens=GEN_NEW)
            check(alone == outs[i], f"burst session {i} rerun alone gave "
                  f"other tokens")
        # (a) steady state captured and built nothing
        steady = {"misses": eng.cache.misses - misses0,
                  "captures": eng.captures - captures0}
        check(steady == {"misses": 0, "captures": 0},
              f"steady-state traffic built programs: {steady}")

        with eng._tick_lock:
            check(eng.live_slots == 0 and eng.queue_depth == 0,
                  "engine not idle before the graph checks")
            exact = graph_vs_eager(torch, lm, eng, rng)  # (c)
            decode = eng._decode_fn()
            decode_ms = cuda_ms(decode.graph.replay)
            prefill_ms = {b: cuda_ms(eng._prefill_fn(b).graph.replay)
                          for b in eng.prefill_buckets}
        peak = torch.cuda.max_memory_allocated() / 1e9
        profiled = profile_ticks(torch, eng, prompts) if profile else None
        launches = read_launches()
        # (e) no TPU kernel lies on this path
        check(not any(launches.values()),
              f"generate path launched {launches}, want none")
        kv_bytes = eng.kv_slab_bytes()
    finally:
        eng.close(timeout=60)
    bound_ms, bound_by, nbytes = decode_bound(lm, eng)
    n_tokens = sum(len(o) for o in outs)
    return {
        "config": "TransformerLMConfig() defaults",
        "params": sum(p.numel() for p in lm.parameters()),
        "slots": GEN_SLOTS, "max_len": GEN_MAX_LEN,
        "buckets": list(eng.prefill_buckets), "kv_slab_bytes": kv_bytes,
        "card": card, "warm": warm,
        "burst": {"sessions": GEN_BURST, "prompt_lens": "uniform "
                  f"{GEN_PROMPT_LENS[0]}-{GEN_PROMPT_LENS[1]}, "
                  "RandomState(0)", "max_new_tokens": GEN_NEW,
                  "tokens": n_tokens, "wall_s": wall,
                  "tokens_per_s": n_tokens / wall,
                  "ttft_ms_p50": percentile_ms(ttft, 50),
                  "ttft_ms_p99": percentile_ms(ttft, 99),
                  "ticks": len(burst_ticks),
                  "tick_ms_median": statistics.median(burst_ticks) * 1e3},
        "steady_state_builds": steady, "rerun_bit_equal": rerun,
        "graph_vs_eager": exact,
        "decode_graph_ms": decode_ms, "decode_bound_ms": bound_ms,
        "decode_bound_by": bound_by, "decode_bytes": nbytes,
        "decode_bound_share": bound_ms / decode_ms,
        "scores": "bmm with out_dtype=float32 on bf16 operands",
        "prefill_graph_ms": prefill_ms,
        "flatness": flatness, "flatness_stream": f"{FLAT_PROMPT}-token "
        f"prompt, {FLAT_NEW} tokens, median gap of the last third / the "
        "first third",
        "peak_mem_gb": peak, "held_before_gb": held,
        "kernel_launches": launches,
    }, profiled


def small_generate_phase(torch):
    """Check (d): the small fp32 model of `small_reference_phase` with the
    same weights served on the card (through captured graphs) and on the
    CPU (eager): equal greedy streams over 8 ragged sessions, and prefill
    and decode logits within 1e-4."""
    import numpy as np

    from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    cfg = TransformerLMConfig(vocab_size=512, d_model=128, n_heads=2,
                              d_ff=256, n_layers=2, max_len=256,
                              dtype="float32")
    cpu = TransformerLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    gpu = TransformerLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n)
               for n in rng.randint(2, 60, 8)]
    news = [16 + 8 * (i % 3) for i in range(len(prompts))]
    kw = dict(max_slots=4, max_len=cfg.max_len, buckets=(8, 16, 32, 64))
    streams = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        with GenerationEngine(model, **kw) as eng:
            streams[name] = [s.result(timeout=300) for s in
                             [eng.submit(p, max_new_tokens=n)
                              for p, n in zip(prompts, news)]]
            if name == "card":
                captures = eng.captures
    for i, (a, b) in enumerate(zip(streams["card"], streams["cpu"])):
        if a != b:
            k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            seq = torch.tensor([list(prompts[i]) + b[:k]])
            with torch.no_grad():
                top = cpu(seq)[0, -1].float().topk(2).values
            check(False, f"session {i}: card and CPU streams differ at "
                  f"token {k} ({a[k]} vs {b[k]}); CPU top-2 logit gap "
                  f"{float(top[0] - top[1])}")

    tol = 1e-4  # fp32 on both, sums in another order: a few ulp per layer
    toks = np.zeros(64, np.int64)
    toks[:len(prompts[0])] = prompts[0]
    positions = np.full(4, cfg.max_len - 1)
    logits = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = model.device
        ck, cv = model.init_cache(4, cfg.max_len)
        pre, _, _ = model.prefill(ck, cv, torch.from_numpy(toks).to(dev),
                                  len(prompts[0]), 2)
        steps = [pre.cpu()]
        tokens = np.zeros(4, np.int64)
        tok, pos = int(pre.argmax()), len(prompts[0])
        for _ in range(3):
            tokens[2], positions[2] = tok, pos
            out, _, _ = model.decode_step(
                ck, cv, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev))
            steps.append(out.cpu())
            tok, pos = int(out[2].argmax()), pos + 1
        logits[name] = steps
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["card"], logits["cpu"])]
    check(max(errs) <= tol, f"small fp32 prefill/decode logits card vs CPU: "
          f"max err {errs} > {tol}")
    return {"config": "vocab 512, d_model 128, 2 heads, 2 layers, fp32",
            "sessions": len(prompts), "streams_equal": True,
            "tokens": sum(len(s) for s in streams["card"]),
            "card_captures": captures,
            "prefill_decode_logits_max_abs_err": errs, "tol": tol}


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
    case = {"case": name, "variant": fa.kernel_variant(q.dtype),
            "max_abs_err": err, "tol": tol}
    if timed:
        bound_ms, bound_by, flop = attention_bound(b, l, l, h, d, dtype,
                                                   causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return fa.flash_attention_fwd_kernel(q, k, v, causal, scale)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel),
            plain_ms=cuda_ms(lambda: fa.reference_attention(
                q, k, v, causal, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)),
            library="torch.nn.functional.scaled_dot_product_attention",
            bound_ms=bound_ms, bound_by=bound_by, **rates(ms, bound_ms, flop))
    return case


def quantize_case(torch, gcm, *, shape, dtype, threshold, timed, nan=False):
    """K3 vs its plain version on one gradient and a nonzero fp32 residual:
    the packed words and the new residual must be equal bit for bit (NaN
    where the plain version has NaN)."""
    n = math.prod(shape)
    gen = torch.Generator(device="cuda").manual_seed(n + int(threshold * 10))
    grad = torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    if nan:
        grad.view(-1)[::7] = float("nan")
    residual = (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) \
        * threshold
    want, want_res = gcm.quantize_2bit(grad, residual, threshold)
    packed, res = gcm.quantize_2bit_kernel(grad, residual.clone(), threshold)
    torch.cuda.synchronize()
    name = f"{dtype} {'x'.join(map(str, shape))} t={threshold}" + (
        " with NaN" if nan else "")
    check(packed.shape == want.shape and packed.dtype == torch.int32,
          f"{name}: packed words {packed.shape} {packed.dtype}")
    words_equal = bool(torch.equal(packed, want))
    same = (res.view(torch.int32) == want_res.view(torch.int32)) | (
        res.isnan() & want_res.isnan())
    finite = ~want_res.isnan()
    err = float((res[finite] - want_res[finite]).abs().max()) \
        if bool(finite.any()) else 0.0
    check(words_equal, f"{name}: packed words differ from the plain version")
    check(bool(same.all()), f"{name}: residual differs from the plain "
          f"version (max abs err {err})")
    case = {"case": name, "n": n, "words_equal": words_equal,
            "residual_bit_equal": True, "max_abs_err": err}
    if timed:
        elt = grad.element_size()
        nbytes = n * (elt + 4 + 4) + 4 * gcm.compressed_size(n)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 3 * n / PEAK_FLOPS["float32"]  # an add and two compares
        scratch = residual.clone()
        bound_ms = max(t_bytes, t_ops) * 1e3

        def kernel():
            return gcm.quantize_2bit_kernel(grad, scratch, threshold)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel),
            plain_ms=cuda_ms(lambda: gcm.quantize_2bit(grad, residual,
                                                       threshold)),
            bytes=nbytes, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes > t_ops else "operations",
            **rates(ms, bound_ms, 3 * n))
    return case


def hop_bias(torch, kind, lq, lk):
    """One hop's (Lq, Lk) fp32 bias on the card, or None. The causal kinds
    are the ring's mask for query rows q0.. and keys k0.. (0 where
    q >= k, else -1e30). The ring's hops of equal blocks are of three kinds:
    "diagonal", a position's own block; "past", a block wholly before the
    queries, whose bias is all zeros (6 of the 16 hops a layer at sp = 4);
    "masked", a block wholly in the queries' future. "offset", keys starting
    half a block before the queries, is a partly masked off-diagonal hop that
    blocks of unequal length would give."""
    if kind == "none":
        return None
    if kind == "random":
        gen = torch.Generator(device="cuda").manual_seed(lq + lk)
        return torch.randn(lq, lk, generator=gen, device="cuda")
    q0, k0 = {"offset": (lk, lk // 2), "diagonal": (0, 0),
              "past": (lk, 0), "masked": (0, lq)}[kind]
    q_pos = q0 + torch.arange(lq, device="cuda")[:, None]
    k_pos = k0 + torch.arange(lk, device="cuda")[None, :]
    return torch.where(q_pos >= k_pos, 0.0, -1e30).float()


def partials_case(torch, fa, F, *, b, lq, lk, h, d, dtype, bias, tol, timed):
    """K2 vs its plain version (`_block_attn`) on inputs shaped as the ring
    gives them: q, k, v strided views of one [B, L, 3*H*D] projection. m and
    l must agree to rtol 1e-4 (fp32 statistics of scores summed in another
    order), the normalized output o / l to `tol`."""
    from mxnet_tpu_torch.parallel.ring_attention import _block_attn

    gen = torch.Generator(device="cuda").manual_seed(lq * d + lk)
    qkv = torch.randn(b, max(lq, lk), 3 * h * d, device="cuda",
                      generator=gen).to(getattr(torch, dtype))
    q = qkv[:, :lq, :h * d].view(b, lq, h, d)
    k, v = (t.view(b, lk, h, d)
            for t in qkv[:, :lk, h * d:].split(h * d, dim=-1))
    bias_t = hop_bias(torch, bias, lq, lk)
    scale = 1.0 / math.sqrt(d)
    # the bias as `flash_block_partials` hands it to the kernel: rows
    # `bias_pitch` apart (padded for the bf16 kernel when Lk % 4 != 0)
    kbias = bias_t
    pitch = fa.bias_pitch(lk, fa.kernel_variant(q.dtype))
    if bias_t is not None and pitch != lk:
        kbias = torch.zeros(lq, pitch, device="cuda")[:, :lk].copy_(bias_t)
    o, m, l = fa.flash_block_partials_kernel(q, k, v, kbias, scale)
    ro, rm, rl = _block_attn(q, k, v, bias_t, scale)
    torch.cuda.synchronize()
    name = f"{dtype} B={b} Lq={lq} Lk={lk} H={h} D={d} bias={bias}"
    check(o.shape == q.shape and o.dtype == q.dtype and m.shape == l.shape
          == (b, h, lq, 1), f"{name}: output shapes")
    # relative errors (absolute where |m| < 1); m is -1e30 in fully masked
    # rows
    m_err = float(((m - rm).abs() / rm.abs().clamp_min(1.0)).max())
    l_err = float(((l - rl).abs() / rl.abs()).max())
    out = o.float() / l.permute(0, 2, 1, 3)
    ref = ro.float() / rl.permute(0, 2, 1, 3)
    diff = (out - ref).abs()
    err = float(diff.max())
    check(m_err <= 1e-4 and l_err <= 1e-4,
          f"{name}: m rel err {m_err}, l rel err {l_err} beyond 1e-4")
    # allclose with atol = rtol = tol, the JAX package's kernel-test bound
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"{name}: o / l max abs err {err} beyond {tol}")
    case = {"case": name, "variant": fa.kernel_variant(q.dtype),
            "max_abs_err": err, "tol": tol,
            "m_rel_err": m_err, "l_rel_err": l_err, "stats_rtol": 1e-4}
    if timed:
        bound_ms, bound_by, flop = attention_bound(
            b, lq, lk, h, d, dtype, causal=False, bias=bias_t is not None,
            stats=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if bias_t is None else bias_t.to(q.dtype)

        def kernel():
            return fa.flash_block_partials_kernel(q, k, v, kbias, scale)

        ms = cuda_ms(kernel)
        case.update(
            ms=ms, call_ms=call_ms(kernel), **rates(ms, bound_ms, flop),
            plain_ms=cuda_ms(lambda: _block_attn(q, k, v, bias_t, scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)),
            library="torch.nn.functional.scaled_dot_product_attention with "
            "the bias as attn_mask: the same work, normalized output (no "
            "single PyTorch call returns the unnormalized partials)",
            bound_ms=bound_ms, bound_by=bound_by)
    return case


def timed_fields(case):
    """A kernel's entry on the kernels line from its timed main case."""
    keys = ("case", "variant", "max_abs_err", "tol", "ms", "call_ms",
            "plain_ms", "library_ms", "library", "bound_ms", "bound_by",
            "bound_share", "tflops")
    return {k: case[k] for k in keys if k in case}


def kernels_phase(torch, fa, gcm, launches):
    """The kernels line; `launches` maps each path to its launch counts."""
    import torch.nn.functional as F

    main = attention_case(torch, fa, F, b=TRAIN_BATCH, l=TRAIN_LEN, h=8, d=64,
                          dtype="bfloat16", causal=True, tol=2e-2, timed=True)
    extra = [  # every head dim of the bf16 tensor-core kernel, ragged L
        attention_case(torch, fa, F, b=2, l=77, h=3, d=32, dtype="bfloat16",
                       causal=True, tol=2e-2, timed=False),
        attention_case(torch, fa, F, b=2, l=1000, h=4, d=64, dtype="bfloat16",
                       causal=False, tol=2e-2, timed=False),
        attention_case(torch, fa, F, b=1, l=300, h=2, d=128, dtype="bfloat16",
                       causal=True, tol=2e-2, timed=False),
        # and the fp32 FMA kernel
        attention_case(torch, fa, F, b=2, l=1000, h=4, d=64, dtype="float32",
                       causal=False, tol=1e-5, timed=True),
        attention_case(torch, fa, F, b=2, l=77, h=3, d=32, dtype="float32",
                       causal=True, tol=1e-5, timed=False),
        attention_case(torch, fa, F, b=1, l=130, h=2, d=128, dtype="float32",
                       causal=False, tol=1e-5, timed=False),
    ]
    k1 = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:66",
        "launches": launches["train"]["flash_attention_fwd"],
        "launches_by_path": {p: c["flash_attention_fwd"]
                             for p, c in launches.items()},
        **timed_fields(main), "extra_cases": extra,
    }
    # the largest key of the trainer path: embed's gradient, [32768, 512] bf16
    q_main = quantize_case(torch, gcm, shape=(32768, 512), dtype="bfloat16",
                           threshold=COMPRESSION["threshold"], timed=True)
    q_extra = [quantize_case(torch, gcm, shape=(n,), dtype="float32",
                             threshold=t, timed=False)
               for t in (0.5, 0.1) for n in (1, 100, 2048, 2049, 33 * 65)]
    q_extra.append(quantize_case(torch, gcm, shape=(33, 65), dtype="bfloat16",
                                 threshold=0.1, timed=False, nan=True))
    k3 = {
        "name": "quantize_2bit", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/quantize_2bit.cu",
        "replaces": "mxnet_tpu/gradient_compression.py:106",
        "launches": launches["trainer"]["quantize_2bit"],
        "launches_by_path": {p: c["quantize_2bit"]
                             for p, c in launches.items()},
        **timed_fields(q_main), "tol": 0.0,
        "exact": "packed words and residual bit-equal to the plain version",
        "library_ms": None,
        "library": "none: no single PyTorch call computes this function",
        "extra_cases": q_extra,
    }
    # one ring hop at the ring path's shapes, Lq = Lk = 2048 / sp, with the
    # bias the ring passes most: a past block's all-zero mask
    hop = TRAIN_LEN // RING_SP
    p_main = partials_case(torch, fa, F, b=TRAIN_BATCH, lq=hop, lk=hop, h=8,
                           d=64, dtype="bfloat16", bias="past", tol=2e-2,
                           timed=True)
    # timed without a bias too: what reading the bias costs the hop
    p_extra = [
        partials_case(torch, fa, F, b=TRAIN_BATCH, lq=hop, lk=hop, h=8, d=64,
                      dtype="bfloat16", bias=kind, tol=2e-2,
                      timed=kind == "none")
        for kind in ("masked", "diagonal", "offset", "none", "random")]
    p_extra += [  # ragged blocks and every head dim of the bf16 kernel
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="bfloat16", bias="masked", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="bfloat16", bias="offset", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="float32", bias="offset", tol=1e-5, timed=False),
        partials_case(torch, fa, F, b=2, lq=100, lk=300, h=3, d=64,
                      dtype="float32", bias="masked", tol=1e-5, timed=False),
        partials_case(torch, fa, F, b=2, lq=256, lk=256, h=4, d=32,
                      dtype="bfloat16", bias="diagonal", tol=2e-2,
                      timed=False),
        partials_case(torch, fa, F, b=2, lq=256, lk=256, h=4, d=128,
                      dtype="bfloat16", bias="offset", tol=2e-2, timed=False),
        partials_case(torch, fa, F, b=1, lq=130, lk=70, h=2, d=128,
                      dtype="float32", bias="random", tol=1e-5, timed=False),
        # an odd Lk: the bias read element by element, not in pairs
        partials_case(torch, fa, F, b=1, lq=130, lk=71, h=2, d=64,
                      dtype="bfloat16", bias="random", tol=2e-2, timed=False),
    ]
    k2 = {
        "name": "flash_block_partials", "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/flash_block_partials.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:188",
        "launches": launches["ring"]["flash_block_partials"],
        "launches_by_path": {p: c["flash_block_partials"]
                             for p, c in launches.items()},
        **timed_fields(p_main), "m_rel_err": p_main["m_rel_err"],
        "l_rel_err": p_main["l_rel_err"], "extra_cases": p_extra,
    }
    return [k1, k2, k3]


# the port's kernels by wrapper name -> their group in a profile
PORT_GROUPS = {"flash_attention_fwd": "K1 flash_attention_fwd",
               "flash_block_partials": "K2 flash_block_partials",
               "quantize_2bit": "K3 quantize_2bit"}
KERNEL_GROUPS = (  # substring of a device kernel's name -> its group
    # fp32 FMA kernels, and the bf16 tensor-core kernel by its policy
    # (`sm90::attention_sm90_kernel<D, ...Policy>`)
    ("flash_attention_fwd_kernel", PORT_GROUPS["flash_attention_fwd"]),
    ("FlashAttentionFwdPolicy", PORT_GROUPS["flash_attention_fwd"]),
    ("flash_block_partials_kernel", PORT_GROUPS["flash_block_partials"]),
    ("FlashBlockPartialsPolicy", PORT_GROUPS["flash_block_partials"]),
    ("quantize_2bit_kernel", PORT_GROUPS["quantize_2bit"]),
    ("nccl", "NCCL collectives"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
    ("softmax", "softmax"), ("SoftMax", "softmax"),
    ("reduce", "reductions"), ("Reduce", "reductions"),
    ("Memcpy", "copies"), ("copy", "copies"),
)
RANGES = ("_FlashAttentionBackward", "_FlashAttention",
          "_BlockPartialsBackward", "_BlockPartials", "forward_backward",
          "trainer.step")


def profile_step(torch, step_fn, must_run):
    """One more step of a path under torch.profiler: device time by kernel
    and by group, the inclusive device and host time of the attention
    forward and backward and of the step's ranges, and the device's idle
    share of the step's wall time (which the profiler itself lengthens).
    The step is profiled alone, with no schedule, after a tiny profile that
    starts the tracer, and the profile must hold every launch of the port's
    kernels that the step made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {name: count - before[name]
                for name, count in read_launches().items()}
    kernels = {}
    for ev in prof.events():
        # device work only: skip user ranges on the device track
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            row = kernels.setdefault(ev.name, {"name": ev.name,
                                               "device_ms": 0.0, "count": 0})
            row["device_ms"] += ev.time_range.elapsed_us() / 1e3
            row["count"] += 1
    rows = sorted(kernels.values(), key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups, counts = {}, {}
    for r in rows:
        group = next((g for key, g in KERNEL_GROUPS if key in r["name"]),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + r["device_ms"]
        counts[group] = counts.get(group, 0) + r["count"]
    ranges = {}
    for ev in prof.key_averages():
        for name in RANGES:
            if ev.key.endswith(name):
                # a user range appears twice, on the host track and on the
                # device track: keep the larger of each time
                r = ranges.setdefault(name, {"device_ms": 0.0,
                                             "host_ms": 0.0})
                r["device_ms"] = max(r["device_ms"],
                                     ev.device_time_total / 1e3)
                r["host_ms"] = max(r["host_ms"], ev.cpu_time_total / 1e3)
    for group in must_run:
        check(groups.get(group, 0) > 0, f"the profiled step ran no {group}")
    for name in launched:
        group = PORT_GROUPS[name]
        check(counts.get(group, 0) == launched[name],
              f"the profile holds {counts.get(group, 0)} of the step's "
              f"{launched[name]} launches of {name}")
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms),
            "kernel_launches": launched,
            "groups_ms": groups, "groups_launches": counts,
            "ranges": ranges, "kernels": rows}


def profile_summary(profile):
    """A profile without its full kernel list, with the top 8 kernels."""
    out = {k: v for k, v in profile.items() if k != "kernels"}
    out["top"] = [{"name": r["name"][:80], "device_ms": r["device_ms"],
                   "count": r["count"]} for r in profile["kernels"][:8]]
    return out


def hgmma_counts(build, names):
    """{source: the count of HGMMA (wgmma) instructions in its library's
    SASS}, or a note that cuobjdump is missing: the check never fails."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return "cuobjdump not found beside nvcc"
    counts = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(build._output(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[name] = sass.count("HGMMA")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT.json",
                        help="also profile one step of each path into "
                        "OUT.json")
    parser.add_argument("--deadline", type=float, default=1100,
                        metavar="SECONDS", help="dump every thread's stack "
                        "and exit 1 if the run is not over by then")
    args = parser.parse_args(argv)
    faulthandler.dump_traceback_later(args.deadline, exit=True)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch import gradient_compression as gcm
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
                "ptxas": ptxas, "hgmma": hgmma_counts(_build, names)})

    train, lm_state = train_phase(torch)
    small = small_reference_phase(torch)
    progress("train")
    ring, ring_state = ring_phase(torch, train)
    small_ring = small_reference_phase(torch, sp=RING_SP)
    progress("ring")
    # before any profiler: the engines' worker threads replay graphs
    small_generate = small_generate_phase(torch)
    generate, generate_profile = generate_phase(torch, smi,
                                                profile=bool(args.profile))
    progress("generate")
    trainer, trainer_profile = trainer_phase(torch, profile=bool(args.profile))
    progress("trainer")
    kernels = kernels_phase(torch, fa, gcm, {
        "train": train["kernel_launches"],
        "ring": ring["kernel_launches"],
        "trainer": trainer["kernel_launches"],
        "generate": generate["kernel_launches"]})
    emit(kernels=kernels)
    emit(train=train, small_reference=small)
    emit(ring=ring, small_reference=small_ring)
    emit(trainer=trainer)
    emit(generate=generate, small_reference=small_generate)
    if args.profile:
        def one_more_step(state_of_path):
            _, step, state, tokens, targets = state_of_path
            return lambda: step(state, tokens, targets, TRAIN_STEPS)

        profiles = {
            "train": profile_step(torch, one_more_step(lm_state),
                                  must_run=("K1 flash_attention_fwd",)),
            "ring": profile_step(torch, one_more_step(ring_state),
                                 must_run=("K2 flash_block_partials",)),
            "trainer": trainer_profile, "generate": generate_profile}
        with open(args.profile, "w") as f:
            json.dump(profiles, f, indent=1)
        emit(profile={"path": args.profile, **{
            k: profile_summary(v) for k, v in profiles.items()}})
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
