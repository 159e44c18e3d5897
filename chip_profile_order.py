#!/usr/bin/env python3
"""Run `chip_smoke.py --profile` in the order that crashed (ROADMAP C.4),
several times, each run in a process of its own.

    python3 chip_profile_order.py [--runs N] [--out DIR] [--timeout S]
                                  [--variant NAME] [--env NAME=VALUE]

The order: every phase as `chip_smoke.main` runs it, except that the
`module` phase takes no profile of its own. The profiles of one more
fused and one more eager Module step are taken in the final profile loop
instead, after the kernels phase and after the train, ring, trainer,
generate, nd and gluon profiles, and after the module phase's noise
reading (`module_noise`, ~12 small captured graphs made and destroyed).
That is where the first profiled replay of the full-width Module graph
segfaulted inside `CUDAGraph.replay`, in 4 of 4 runs on one H100. The
variants below bisect it; what each showed is in ROADMAP.md, C.4.

``--variant`` runs a shorter sequence instead of the whole order: the
named phases of `chip_smoke` in their usual order (each with its own
profile where it takes one), then the late profile of one more fused
Module step. ``--env`` sets a variable in each run's environment before
it starts. Each run writes its stdout, stderr and profile to
``DIR/<variant>_<i>.*`` (default `build/profile_order/`, which git
ignores); a segfault prints the Python stack of each thread there. The
parent prints one JSON line a run (exit code, seconds, the last phase
reported done, whether a segfault shows in stderr) and a summary line,
and exits 0 when every run exited 0.
"""
from __future__ import annotations

import argparse
import collections.abc
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

# the phases of a shorter run, each a subset of chip_smoke's order
# ("sessions": 12 profiles of one small op, in the final loop); "no_noise"
# is the whole order without the module phase's noise reading
VARIANTS = {"full": None, "no_noise": None,
            "module_serve": ("module", "serve"),
            "generate_module": ("generate", "module"),
            "trainer_module": ("trainer", "module"),
            "module_sessions": ("module", "sessions"),
            "late_loop": ("train", "nd", "gluon", "module"),
            "nd_module": ("nd", "module"),
            "gluon_module": ("gluon", "module"),
            "late_trainer": ("train", "trainer", "nd", "gluon", "module"),
            "late_generate": ("train", "generate", "nd", "gluon", "module"),
            "late_ring_kernels": ("train", "ring", "nd", "gluon", "module",
                                  "kernels"),
            "early_sessions": ("early", "module", "sessions"),
            "early_sessions_nonoise": ("early", "module", "sessions"),
            "late_trainer_plain": ("train", "trainer", "nd", "gluon",
                                   "module"),
            "late_trainer_nogen": ("train", "trainer", "nd", "gluon",
                                   "module")}


class LateModuleProfiles(collections.abc.Mapping):
    """The Module's profiles, each taken when the final profile loop of
    `chip_smoke.main` reads it (``**profiles`` in its dict display), not
    when the module phase ends."""

    def __init__(self, torch, steps):
        self._torch = torch
        self._steps = steps

    def __iter__(self):
        return iter(f"module_{path}" for path in self._steps)

    def __len__(self):
        return len(self._steps)

    def __getitem__(self, key):
        import chip_smoke as cs

        path = key[len("module_"):]
        print(f"chip_profile_order: profiling {key}", file=sys.stderr,
              flush=True)
        return cs.profile_step(self._torch, self._steps[path],
                               must_run=("convolution", "batchnorm"))


def module_phase_late(torch, smi, workdir, profile=False):
    """`chip_smoke.module_phase` with its profiles deferred: the same
    measurements and checks (noise reading included), and a
    `LateModuleProfiles` in place of the profiles."""
    import chip_smoke as cs
    import mxnet_tpu_torch as mx

    cs.reset_launches()
    full, steps = [], {}
    for fused in (True, False):
        line, steps["fused" if fused else "eager"] = cs.module_full_width(
            torch, mx, smi, fused)
        full.append(line)
    launches = cs.read_launches()
    cs.check(not any(launches.values()),
             f"the module path launched kernels: {launches}")
    line = {"full_width": full, "kernel_launches": launches,
            **cs.module_checks(mx, workdir)}
    return line, (LateModuleProfiles(torch, steps) if profile else {})


def child(variant, profile_path, deadline):
    import chip_smoke as cs

    faulthandler.enable()
    cs.module_phase = module_phase_late
    if variant in ("no_noise", "early_sessions_nonoise"):
        cs.module_noise = lambda mx, card, n: []
    if variant == "late_trainer_nogen":
        # the full-width Module step (the first step graph captured) without
        # the generator's state; the small ones keep it
        from mxnet_tpu_torch.compile_cache import capture
        from mxnet_tpu_torch.symbol import executor

        first = []

        def capture_first_without(*a, generator=None, **k):
            if not first:
                first.append(True)
                generator = None
            return capture(*a, generator=generator, **k)

        executor.capture = capture_first_without
    if VARIANTS[variant] is None:
        return cs.main(["--profile", profile_path, "--deadline",
                        str(deadline)])
    faulthandler.dump_traceback_later(deadline, exit=True)
    import torch

    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.card_line()
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    conv = ("convolution", "batchnorm")
    late, module = [], {}   # (name, step, must_run) for the final loop
    with tempfile.TemporaryDirectory() as workdir:
        for part in VARIANTS[variant]:
            if part == "train":
                trained, (_, train, state, tok, tgt) = cs.train_phase(torch)
                late.append(("train", lambda: train(state, tok, tgt,
                                                    cs.TRAIN_STEPS),
                             ("K1 flash_attention_fwd",)))
            elif part == "ring":
                _, (_, ring, rstate, rtok, rtgt) = cs.ring_phase(torch,
                                                                 trained)
                late.append(("ring", lambda: ring(rstate, rtok, rtgt,
                                                  cs.TRAIN_STEPS),
                             ("K2 flash_block_partials",)))
            elif part == "kernels":
                from mxnet_tpu_torch import gradient_compression as gcm
                from mxnet_tpu_torch.ops import flash_attention as fa

                zero = {k: 0 for k in cs.read_launches()}
                cs.kernels_phase(torch, fa, gcm, {p: zero for p in (
                    "train", "ring", "trainer")})
            elif part == "generate":
                cs.generate_phase(torch, smi, profile=True)
            elif part == "trainer":
                cs.trainer_phase(torch, profile=True)
            elif part == "nd":
                _, steps = cs.nd_phase(torch, smi)
                late += [(f"nd_{k}", f, conv) for k, f in steps.items()]
            elif part == "gluon":
                _, steps = cs.gluon_phase(torch, smi, workdir)
                late += [(f"gluon_{k}", f, () if k.startswith("update")
                          else conv) for k, f in steps.items()]
            elif part == "module":
                _, module = module_phase_late(torch, smi, workdir,
                                              profile=True)
            elif part == "serve":
                cs.serve_phase(torch, smi, workdir, profile=True)
            elif part == "early":
                cs.profile_step(torch, lambda: torch.ones(
                    1, device="cuda").add_(1), must_run=())
            elif part == "sessions":
                late += [("small_op", lambda: torch.ones(
                    1, device="cuda").add_(1), ())] * 12
            cs.progress(part)
        for _, step_fn, must_run in late:
            cs.profile_step(torch, step_fn, must_run=must_run)
        if variant == "late_trainer_plain":
            # the graph replayed without a profiler first
            for _ in range(3):
                module._steps["fused"]()
            torch.cuda.synchronize()
            print("chip_profile_order: 3 plain replays done", file=sys.stderr,
                  flush=True)
        profiles = dict(module)   # the Module's profiles, taken last
    with open(profile_path, "w") as f:
        json.dump(profiles, f)
    cs.emit(ok=True, variant=variant)
    return 0


def last_phase(stderr):
    done = [line.split()[1] for line in stderr.splitlines()
            if line.startswith("chip_smoke: ") and line.endswith(" done")]
    return done[-1] if done else None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--out", default=os.path.join("build",
                                                      "profile_order"))
    parser.add_argument("--timeout", type=float, default=400,
                        help="seconds a run may take before it is killed")
    parser.add_argument("--variant", default="full", choices=sorted(VARIANTS))
    parser.add_argument("--env", action="append", default=[],
                        metavar="NAME=VALUE")
    parser.add_argument("--child", metavar="PROFILE.json",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child(args.variant, args.child, args.timeout - 30)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, **dict(e.split("=", 1) for e in args.env))
    rcs = []
    for i in range(args.runs):
        stem = os.path.join(args.out, f"{args.variant}_{i}")
        t0 = time.perf_counter()
        with open(stem + ".txt", "w") as out, open(stem + ".err", "w") as err:
            try:
                rc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     stem + ".json", "--timeout", str(args.timeout),
                     "--variant", args.variant],
                    stdout=out, stderr=err, env=env,
                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        with open(stem + ".err") as f:
            stderr = f.read()
        rcs.append(rc)
        print(json.dumps({"variant": args.variant, "env": args.env,
                          "run": i, "rc": rc,
                          "seconds": time.perf_counter() - t0,
                          "last_phase_done": last_phase(stderr),
                          "segfault": "Segmentation fault" in stderr
                          or rc == -11}), flush=True)
    print(json.dumps({"variant": args.variant, "runs": args.runs, "rcs": rcs,
                      "all_exit_0": all(rc == 0 for rc in rcs)}), flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
