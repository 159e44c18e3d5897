"""How often an `mx.profiler` session's trace loses a kernel of the step
it profiled, on a CUDA card.

Builds the port's kernels, trains the full-width model for
`chip_smoke.TRAIN_STEPS` steps (`chip_smoke.train_phase`), optionally
runs `chip_smoke.vision_phase` first (``--after-vision``: its
torch.profiler sessions and DataLoader worker processes precede the
profiler phase in `chip_smoke.py`), then runs ``--sessions`` pairs of
`chip_smoke.profiler_session`, one without and one with ``settle`` (a
tiny kernel and a wait for the card before and after the step, inside
the session), alternating. Prints a line a session as it ends, then
one JSON line: for each variant the
sessions whose trace held fewer K1 events than the step launched, and
for those the K1 events' start times relative to the ``train.step``
span; the full record, with the vision phase's line, goes to ``--out``.

    python tools/torch_profiler_repeat.py --sessions 8 --after-vision \\
        --out profiler_repeat.json
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def session_record(torch, lm_state, settle):
    run = cs.profiler_session(torch, lm_state, settle=settle)
    span = run["spans"][0] if run["spans"] else {}
    t0 = float(span.get("ts", 0.0))
    return {"launched": run["launched"], "k1_events": len(run["k1"]),
            "k1_start_us": sorted(float(e["ts"]) - t0 for e in run["k1"]),
            "span_us": span.get("dur"), "events": run["events"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=40)
    parser.add_argument("--after-vision", action="store_true")
    parser.add_argument("--out", default="profiler_repeat.json")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_repeat: needs a CUDA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.card_line()
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    _, lm_state = cs.train_phase(torch)
    vision_s = vision = None
    if args.after_vision:
        t0 = time.perf_counter()
        vision = cs.vision_phase(torch, smi)
        vision_s = time.perf_counter() - t0
        print(json.dumps({"vision_s": vision_s}), flush=True)
    runs = {"bare": [], "settled": []}
    for i in range(args.sessions):
        for name, settle in (("bare", False), ("settled", True)):
            t0 = time.perf_counter()
            record = session_record(torch, lm_state, settle)
            record["seconds"] = time.perf_counter() - t0
            runs[name].append(record)
            print(json.dumps({"session": i, "variant": name,
                              "k1_events": record["k1_events"],
                              "launched": record["launched"],
                              "seconds": record["seconds"]}), flush=True)
    summary = {}
    for name, records in runs.items():
        short = [r for r in records if r["k1_events"] < r["launched"]]
        summary[name] = {"sessions": len(records), "short": len(short),
                         "short_records": short}
    with open(args.out, "w") as f:
        json.dump({"card": smi, "after_vision": args.after_vision,
                   "vision_s": vision_s, "vision": vision, "runs": runs},
                  f, indent=1)
    print(json.dumps({"card": smi, "after_vision": args.after_vision,
                      "vision_s": vision_s, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
