"""Staged against lockstep `Module.fit` over the batch size, on one card.

`bench.py`'s host-heavy MLP (512 -> 512 -> 8, float64 sources cast to
float32, SGD with momentum) through the port's `Module.fit` at batches of
0.5, 4, 16 and 64 MiB, fed by an `NDArrayIter` that copies its batches to
the card itself (``card``) and by one that hands them over on the host
(``host``). Each runs with ``MXNET_OVERLAP`` off, on, on, off, every batch
staged when on (`io.staging.STAGE_MIN_BYTES` set to 0), one cold epoch
then the timed ones. Prints the card line, then one JSON line a (batch,
feed) with the steps/s of each run and the sum of the on rates over the
off ones: where the host feed's ratio crosses 1 is where the staging
thread starts to pay for its hand-off (`STAGE_MIN_BYTES`).

Usage (a CUDA card is needed)::

    python3 tools/torch_overlap_sweep.py
"""
import json
import os
import subprocess
import sys
import time

# (rows a batch, batches, timed epochs): 0.5, 4, 16 and 64 MiB of float32
SIZES = ((256, 8, 12), (2048, 8, 6), (8192, 4, 6), (32768, 2, 6))


def fit(torch, mx, batch, batches, epochs, host_feed):
    """Steps/s of the timed epochs of one fit."""
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch * batches, 512))
    y = rng.randint(0, 8, (batch * batches,)).astype(np.float64)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=512, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=8, name="fc2")
    sym = mx.sym.SoftmaxOutput(fc2, name="softmax")
    marks = {}

    def at_epoch_end(epoch, *_):
        if epoch == 0:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()

    mx.random.seed(7)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    it.host_batches = host_feed
    mod.fit(it, num_epoch=epochs + 1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)),
            initializer=mx.init.Xavier(), epoch_end_callback=at_epoch_end)
    torch.cuda.synchronize()
    return epochs * batches / (time.perf_counter() - marks["t0"])


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_overlap_sweep: no CUDA card")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import staging

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    staging.STAGE_MIN_BYTES = 0
    for batch, batches, epochs in SIZES:
        for feed in ("card", "host"):
            rates = {"off": [], "on": []}
            for mode in ("off", "on", "on", "off"):
                os.environ["MXNET_OVERLAP"] = "1" if mode == "on" else "0"
                rates[mode].append(fit(torch, mx, batch, batches, epochs,
                                       feed == "host"))
            print(json.dumps({
                "batch": batch, "mib": batch * 512 * 4 / 2 ** 20,
                "feed": feed, "steps_per_s_off": rates["off"],
                "steps_per_s_on": rates["on"],
                "on_over_off": sum(rates["on"]) / sum(rates["off"])}),
                flush=True)


if __name__ == "__main__":
    main()
