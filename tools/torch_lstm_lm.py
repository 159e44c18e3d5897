"""The full-width LSTM language model of `chip_smoke.py`'s ``lstm_lm`` phase
at a chosen learning rate, on one card: `example/gluon/word_language_model.py`'s
`RNNModel` at `chip_smoke.LM_FULL` (2 x 1500, vocab 33,278, bptt 35, batch
32, dropout 0.65), ``model.rnn`` hybridized, its loop with the Trainer's
elementwise ``clip_gradient`` 0.25, fp32 with TF32 off, over the phase's
pool of bptt windows. Prints the card line, then one JSON line with each
iteration's perplexity and iteration time. Nothing is checked: this is how
the phase's rate was chosen (at rate 20, MXNet's train.py value, the model
diverged under the elementwise clip).

Usage (a CUDA card is needed)::

    python3 tools/torch_lstm_lm.py [--lr 20] [--iterations 23]
"""
import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lr", type=float, default=None,
                        help="SGD rate (default: chip_smoke.LM_OPT's)")
    parser.add_argument("--iterations", type=int, default=23)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_lstm_lm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    import mxnet_tpu_torch as mx

    smi = cs.card_line()
    print(smi, flush=True)
    cfg = dict(cs.LM_FULL)
    if args.lr is not None:
        cfg["lr"] = args.lr
    ctx = mx.gpu(0)
    mx.random.seed(0)
    ex, model, trainer, loss_fn = cs.word_lm_setup(mx, ctx, cfg)
    pool = [(mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx))
            for x, y in cs.word_lm_windows(ex, cfg, cs.LM_POOL)]
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=cfg["batch"],
                               ctx=ctx)
    ppl, ms = [], []
    for i in range(args.iterations):
        x, y = pool[i % cs.LM_POOL]
        t0 = time.perf_counter()
        loss, hidden = cs.word_lm_iteration(mx, model, trainer, loss_fn, x,
                                            y, hidden, cfg)
        ppl.append(math.exp(float(loss.mean().asnumpy())))
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"lr": cfg.get("lr", cs.LM_OPT["learning_rate"]),
                      "clip_gradient": cs.LM_OPT["clip_gradient"],
                      "perplexity": ppl, "iteration_ms": ms, "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
