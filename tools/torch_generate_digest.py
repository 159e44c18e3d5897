"""Digest of the port's generate burst, to hold two trees of the port to
each other on one card.

Runs ``chip_smoke.generate_phase`` of the tree at ROOT (its own
``mxnet_tpu_torch`` package): the default `TransformerLMConfig` from seed 0,
a 32 x 2048 `GenerationEngine`, two warm-ups and the 64-session burst.
Prints one JSON line with the sha256 of the burst's streams (computed as
the generate line of ``chip_smoke.py`` computes it), the graph keys of the
engine, the warm-ups' captures and the builds after warm-up. Two trees whose
lines agree serve the same streams from the same graphs.

Usage (a CUDA card is needed)::

    python3 tools/torch_generate_digest.py [ROOT]

ROOT defaults to the checkout holding this file.
"""
import hashlib
import json
import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(argv[0] if argv else os.path.join(here, ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_generate_digest: no CUDA card")
    import chip_smoke
    from mxnet_tpu_torch.serving.generation import GenerationEngine

    keys = []
    close = GenerationEngine.close

    def close_and_note(self, *args, **kwargs):
        keys.append(sorted(map(repr, self.cache.keys())))
        return close(self, *args, **kwargs)

    GenerationEngine.close = close_and_note
    card = torch.cuda.get_device_name(0)
    result, _, state = chip_smoke.generate_phase(torch, card)
    print(json.dumps({
        "root": root, "card": card,
        "overlap": os.environ.get("MXNET_OVERLAP"),
        "streams_sha256": hashlib.sha256(
            json.dumps(state["outs"]).encode()).hexdigest(),
        "graph_keys": keys[0] if keys else None,
        "warm": result["warm"],
        "steady_state_builds": result["steady_state_builds"],
        "tokens_per_s": result["burst"]["tokens_per_s"]}))


if __name__ == "__main__":
    main()
