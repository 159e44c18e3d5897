"""Pretrained weight files: the port of
`mxnet_tpu/gluon/model_zoo/model_store.py` (parity
`python/mxnet/gluon/model_zoo/model_store.py`).

The reference downloads ``.params`` files; nothing is downloaded here:
`get_model_file` finds ``{root}/{name}.params`` or raises
`FileNotFoundError` naming that path, as the JAX package does.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "purge"]


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """The path of model ``name``'s stored parameter file."""
    root = os.path.expanduser(root)
    path = os.path.join(root, f"{name}.params")
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        f"Pretrained weights for '{name}' not found under {root}. Nothing "
        f"is downloaded; place the parameter file at {path} to use "
        "pretrained=True.")


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Remove every stored ``.params`` file under ``root``."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
