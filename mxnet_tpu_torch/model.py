"""Model-level helpers: the port of `mxnet_tpu/model.py`'s `_create_kvstore`
(checkpointing is not ported yet)."""
from __future__ import annotations

import os

from . import kvstore as kvs


def _create_kvstore(kvstore, num_device, arg_params):
    """Create the kvstore a trainer asked for, and decide whether the
    optimizer runs on it: returns ``(kvstore or None, update_on_kvstore)``.

    ``kvstore`` is a store, a type name or None. One device with a non-dist
    name needs no store. A dist store is placed on the device of the
    parameters in ``arg_params`` (a dict of tensors). A ``local`` store
    holding a parameter above 16M values updates on the workers.
    `MXNET_UPDATE_ON_KVSTORE=0` turns updates on the store off."""
    update_on_kvstore = bool(int(os.getenv("MXNET_UPDATE_ON_KVSTORE", "1")))
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStoreBase):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None  # one device: updates happen inline
        else:
            device = next(iter(arg_params.values())).device \
                if arg_params else None
            kv = kvs.create(kvstore, device=device)
            if kvstore == "local":
                max_size = max((t.numel() for t in arg_params.values()),
                               default=0)
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore
