"""Model-level helpers: the port of `mxnet_tpu/model.py` (parity
`python/mxnet/model.py`): the kvstore wiring (`_create_kvstore`,
`_update_params`, `_update_params_on_kvstore`) and checkpoints
(`save_checkpoint`, `load_checkpoint`, `list_checkpoint_epochs`,
`find_latest_checkpoint`).

A checkpoint is ``prefix-symbol.json`` and ``prefix-####.params``, the
same files as the JAX package's, so either package loads the other's. The
JAX package's keyed syncs of gradients in buckets (`MXNET_GRAD_BUCKETING`)
wait for `parallel/grad_sync.py` (ROADMAP.md queue A, item 4.5); here each
key is pushed and pulled on its own, which sums the same values. Old
epochs are evicted synchronously (the JAX package can defer it to its
engine's IO thread).
"""
from __future__ import annotations

import logging
import os
import re
import time
from collections import namedtuple

from . import health, telemetry, tracing
from . import kvstore as kvs
from . import ndarray as nd
from .base import MXNetError, getenv, register_env

__all__ = ["save_checkpoint", "load_checkpoint", "find_latest_checkpoint",
           "list_checkpoint_epochs", "BatchEndParam"]

register_env("MXNET_CHECKPOINT_KEEP", 0,
             "retain only the newest K epoch .params files (0 = all)")

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals",
                            "step_stats"],
                           defaults=[None])


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


def _tensors(arrays):
    return [a if not hasattr(a, "_data") else a._data for a in arrays]


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each parameter's gradients and pull its updated weights (the
    optimizer runs on the store; parity model.py:150)."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, _tensors(grad_list), priority=-index)
        kvstore.pull(name, _tensors(arg_list), priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum each parameter's gradients through the store (when one is
    given), then update locally (parity model.py:162)."""
    live = [i for i, (_, grad_list)
            in enumerate(zip(param_arrays, grad_arrays))
            if grad_list[0] is not None]
    if kvstore:
        for index in live:
            grads = _tensors(grad_arrays[index])
            kvstore.push(param_names[index], grads, priority=-index)
            kvstore.pull(param_names[index], grads, priority=-index)
    updates = [[] for _ in range(num_device)]
    for index in live:
        for k, (w, g) in enumerate(zip(param_arrays[index],
                                       grad_arrays[index])):
            updates[k].append((index * num_device + k, g, w))
    for dev_updates in updates:
        if dev_updates:
            i, g, w = zip(*dev_updates)
            updater(list(i), list(g), list(w))


def _param_path(prefix, epoch):
    return "%s-%04d.params" % (prefix, epoch)


def list_checkpoint_epochs(prefix):
    """Sorted epoch numbers with an existing ``prefix-####.params`` file."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    pat = re.compile(re.escape(base) + r"-(\d{4,})\.params$")
    try:
        entries = os.listdir(d)
    except OSError:
        return []
    return sorted(int(m.group(1)) for m in map(pat.match, entries) if m)


def find_latest_checkpoint(prefix):
    """The newest saved epoch of ``prefix``, or None."""
    epochs = list_checkpoint_epochs(prefix)
    return epochs[-1] if epochs else None


def _cpu():
    from .context import cpu
    return cpu()


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True, keep=None):
    """Write ``prefix-symbol.json`` and ``prefix-####.params`` (parity
    model.py:394). ``keep`` (or `MXNET_CHECKPOINT_KEEP`) bounds retention:
    after a save that reads back whole, only the newest ``keep`` epoch
    files stay. With ``MXNET_ROLLOUT_DIR`` set, the epoch is also published
    there as rollout version ``epoch`` (`serving.rollout`); a publish
    failure is logged, never raised. With telemetry on, the caller's time
    (the copies from the card included) goes into
    ``checkpoint.save_us``; tracing spans it as ``checkpoint.save``."""
    tele = telemetry._enabled
    t0 = time.perf_counter() if tele else 0.0
    with tracing.span("checkpoint.save", cat="io", prefix=prefix,
                      epoch=epoch):
        if symbol is not None:
            symbol.save(f"{prefix}-symbol.json",
                        remove_amp_cast=remove_amp_cast)
        save_dict = {f"arg:{k}": v.as_in_context(_cpu())
                     for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v.as_in_context(_cpu())
                          for k, v in aux_params.items()})
        cur_path = _param_path(prefix, epoch)
        nd.save(cur_path, save_dict)
    if tele:
        telemetry.histogram("checkpoint.save_us").record(
            (time.perf_counter() - t0) * 1e6)
    keep = getenv("MXNET_CHECKPOINT_KEEP") if keep is None else int(keep)
    if keep > 0:
        survivors = set(list_checkpoint_epochs(prefix)[-keep:]) | {epoch}
        victims = [_param_path(prefix, old)
                   for old in list_checkpoint_epochs(prefix)
                   if old not in survivors]
        if victims:
            _evict_old_epochs(victims, cur_path)
    if str(getenv("MXNET_ROLLOUT_DIR") or "").strip():
        # train -> serve streaming: every checkpoint also becomes a rollout
        # version; a publish failure never reaches the training loop
        from .serving import rollout

        rollout.publish_checkpoint(prefix, epoch, arg_params, aux_params)


def _evict_old_epochs(old_paths, new_path):
    """Remove the evicted epoch files, but only once the new one reads
    back whole (every array's CRC checked): never trade the last good
    checkpoint for an unloadable one."""
    try:
        nd.load(new_path, ctx=_cpu())
    except (MXNetError, OSError):
        return
    for p in old_paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def load_checkpoint(prefix, epoch=None, fallback=None, return_epoch=False):
    """Load a checkpoint (parity model.py:424): ``(symbol, arg_params,
    aux_params)``, the arrays on the host, and the epoch loaded too when
    ``return_epoch``.

    ``epoch=None`` loads the newest saved epoch; then (or when
    ``fallback`` is true) an unreadable epoch file (a CRC mismatch, a
    truncated or vanished file) is logged and the next older epoch is
    tried."""
    from . import symbol as sym

    symbol = None
    json_path = f"{prefix}-symbol.json"
    if os.path.exists(json_path):
        symbol = sym.load(json_path)
    if fallback is None:
        fallback = epoch is None
    if epoch is None:
        epoch = find_latest_checkpoint(prefix)
        if epoch is None:
            raise MXNetError(f"no checkpoints found for prefix {prefix!r}")
    candidates = [epoch]
    if fallback:
        candidates += [e for e in reversed(list_checkpoint_epochs(prefix))
                       if e < epoch]
    errors = []
    save_dict = loaded_epoch = None
    with tracing.span("checkpoint.load", cat="io", prefix=prefix,
                      epoch=epoch):
        for cand in candidates:
            try:
                save_dict = nd.load(_param_path(prefix, cand), ctx=_cpu())
                loaded_epoch = cand
                break
            except (MXNetError, OSError) as e:
                errors.append(e)
                if not fallback:
                    raise
                if telemetry._enabled:
                    telemetry.counter("checkpoint.crc_fallback").inc()
                    telemetry.counter("checkpoint.corrupt_skipped").inc()
                if health._enabled:
                    health.event("checkpoint_fallback", prefix=str(prefix),
                                 epoch=int(cand), error=repr(e))
                logging.getLogger("mxnet_tpu_torch.model").warning(
                    "checkpoint %s is unreadable (%s); falling back to an "
                    "older epoch", _param_path(prefix, cand), e)
    if save_dict is None:
        raise MXNetError(
            f"no loadable checkpoint for prefix {prefix!r} at or below "
            f"epoch {epoch}: {errors}") from (errors[-1] if errors else None)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    if return_epoch:
        return symbol, arg_params, aux_params, loaded_epoch
    return symbol, arg_params, aux_params
