"""CachedOp: a function of NDArrays run as captured CUDA graphs. The port
of `mxnet_tpu/_cached_op.py` (parity `src/imperative/cached_op.cc`).

The JAX package traces the function into one XLA program, and under
`record()` records one tape node whose pullback is the whole-graph
backward. Here, on a CUDA card, the first call with a new signature (the
inputs' shapes, dtypes and ``requires_grad``, the train flag and whether
autograd records) runs the function twice eagerly on a side stream (the
set-up that a capture must not see: cuDNN's algorithm choice, workspace),
then captures it once as a `torch.cuda.CUDAGraph`, and under recording
captures its backward too: `torch.autograd.grad` of the outputs that need
a gradient against static cotangent buffers. Each instance's graphs (see
below) have their own memory pool. Every later call copies its inputs into
the graph's static input buffers, replays the forward graph and returns
copies of its outputs; under recording it is one node of torch's autograd
graph (one `torch.autograd.Function`), whose backward copies the
cotangents in and replays the backward graph. This is the pattern of
`torch.cuda.make_graphed_callables`. A capture that fails raises; nothing
falls back to eager calls. On the CPU a call runs the function eagerly,
op by op, as the JAX package's eager path does.

The leading ``n_state`` inputs are state (a block's parameters): the graphs
read them in the tensors where they lie, so an update written in place
(the fused optimizer step) reaches the next replay with no copy. A state
input whose array was rebound to another tensor since the capture (the
per-op optimizer path, which rebinds) is copied into the captured tensor
before each replay. The function's in-place writes into a state input
(BatchNorm's moving stats, ``mutate_aux``) land in the parameter at each
replay, and are copied back where the array was rebound. The warm-up
calls move those stats too, so they are put back before the capture: the
first call moves them once.

A generator of the port's (`mxnet_tpu_torch.random`) is registered with
each graph, so a replay draws new random numbers (Dropout).

A replay overwrites the activations that its call's backward needs, so
each signature keeps a small pool of captured instances (`_Pool`), each
with its own graphs, static buffers and memory pool. A call under
`record()` takes an instance whose backward is not pending, and captures
a new one when every instance has a pending backward; the backward
replays its own call's instance and then frees it, and an instance whose
recorded output is dropped without a backward is freed when that
output's autograd node is released. So a block called twice under one
`record()` before its backward (the DCGAN discriminator on the real and
the generated batch) holds two instances of one signature, and later
iterations capture nothing, as the JAX package's traced program runs that
loop.
"""
from __future__ import annotations

import threading

import torch

from . import autograd
from . import random as _random
from .base import MXNetError
from .compile_cache import (WARMUP_CALLS, CompileCache, capture_on,
                            capture_stream)

__all__ = ["CachedOp"]


class CachedOp:
    """Wrap ``fn(*ndarrays) -> NDArray | list[NDArray]`` as one op."""

    def __init__(self, fn, static_alloc=False, static_shape=False,
                 inline_limit=2, n_state=0):
        # static_alloc, static_shape, inline_limit: the reference's options,
        # taken for its callers; every graph here is static already
        self._fn = fn
        self._n_state = n_state
        self._cache = CompileCache("cached_op")

    @property
    def graphs(self):
        """The CUDA graphs captured: a forward, and under recording a
        backward, for each instance of each signature."""
        return sum(1 + (p.bwd_graph is not None)
                   for pool in self._cache.values() for p in pool.instances)

    @property
    def captures(self):
        """Instances captured, over every signature."""
        return sum(len(pool.instances) for pool in self._cache.values())

    def instances(self):
        """{signature: instances captured}; a signature is (train,
        recording, ((shape, dtype, device, requires_grad) of each
        input))."""
        return {key: len(pool.instances)
                for key, pool in zip(self._cache.keys(),
                                     self._cache.values())}

    def __call__(self, *inputs):
        # the function's ops give dense gradients, as the JAX package's
        # traced program does (a row-sparse gradient's `unique` reads its
        # size on the host, which a capture cannot)
        with autograd._dense_grads():
            return self._call(*inputs)

    def _call(self, *inputs):
        from .ndarray.ndarray import NDArray

        tensors = [a._data for a in inputs if isinstance(a, NDArray)]
        if len(tensors) != len(inputs):
            raise TypeError("CachedOp inputs must be NDArrays")
        if not tensors or not _graphed(tensors[0]):
            return self._fn(*inputs)
        train = bool(autograd.is_training())
        recording = autograd.is_recording()
        key = (train, recording, tuple(
            (tuple(t.shape), t.dtype, t.device, t.requires_grad)
            for t in tensors))

        def build(owner=None):
            return _GraphProgram(self._fn, inputs, self._n_state, train,
                                 recording, owner=owner)

        pool = self._cache.get_or_build(key, lambda: _Pool(build))
        prog, generation = pool.take(recording)
        if recording:
            for a in inputs:
                autograd._note_input(a)
            outs = _Replay.apply(_Held(pool, prog, generation), *tensors)
        else:
            outs = prog.forward(tensors)
        out_nds = [NDArray(o) for o in outs]
        return out_nds[0] if len(out_nds) == 1 else out_nds


def _graphed(tensor):
    """Whether a call on ``tensor`` replays captured graphs (a CUDA
    tensor) or runs the function eagerly."""
    return tensor.is_cuda


class _Pool:
    """The captured instances of one signature. A recorded call holds its
    instance until its backward has run or its autograd node is
    released; an instance nobody holds serves the next call."""

    def __init__(self, build):
        self._build = build
        # reentrant: a hold released by the collector inside `take`
        self._lock = threading.RLock()
        self.instances = [build()]  # counted by the cache's build

    def take(self, recording):
        """An instance for one call and the generation that the call
        writes into it: a free one, else a new capture. A recorded call
        holds it until `release`."""
        with self._lock:
            prog = next((p for p in self.instances if not p.held), None)
            if prog is not None:
                return self._hold(prog, recording)
        prog = self._build(owner=self)
        with self._lock:
            self.instances.append(prog)
            return self._hold(prog, recording)

    @staticmethod
    def _hold(prog, recording):
        prog.generation += 1
        prog.held = recording
        return prog, prog.generation

    def release(self, prog, generation):
        """Free ``prog`` if the call of ``generation`` still holds it."""
        with self._lock:
            if prog.generation == generation:
                prog.held = False


class _Held:
    """One recorded call's hold on its instance, kept on the autograd
    node's context: when the node is released without a backward, so is
    the instance."""

    __slots__ = ("pool", "prog", "generation")

    def __init__(self, pool, prog, generation):
        self.pool, self.prog, self.generation = pool, prog, generation

    def __del__(self):
        self.pool.release(self.prog, self.generation)


class _Replay(torch.autograd.Function):
    """One node of the autograd graph for one replay of an instance."""

    @staticmethod
    def forward(ctx, held, *tensors):
        prog = held.prog
        outs = prog.forward(tensors)
        ctx.held = held
        ctx.mark_non_differentiable(*[
            o for i, o in enumerate(outs) if i not in prog.diff_outs])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        held = ctx.held
        grads = held.prog.backward(held.generation, cts)
        held.pool.release(held.prog, held.generation)
        return (None,) + grads


class _GraphProgram:
    """The forward (and under recording the backward) of ``fn`` at one
    signature, captured as CUDA graphs from ``inputs``: one instance of a
    `_Pool`. ``generation`` counts the calls that took it and ``held``
    says whether a recorded call's backward is still to come."""

    def __init__(self, fn, inputs, n_state, train, recording, owner=None):
        self.fn, self.train, self.recording = fn, train, recording
        self.generation = 0
        self.held = False
        tensors = [a._data for a in inputs]
        self.device = tensors[0].device
        self.n_state = n_state
        # state inputs are read where they lie (through aliases, so the
        # capture's autograd nodes are not the parameters'); other inputs
        # get buffers
        self.static_ins = [
            (t.detach() if i < n_state else t.detach().clone())
            .requires_grad_(t.requires_grad) for i, t in enumerate(tensors)]
        self.pool = torch.cuda.graph_pool_handle()
        self.gen = _random.generator(self.device)
        with capture_stream(self.device, owner) as stream:
            self.mutated = self._warm_up()
            self.fwd_graph, self.static_outs = capture_on(
                stream, self._run, self.pool, self.gen)
            self.diff_outs = [i for i, o in enumerate(self.static_outs)
                              if o.requires_grad]
            self.diff_ins = [i for i, t in enumerate(self.static_ins)
                             if t.requires_grad]
            self.bwd_graph = None
            if recording and self.diff_outs and self.diff_ins:
                self.static_cts = [torch.empty_like(self.static_outs[i])
                                   for i in self.diff_outs]
                self.bwd_graph, grads = capture_on(
                    stream, lambda: torch.autograd.grad(
                        [self.static_outs[i] for i in self.diff_outs],
                        [self.static_ins[i] for i in self.diff_ins],
                        self.static_cts, allow_unused=True),
                    self.pool, self.gen)
                self.static_grads = dict(zip(self.diff_ins, grads))
        # the capture's autograd graph has served: keep the buffers only
        self.static_outs = tuple(o.detach() for o in self.static_outs)

    def _run(self):
        """``fn`` on the static inputs, with autograd in the caller's state;
        the outputs as a tuple of tensors."""
        from .ndarray.ndarray import NDArray

        with autograd._RecordingStateScope(self.recording, self.train):
            with torch.set_grad_enabled(self.recording):
                outs = self.fn(*[NDArray(t) for t in self.static_ins])
        outs = [outs] if isinstance(outs, NDArray) else list(outs)
        return tuple(o._data for o in outs)

    def _warm_up(self):
        """The eager calls before the capture. Returns the indices of the
        inputs the function writes in place; the state inputs among them
        get their values from before the calls back."""
        saved = {i: t.detach().clone()
                 for i, t in enumerate(self.static_ins[:self.n_state])
                 if not t.requires_grad}
        versions = [t._version for t in self.static_ins]
        for _ in range(WARMUP_CALLS):
            outs = self._run()
            if self.recording:
                diff = [o for o in outs if o.requires_grad]
                ins = [t for t in self.static_ins if t.requires_grad]
                if diff and ins:
                    torch.autograd.grad(diff, ins,
                                        [torch.ones_like(o) for o in diff],
                                        allow_unused=True)
        mutated = {i for i, t in enumerate(self.static_ins)
                   if t._version != versions[i]}
        with torch.no_grad():
            for i in mutated:
                if i >= self.n_state:
                    continue  # a buffer of ours: each call copies it in
                if i not in saved:
                    raise MXNetError(
                        f"CachedOp: input {i} requires grad and is written "
                        "in place by the function; it cannot be captured")
                self.static_ins[i].copy_(saved[i])
        return mutated

    def forward(self, tensors):
        """Copy the inputs in, replay, return copies of the outputs."""
        moved = []
        with torch.no_grad():
            for i, (t, s) in enumerate(zip(tensors, self.static_ins)):
                if i < self.n_state and t.data_ptr() == s.data_ptr() \
                        and t.stride() == s.stride():
                    continue
                s.copy_(t)
                if i in self.mutated:
                    moved.append((t, s))
            self.fwd_graph.replay()
            for t, s in moved:
                t.copy_(s)
            outs = [o.detach().clone() for o in self.static_outs]
        return outs

    def backward(self, generation, cts):
        """Replay the backward graph with the cotangents ``cts`` (one per
        output); the gradients of the inputs, aliases of the graph's
        buffers, which the next replay overwrites."""
        if generation != self.generation:
            raise MXNetError(
                "the backward of a hybridized block's call ran after its "
                "instance served a later call (a second backward of a "
                "graph whose first one freed it)")
        if self.bwd_graph is None:
            return (None,) * len(self.static_ins)
        with torch.no_grad():
            for buf, i in zip(self.static_cts, self.diff_outs):
                if cts[i] is None:
                    buf.zero_()
                else:
                    buf.copy_(cts[i])
            self.bwd_graph.replay()
        return tuple(
            None if self.static_grads.get(i) is None
            else self.static_grads[i].detach()
            for i in range(len(self.static_ins)))
