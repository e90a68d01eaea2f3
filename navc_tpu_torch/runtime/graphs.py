"""CUDA graphs: the port's counterpart of navc_tpu's ``jax.jit``.

navc_tpu runs its encode and each generator as one compiled XLA program per
input signature. ``Jitted(fn)`` captures a function of tensors as a CUDA graph
per signature and replays it for every later call with that signature, so
a decode costs the host one graph launch instead of the hundreds of
PyTorch ops and kernel launches that issue it eagerly.

The signature (``signature``) is the nesting of the arguments (dicts,
lists, tuples), the shape, dtype and device of each tensor among them, and
the value of every other one (so they must be hashable; None marks an
optional argument left out). The first call with a signature

1. copies its tensor arguments into static buffers, the graph's inputs;
2. runs the function once eagerly on a side stream (``warm_up``): the
   kernels' one-time host calls (``cudaFuncSetAttribute``) and cuBLAS's
   handle and workspace are made outside the capture, and this run's
   outputs are the call's result;
3. captures it with ``torch.cuda.graph`` from a memory pool of its own
   (``Graph``): its outputs, and the scratch the kernel wrappers allocate
   (with the tensor maps encoded from its addresses), live in the pool and
   keep their addresses across replays.

Every later call copies its tensor arguments into the static buffers,
replays, and returns clones of the outputs: the next replay overwrites the
graph's own, and a caller may still hold them (``StreamingCaptioner`` keeps
two requests in flight; ``run_eval`` reads the encode's outputs after the
decode), where a ``jax.Array`` navc_tpu returns is the caller's.

The kernel wrappers count their launches in ``_build.LAUNCHES`` as they
queue them; a capture's counts are kept with its graph and added by each
replay, so a call counts the launches of one decode whether it warmed up
and captured or replayed.

A training step (``runtime/train_step.py``, navc_tpu's jitted
``make_train_step``) is a function that updates state in place: the
parameters, their ``.grad``, the optimizer's state and lr, the BatchNorm
running statistics. The graph reads and writes them by address, so they
must keep their addresses for the graph's life (``zero_grad(set_to_none=
False)``; an optimizer's ``load_state_dict`` replaces its state, and the
step drops its graphs then), and only the returned metrics are cloned. The
rule that keeps a step from being applied twice: the first call of a
signature is one real step, the warm-up, and the capture after it only
records (nothing runs while a stream captures); every later call is one
replay. Random draws from a generator other than the default one need it
registered with the capture (``generators``): a replay then draws from the
generator's seed and offset at that moment, so reseeding it before each call
gives each replay the masks an eager step seeded alike draws. With
``static_inputs`` the caller's tensors are the graph's inputs themselves
(the train step stages each batch straight into them from page-locked
memory, ``PinnedSlots``): nothing is copied, and every call must pass the
tensors the capture read.

On CPU tensors the function runs as it is, as ``jax.jit`` on the CPU gives
the same numbers. A capture or a replay that fails raises: nothing retries
eagerly.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build


def _flatten(x, leaves: list):
    """x's nesting as a hashable spec; its leaves appended to ``leaves``."""
    if type(x) is dict:
        return (dict, tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    if type(x) in (list, tuple):
        return (type(x), len(x), tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _unflatten(spec, leaves):
    """The inverse of ``_flatten``; ``leaves`` an iterator."""
    if spec is None:
        return next(leaves)
    kind, names, parts = spec
    if kind is dict:
        return {k: _unflatten(p, leaves) for k, p in zip(names, parts)}
    return kind(_unflatten(p, leaves) for p in parts)


def signature(args) -> Tuple[Hashable, list]:
    """(key, leaves) of a call's arguments: the key holds their nesting,
    each tensor's shape, dtype and device, and every other leaf's value."""
    leaves: list = []
    spec = _flatten(args, leaves)
    return (spec, tuple((tuple(x.shape), x.dtype, x.device)
                        if isinstance(x, torch.Tensor) else x for x in leaves)), leaves


def on_cuda(leaves) -> bool:
    """Whether a call's tensors lie on the card (all of them) or not (none);
    raises on a mix."""
    kinds = {x.device.type == "cuda" for x in leaves if isinstance(x, torch.Tensor)}
    if len(kinds) > 1:
        raise ValueError("arguments on the card and off it in one call")
    return kinds == {True}


def clone_tensors(x):
    """x with every tensor in it cloned."""
    leaves: list = []
    spec = _flatten(x, leaves)
    return _unflatten(spec, iter([t.clone() if isinstance(t, torch.Tensor) else t
                                  for t in leaves]))


@contextlib.contextmanager
def collector_off():
    """The cycle collector off for captures, after one collection: a graph
    it freed inside a capture (it may run at any allocation; a beam
    generator, which counts its steps on itself, is such a cycle) would be
    destroyed while the stream captures, which CUDA refuses and which
    spoils the capture. Nested uses collect once."""
    if not gc.isenabled():
        yield
        return
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def warm_up(fn: Callable[[], Any]):
    """``fn()``, run on a side stream ordered after the current stream's
    work and before its next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class Graph:
    """One captured call of ``fn()`` from ``pool``: its graph, its outputs
    (in the pool), the launches a replay makes ({wrapper: count}), the
    seconds the capture took and the bytes it added to the pool.
    ``generators``: the device generators other than the default one that
    ``fn`` draws from, registered with the capture."""

    def __init__(self, fn: Callable[[], Any], pool,
                 generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with collector_off():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            with _build.capture_launches() as self.launches:
                # thread_local: a loader's producer thread (data/loader.py)
                # may run beside the capture
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self.outputs = fn()
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved() - held

    def replay(self):
        """Queue the graph on the current stream; its outputs."""
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.outputs


class Captured:
    """``fn`` captured for one signature: the static input buffers (the
    call's own tensors with ``static_inputs``) and the graph that reads
    them; ``first``, the warm-up's outputs, is the first call's result."""

    def __init__(self, fn: Callable, spec, leaves: List[Any],
                 generators: Sequence[torch.Generator] = (), static_inputs: bool = False):
        self.static_inputs = static_inputs
        self.static = [x.clone() if isinstance(x, torch.Tensor) and not static_inputs
                       else x for x in leaves]

        def call():
            args, kwargs = _unflatten(spec, iter(self.static))
            return fn(*args, **kwargs)

        self.first = warm_up(call)
        self.graph = Graph(call, torch.cuda.graph_pool_handle(), generators)

    def __call__(self, leaves: List[Any]):
        for buf, x in zip(self.static, leaves):
            if not isinstance(buf, torch.Tensor):
                continue
            if not self.static_inputs:
                buf.copy_(x)
            elif x is not buf:
                raise ValueError("static inputs: a call must pass the tensors the "
                                 "capture read")
        return clone_tensors(self.graph.replay())


class Jitted:
    """``fn`` captured and replayed per signature on the card, run as it is
    on the CPU. ``graphs`` maps each signature to its ``Captured`` (capture
    seconds and pool bytes in ``.graph``); clearing it drops them.
    ``generators`` and ``static_inputs``: see the module docstring."""

    graphed = True  # calls on the card replay graphs

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator] = (),
                 static_inputs: bool = False):
        self.fn = fn
        self.generators = tuple(generators)
        self.static_inputs = static_inputs
        self.graphs: Dict[Hashable, Captured] = {}

    def __call__(self, *args, **kwargs):
        key, leaves = signature((args, kwargs))
        if not on_cuda(leaves):
            return self.fn(*args, **kwargs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = Captured(self.fn, key[0], leaves, self.generators, self.static_inputs)
            self.graphs[key] = entry
            first, entry.first = entry.first, None
            return first
        return entry(leaves)


class PinnedSlots:
    """Page-locked host buffers for the calls in flight, one set per slot:
    call i's arrays go through slot i % n, whose copy to the card is
    asynchronous; the host waits for the slot's previous copy (its event)
    before it overwrites the buffers."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.next = 0

    def to_device(self, arrays: List[np.ndarray], device,
                  out: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
        """The arrays on ``device``: copied into ``out`` (tensors of their
        shapes and dtypes there, e.g. a graph's static inputs) when given,
        else into new tensors."""
        i = self.next
        self.next = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or [(b.shape, b.numpy().dtype) for b in slot[0]] != [
                (a.shape, a.dtype) for a in arrays]:
            bufs = [torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                                pin_memory=True) for a in arrays]
        else:
            bufs = slot[0]
        for buf, a in zip(bufs, arrays):  # torch's copy runs on the intra-op threads
            buf.copy_(torch.from_numpy(a))
        if out:
            res = [o.copy_(buf, non_blocking=True) for o, buf in zip(out, bufs)]
        else:
            res = [buf.to(device, non_blocking=True) for buf in bufs]
        event = torch.cuda.Event()
        event.record()
        self.slots[i] = (bufs, event)
        return res
