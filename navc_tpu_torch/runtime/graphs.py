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

Data-dependent control flow stays on the card, as XLA keeps navc_tpu's
``lax.cond`` and ``lax.while_loop`` there. ``when(pred, body, carry)`` is
``lax.cond(pred, body, identity, *carry)``: inside a capture it records
``body`` under a CUDA graph IF node on the 0-d bool ``pred``
(csrc/graph_cond.cu; PyTorch 2.11's CUDAGraph has none), so a replay skips
the body's kernels where ``pred`` is false; outside one (the warm-up, the
CPU) it runs the body and merges, ``torch.where(pred, new, old)``, which
gives the same bits. A body under an IF node adds one to a device counter
each time it runs; a replay copies the graph's counters to pinned memory
behind an event and leaves their settling to ``_build.LAUNCHES``, which
adds each body's launches times its runs when it is next read. So the
launches of a replay are those that ran; an eager run (the first call's
warm-up included) counts every body, as every body then launches.
A loop whose end the card decides (the beam search, ef's reveal rounds) is
a ``Loop``: a head, blocks and a tail. ``JittedLoop`` captures each phase
as a graph (``LoopGraphs``) and replays the blocks under the lagged stop
rule (``lagged_blocks``: block j's flag is read only after block j + 1 is
queued); on the CPU ``run_loop`` runs the phases eagerly under the same
rule.

On CPU tensors the function runs as it is, as ``jax.jit`` on the CPU gives
the same numbers. A capture or a replay that fails raises: nothing retries
eagerly.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
import weakref
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..ops import _build
from . import summary


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


_CAPTURING: List["Graph"] = []  # the graph whose capture is under way


def _cond_lib():
    return _build.load("graph_cond", {
        "navc_cond_begin": [ctypes.c_void_p] * 3, "navc_cond_end": [ctypes.c_void_p],
        "navc_stream_create": [ctypes.c_void_p]})


_BODY_STREAMS: Dict[int, torch.cuda.ExternalStream] = {}


def _body_stream(device: int) -> torch.cuda.ExternalStream:
    """The stream IF-node bodies capture on, one per device for the
    process, made by CUDA: PyTorch's pool hands its 32 streams out round
    robin, so one taken from it is, now and then, the stream the graph
    captures on, where the body's capture cannot begin."""
    if device not in _BODY_STREAMS:
        lib, raw = _cond_lib(), ctypes.c_void_p()
        with torch.cuda.device(device):
            _build.check(lib, lib.navc_stream_create(ctypes.byref(raw)), "stream_create")
        _BODY_STREAMS[device] = torch.cuda.ExternalStream(raw.value, device=device)
    return _BODY_STREAMS[device]


def when(pred: torch.Tensor, body: Callable[..., Sequence[torch.Tensor]],
         carry: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``body(*carry)`` where the 0-d bool ``pred`` holds, else ``carry``
    (navc_tpu's ``lax.cond(pred, body, identity, *carry)``): under a
    capture an IF node that a replay skips; else the body run and merged
    with ``torch.where``. ``body`` returns tensors shaped as ``carry``."""
    if _CAPTURING:
        return _CAPTURING[-1].conditional(pred, body, carry)
    return tuple(torch.where(pred, new, old) for new, old in zip(body(*carry), carry))


def flag_reader(done: torch.Tensor, flags: Optional[torch.Tensor], j: int
                ) -> Callable[[], bool]:
    """A reader of the 0-d bool ``done``: on the card copied now to the
    pinned ``flags[j]`` behind an event, which the reader waits for; on the
    CPU (``flags`` None) read at once."""
    if flags is None:
        value = bool(done)
        return lambda: value
    flags[j:j + 1].copy_(done.reshape(1), non_blocking=True)
    event = torch.cuda.Event()
    event.record()

    def read():
        with summary.span("navc.decode.flag_wait"):
            event.synchronize()
            return bool(flags[j])
    return read


class Loop:
    """A loop whose end the card decides, in phases that share its tensors:
    ``head()`` sets up the carry; ``block(j)`` runs block j and returns the
    0-d bool that says the loop's work is done; ``tail()`` returns the
    outputs from the carry the last block left. ``n_blocks`` (set by
    ``head()`` at the latest): the most blocks a call runs.
    ``same_blocks``: every block runs the same code on a carry it rewrites
    in place, so one graph serves them all; else a graph each, captured in
    order and replayed as a prefix of that order. ``open_ended``: the
    loop's flag must say done within ``n_blocks`` blocks (else an error);
    else the loop simply ends with its last block."""

    n_blocks: int
    same_blocks = False
    open_ended = False

    def head(self) -> None:
        raise NotImplementedError

    def block(self, j: int) -> torch.Tensor:
        raise NotImplementedError

    def tail(self) -> Any:
        raise NotImplementedError


def lagged_blocks(queue_block: Callable[[int], torch.Tensor], n: int,
                  flags: Optional[torch.Tensor], open_ended: bool) -> Tuple[int, int]:
    """The blocked stop rule, on every device: at most ``n`` blocks
    ``queue_block(j)``, which queues block j and returns its done flag
    (read through the pinned ``flags`` on the card, at once for None).
    Block j's flag is read only after block j + 1 has been queued, and the
    loop stops after block j + 1 when it says the work was done (the card
    then has block j + 1 queued while the host waits; blocks after that
    change nothing). Returns (blocks run, flag reads); with
    ``open_ended``, raises if ``n`` blocks ran with the loop still going."""
    reads, pending = 0, None
    for j in range(n):
        read = flag_reader(queue_block(j), flags, j)
        if pending is not None:
            reads += 1
            if pending():
                return j + 1, reads
        pending = read
    if open_ended:
        reads += 1
        if not pending():
            raise RuntimeError("the loop did not stop within %d blocks" % n)
    return n, reads


def run_loop(loop: Loop, pinned: bool = False) -> Tuple[Any, int, int]:
    """``loop`` run eagerly: (the tail's outputs, blocks run, flag reads);
    ``pinned``: the flags go through page-locked memory (on the card)."""
    loop.head()
    flags = torch.zeros(loop.n_blocks, dtype=torch.bool, pin_memory=True) if pinned else None
    blocks, reads = lagged_blocks(loop.block, loop.n_blocks, flags, loop.open_ended)
    return loop.tail(), blocks, reads


class BodyRuns:
    """The runs of a graph's IF-node bodies: each body's launches, its run
    count as a replay copied it to pinned memory (cumulative: the device
    counters are never reset) and as last settled. Kept apart from the
    graph, so a pending settling holds no graph or pool alive."""

    def __init__(self, launches: List[Dict[str, int]]):
        self.launches = launches
        self.seen = [0] * len(launches)
        self.host = torch.zeros(len(launches), dtype=torch.int32, pin_memory=True)

    def settle(self, event) -> Dict[str, int]:
        """The launches of the bodies that ran since the last settling,
        once ``event`` (after the replay's copy) has passed."""
        event.synchronize()
        ran = self.host.tolist()
        counts: Dict[str, int] = {}
        for launches, now, seen in zip(self.launches, ran, self.seen):
            for key, n in launches.items():
                counts[key] = counts.get(key, 0) + (now - seen) * n
        self.seen = ran
        return counts


class Graph:
    """One captured call of ``fn()`` from ``pool``: its graph, its outputs
    (in the pool), the launches a replay makes ({wrapper: count}) and the
    seconds the capture took (the span ``navc.capture`` while a profile
    records: one inside a serving window is a recapture).
    ``generators``: the device generators other than the default one that
    ``fn`` draws from, registered with the capture. ``regions`` holds each
    IF node's (device counter of its body's runs, the body's launches);
    ``runs`` (a ``BodyRuns``) settles them after a replay."""

    def __init__(self, fn: Callable[[], Any], pool,
                 generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        self.regions: List[Tuple[torch.Tensor, Dict[str, int]]] = []
        self._body = None  # the bodies' stream and pool, made at the first IF node
        _body_stream(torch.cuda.current_device())  # made before any capture begins
        with collector_off(), summary.span("navc.capture"):
            _build.LAUNCHES.settle()  # no wait for a replay inside the capture
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with _build.capture_launches() as self.launches:
                # thread_local: a loader's producer thread (data/loader.py)
                # may run beside the capture
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    _CAPTURING.append(self)
                    try:
                        self.outputs = fn()
                    finally:
                        _CAPTURING.pop()
                        if self._body is not None:
                            torch._C._cuda_endAllocateToPool(*self._body[1:])
                    if self.regions:  # the counters' totals, at the replay's end
                        self.ran = torch.stack([c for c, _ in self.regions])
            self.capture_s = time.perf_counter() - t0
        if self.regions:
            for counter, _ in self.regions:
                counter.zero_()
            self.runs = BodyRuns([launches for _, launches in self.regions])

    def conditional(self, pred: torch.Tensor, body, carry):
        """``when`` inside this graph's capture: the carry copied, then
        ``body`` captured into an IF node on ``pred`` on a stream of its
        own (allocating from a pool that lives as long as this graph),
        writing its results over the copies and counting its run."""
        if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
            raise ValueError("when: the predicate must be a one-element bool on the card")
        if self._body is None:
            # the body's stream captures into a graph of its own, whose
            # allocations the capture's pool does not take: this thread's
            # go to a pool of the bodies, which lives as long as the graph
            stream, pool = _body_stream(pred.device.index), torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateCurrentThreadToPool(stream.device.index, pool)
            weakref.finalize(self, torch._C._cuda_releasePool, stream.device.index, pool)
            self._body = (stream, stream.device.index, pool)
        stream = self._body[0]
        out = tuple(c.clone() for c in carry)
        counter = torch.empty((), dtype=torch.int32, device=pred.device)
        lib = _cond_lib()
        _build.check(lib, lib.navc_cond_begin(
            ctypes.c_void_p(pred.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
            ctypes.c_void_p(stream.cuda_stream)), "cond_begin")
        try:
            with torch.cuda.stream(stream), _build.capture_launches() as counts:
                for o, new in zip(out, body(*carry)):
                    o.copy_(new)
                counter.add_(1)
        finally:
            _build.check(lib, lib.navc_cond_end(ctypes.c_void_p(stream.cuda_stream)),
                         "cond_end")
        self.regions.append((counter, counts))
        return out

    def replay(self):
        """Queue the graph on the current stream; its outputs."""
        self.graph.replay()
        _build.add_launches(self.launches)
        if self.regions:
            self.runs.host.copy_(self.ran, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            _build.LAUNCHES.defer(self.runs, functools.partial(self.runs.settle, event))
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


class LoopGraphs:
    """``make_loop(*args, **kwargs)``'s ``Loop`` captured for one signature:
    static input buffers, then the head, the block(s) and the tail as
    graphs of one pool, captured in that order, so each reads the tensors
    the one before it left (a carry in place, or the previous block's
    outputs). A call replays the head, the blocks as the lagged stop rule
    says (each flag to pinned memory behind an event), then the tail, and
    returns (clones of the tail's outputs, blocks run, flag reads): the
    next call's head overwrites them. ``first``: the first call's result,
    the loop run eagerly on a side stream."""

    def __init__(self, make_loop: Callable[..., Loop], spec, leaves: List[Any]):
        self.static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args, kwargs = _unflatten(spec, iter(self.static))
        self.first = warm_up(lambda: run_loop(make_loop(*args, **kwargs), pinned=True))
        loop = make_loop(*args, **kwargs)
        pool = torch.cuda.graph_pool_handle()
        with collector_off():  # one collection for all the captures
            self.head = Graph(loop.head, pool)
            self.blocks = [Graph(functools.partial(loop.block, j), pool)
                           for j in range(1 if loop.same_blocks else loop.n_blocks)]
            self.tail = Graph(loop.tail, pool)
        self.n_blocks, self.open_ended = loop.n_blocks, loop.open_ended
        self.flags = torch.zeros(self.n_blocks, dtype=torch.bool, pin_memory=True)

    def parts(self) -> List[Graph]:
        return [self.head, *self.blocks, self.tail]

    def __call__(self, leaves: List[Any]):
        for static, x in zip(self.static, leaves):
            if isinstance(static, torch.Tensor):
                static.copy_(x)
        self.head.replay()
        last = len(self.blocks) - 1
        blocks, reads = lagged_blocks(lambda j: self.blocks[min(j, last)].replay(),
                                      self.n_blocks, self.flags, self.open_ended)
        return clone_tensors(self.tail.replay()), blocks, reads


class Jitted:
    """``fn`` captured and replayed per signature on the card, run as it is
    on the CPU. ``graphs`` maps each signature to its ``Captured`` (capture
    seconds in ``.graph``); clearing it drops them.
    ``generators`` and ``static_inputs``: see the module docstring."""

    graphed = True  # calls on the card replay graphs

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator] = (),
                 static_inputs: bool = False):
        self.fn = fn
        self.generators = tuple(generators)
        self.static_inputs = static_inputs
        self.graphs: Dict[Hashable, Any] = {}

    def capture(self, spec, leaves: List[Any]):
        return Captured(self.fn, spec, leaves, self.generators, self.static_inputs)

    def eager(self, args, kwargs):
        return self.fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        key, leaves = signature((args, kwargs))
        if not on_cuda(leaves):
            return self.eager(args, kwargs)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.capture(key[0], leaves)
            self.graphs[key] = entry
            first, entry.first = entry.first, None
            return first
        return entry(leaves)


class JittedLoop(Jitted):
    """``make_loop(*args, **kwargs)`` (a ``Loop``) captured per signature
    on the card (``LoopGraphs``), run by ``run_loop`` on the CPU. A call
    returns (the tail's outputs, blocks run, flag reads)."""

    def capture(self, spec, leaves: List[Any]):
        return LoopGraphs(self.fn, spec, leaves)

    def eager(self, args, kwargs):
        return run_loop(self.fn(*args, **kwargs))


class PinnedSlots:
    """Page-locked host buffers for the calls in flight, one set per slot:
    call i's arrays go through slot i % n, whose copy to the card is
    asynchronous; the host waits for the slot's previous copy (its event)
    before it overwrites the buffers. While a profile records, the wait is
    the span ``navc.stage.slot_wait`` and the copy into the buffers
    ``navc.stage.copy``."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.next = 0

    def to_device(self, arrays: List[np.ndarray], device,
                  out: Sequence[torch.Tensor] = (),
                  start: Optional[torch.cuda.Event] = None) -> List[torch.Tensor]:
        """The arrays on ``device``: copied into ``out`` (tensors of their
        shapes and dtypes there, e.g. a graph's static inputs) when given,
        else into new tensors. ``start``: an event recorded just before the
        copies to the card are queued."""
        i = self.next
        self.next = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None:
            with summary.span("navc.stage.slot_wait"):
                slot[1].synchronize()
        if slot is None or [(b.shape, b.numpy().dtype) for b in slot[0]] != [
                (a.shape, a.dtype) for a in arrays]:
            bufs = [torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                                pin_memory=True) for a in arrays]
        else:
            bufs = slot[0]
        with summary.span("navc.stage.copy"):
            for buf, a in zip(bufs, arrays):  # torch's copy runs on the intra-op threads
                buf.copy_(torch.from_numpy(a))
        if start is not None:
            start.record()
        if out:
            res = [o.copy_(buf, non_blocking=True) for o, buf in zip(out, bufs)]
        else:
            res = [buf.to(device, non_blocking=True) for buf in bufs]
        event = torch.cuda.Event()
        event.record()
        self.slots[i] = (bufs, event)
        return res
