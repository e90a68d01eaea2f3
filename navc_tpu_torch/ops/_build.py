"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``navc_tpu_torch/build/<name>-<hash>.so``, at first use; the hash
covers the source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one is reused. The library has a plain C interface
and is loaded with ``ctypes``: pointers and the stream go in as
``c_void_p``, and every entry returns ``cudaGetLastError()`` after its
launch, which ``check`` turns into an exception. ``build`` starts one
``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches by wrapper name. A wrapper adds one
(``LAUNCHES.count``) where it launches its kernel and nowhere else, so a
run can show that the main path went through the kernels. While a CUDA
graph is captured (``runtime/graphs.py``) the wrappers queue launches that
do not run:
``capture_launches`` takes their counts back out and keeps them with the
graph, and every replay adds them (``add_launches``), so the counts stay
launches per decode. The launches of a body under one of a graph's IF
nodes (``graphs.when``) run only when its predicate holds: a replay of such
a graph leaves a settle function behind (``LAUNCHES.defer``) that adds
them times the runs its device counters counted, and every read of
``LAUNCHES`` settles first (``Launches``); counting does not, so a launch
queued behind a replay does not wait for it.

``graph_cond`` is no kernel of the decode: it adds those IF nodes to a
capture (``runtime/graphs.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("vocab_fused", "fused_layer", "beam_attend", "beam_permute",
           "fused_layer_train", "vocab_ce", "graph_cond", "swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Launches(dict):
    """{wrapper: launches}. A replay whose counts are known only once the
    card has run it leaves ``defer(key, settle)``: ``settle()`` waits for
    the replay (its event) and returns {wrapper: launches} to add; a later
    deferral under the same key replaces the earlier one (its counts are
    cumulative). Every read (an item, ``get``, iteration, ``keys``,
    ``values``, ``items``, hence ``dict(LAUNCHES)``) settles what is
    pending first, so a caller that has read the decode's outputs waits for
    nothing more."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending: Dict[object, Callable[[], Dict[str, int]]] = {}

    def defer(self, key, settle: Callable[[], Dict[str, int]]) -> None:
        self._pending[key] = settle

    def settle(self) -> None:
        while self._pending:
            self.add(self._pending.popitem()[1]())

    def add(self, counts: Dict[str, int]) -> None:
        """Add counts without settling (a replay must not wait for another)."""
        for key, n in counts.items():
            self.count(key, n)

    def count(self, key: str, n: int = 1) -> None:
        """A wrapper's launch, counted without settling: a launch queued
        behind a replay must not wait for it."""
        dict.__setitem__(self, key, dict.__getitem__(self, key) + n)

    def __getitem__(self, key):
        self.settle()
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        self.settle()
        return dict.get(self, key, default)

    def __iter__(self):
        self.settle()
        return dict.__iter__(self)

    def keys(self):
        self.settle()
        return dict.keys(self)

    def values(self):
        self.settle()
        return dict.values(self)

    def items(self):
        self.settle()
        return dict.items(self)


LAUNCHES = Launches({"fused_layer": 0, "fused_layer_qsub": 0,
                     "fused_layer_unfolded": 0,
                     "project_argmax": 0, "project_gather_prob": 0,
                     "project_topk": 0, "beam_attend_step": 0,
                     "cross_attend": 0, "permute_beam_caches": 0,
                     "train_fwd": 0, "train_ffn_bwd": 0,
                     "train_attn_bwd": 0, "train_wgrad": 0,
                     "ce_fwd": 0, "ce_bwd_dh": 0, "ce_bwd_dw": 0, "swiglu": 0})

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@contextlib.contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph's capture: yields a dict that, once the block
    ends, holds {wrapper: launches} the capture counted, and leaves
    ``LAUNCHES`` as it was before the block."""
    before = dict(LAUNCHES)
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        for key, n in before.items():
            if LAUNCHES[key] != n:
                counts[key] = LAUNCHES[key] - n
            LAUNCHES[key] = n


def add_launches(counts: Dict[str, int]) -> None:
    """A replay of a graph launches what its capture counted."""
    LAUNCHES.add(counts)


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build(names: Iterable[str] = SOURCES) -> Dict[str, Optional[str]]:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together. Returns {name: compiler log, or None when
    the library was already there}; raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs: Dict[str, Optional[str]] = {name: None for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (name, proc.returncode, log))
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry the caller uses to its argument types
    (set on every call: callers of one library may name different entries);
    every entry returns an int (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.navc_error_string.argtypes = [ctypes.c_int]
            lib.navc_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, code, lib.navc_error_string(code).decode()))
