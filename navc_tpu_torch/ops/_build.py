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
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("vocab_fused", "fused_layer", "beam_attend", "beam_permute",
           "fused_layer_train", "vocab_ce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"fused_layer": 0, "fused_layer_qsub": 0,
                            "fused_layer_unfolded": 0,
                            "project_argmax": 0, "project_gather_prob": 0,
                            "project_topk": 0, "beam_attend_step": 0,
                            "cross_attend": 0, "permute_beam_caches": 0,
                            "train_fwd": 0, "train_ffn_bwd": 0,
                            "train_attn_bwd": 0, "train_wgrad": 0,
                            "ce_fwd": 0, "ce_bwd_dh": 0, "ce_bwd_dw": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
