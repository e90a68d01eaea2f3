"""ctypes binding of the native caption-metric library.

Port of navc_tpu/native/lib.py over the port's own copy of its sources
(``metrics.cpp``, ``porter.h``, byte for byte navc_tpu's). The library is
compiled at first use with the host's C++ compiler (``$CXX``, else ``g++``,
else ``c++``) and navc_tpu's Makefile flags into
``navc_tpu_torch/build/libnavc_metrics-<hash>.so``; the hash covers the
sources, the compiler and the flags, so an edited source rebuilds and an
unchanged one is reused. Builds are serialised across processes by a file
lock beside the library.

Unlike navc_tpu, nothing falls back: a failed build or load raises. Only
navc_tpu's per-call ASCII rule chooses Python: the C++ pipeline is
byte-wise (ASCII ``tolower`` / ``isalnum``), so a string, or a corpus, that
is not ASCII goes to the Python implementation, as in navc_tpu.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("metrics.cpp", "porter.h")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")  # navc_tpu/native/Makefile

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler() -> str:
    """``$CXX``, else ``g++`` on PATH, else ``c++``."""
    for cand in (os.environ.get("CXX", ""), shutil.which("g++") or "",
                 shutil.which("c++") or ""):
        if cand:
            return cand
    raise RuntimeError("no C++ compiler found: the native metrics cannot be built")


def library_path(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libnavc_metrics-%s.so" % h.hexdigest()[:16])


def build() -> str:
    """The library's path, compiled first if it is not there (under a lock
    that other processes building it wait on). Raises if the compile
    fails."""
    cxx = compiler()
    out = library_path(cxx)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                tmp = "%s.%d.tmp" % (out, os.getpid())
                try:
                    proc = subprocess.run(
                        [cxx, *CXX_FLAGS, "-o", tmp, os.path.join(_HERE, "metrics.cpp")],
                        capture_output=True, text=True, timeout=300)
                except OSError as e:
                    raise RuntimeError("native metrics build: %s" % e) from e
                if proc.returncode != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    raise RuntimeError("native metrics build failed (%s exit %d):\n%s"
                                       % (cxx, proc.returncode, proc.stderr))
                os.replace(tmp, out)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.navc_tokenize.restype = ctypes.c_void_p
            lib.navc_tokenize.argtypes = [ctypes.c_char_p]
            corpus_args = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                           ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int)]
            for fn in ("navc_bleu_corpus", "navc_cider_corpus", "navc_rouge_corpus",
                       "navc_meteor_corpus"):
                getattr(lib, fn).restype = ctypes.c_void_p
                getattr(lib, fn).argtypes = corpus_args
            lib.navc_porter_stem.restype = ctypes.c_void_p
            lib.navc_porter_stem.argtypes = [ctypes.c_char_p]
            lib.navc_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def available() -> bool:
    """navc_tpu's probe: True once the library is built and loaded (here a
    failure raises instead of answering False)."""
    return get_lib() is not None


def _all_ascii(*corpora: Dict[str, List[str]]) -> bool:
    return all(s.isascii() for corpus in corpora for caps in corpus.values() for s in caps)


def _take_string(lib, ptr) -> str:
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode("utf-8")
    finally:
        lib.navc_free(ptr)


def tokenize(text: str) -> List[str]:
    """One caption through the C++ PTB tokenizer; a string that is not
    ASCII through the Python one (the C++ pipeline would keep an
    upper-case 'É' and break the contraction guards on UTF-8 bytes)."""
    if not text.isascii():
        from ..metrics.tokenizer import ptb_tokenize
        return ptb_tokenize(text)
    lib = get_lib()
    out = _take_string(lib, lib.navc_tokenize(text.encode("utf-8")))
    return out.split() if out else []


def _pack_corpus(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]):
    vids = list(hyps.keys())
    hyp_arr = (ctypes.c_char_p * len(vids))(*[hyps[v][0].encode("utf-8") for v in vids])
    flat_refs: List[bytes] = []
    offsets = [0]
    for v in vids:
        flat_refs.extend(r.encode("utf-8") for r in refs[v])
        offsets.append(len(flat_refs))
    ref_arr = (ctypes.c_char_p * len(flat_refs))(*flat_refs)
    off_arr = (ctypes.c_int * len(offsets))(*offsets)
    return vids, hyp_arr, ref_arr, off_arr


def _corpus_call(fn_name: str, hyps, refs):
    lib = get_lib()
    vids, hyp_arr, ref_arr, off_arr = _pack_corpus(hyps, refs)
    return json.loads(_take_string(lib, getattr(lib, fn_name)(hyp_arr, len(vids), ref_arr,
                                                              off_arr)))


def bleu_corpus(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]) -> List[float]:
    """Corpus BLEU-1..4 (the Python path for a corpus that is not ASCII)."""
    if not _all_ascii(hyps, refs):
        from ..metrics.bleu import corpus_bleu
        return list(corpus_bleu(hyps, refs)[0])
    return _corpus_call("navc_bleu_corpus", hyps, refs)


def _score_and_per_image(fn_name: str, python, hyps, refs) -> Tuple[float, List[float]]:
    if not _all_ascii(hyps, refs):
        return python(hyps, refs)
    arr = _corpus_call(fn_name, hyps, refs)
    return arr[0], arr[1:]


def cider_corpus(hyps, refs) -> Tuple[float, List[float]]:
    from ..metrics.cider import corpus_cider
    return _score_and_per_image("navc_cider_corpus", corpus_cider, hyps, refs)


def rouge_corpus(hyps, refs) -> Tuple[float, List[float]]:
    from ..metrics.rouge import corpus_rouge_l
    return _score_and_per_image("navc_rouge_corpus", corpus_rouge_l, hyps, refs)


def meteor_corpus(hyps, refs) -> Tuple[float, List[float]]:
    """The legacy two-stage METEOR (``NAVC_METEOR_LEGACY``)."""
    from ..metrics.meteor import corpus_meteor
    return _score_and_per_image("navc_meteor_corpus", corpus_meteor, hyps, refs)


def porter_stem(word: str) -> str:
    lib = get_lib()
    return _take_string(lib, lib.navc_porter_stem(word.encode("utf-8")))
