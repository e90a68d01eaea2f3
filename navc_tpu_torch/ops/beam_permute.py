"""Beam-ancestry permute of the AR beam search's K/V caches (K8).

Port of navc_tpu/ops/beam_permute.py. After each beam step the caches
follow the beams' ancestry (reference models/Translator.py:120-127): output
row ``i*k + j`` is input row ``i*k + prev_k[i, j]``, whole rows, for both
caches. The JAX package does it with a one-hot MXU matmul; the CUDA kernel
(csrc/beam_permute.cu) is a row gather with 16-byte copies and takes any
batch size.

The wrapper launches the kernel for CUDA tensors and raises if the build or
the launch fails; only for CPU tensors does it run the plain version beside
it (an index_select, which is what ``take_along_axis`` over the beam axis
computes).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {"navc_permute_beam_caches": [ctypes.c_void_p] * 5
               + [ctypes.c_int] * 3 + [ctypes.c_void_p]}


def ancestor_rows(prev_k: torch.Tensor) -> torch.Tensor:
    """(b, k) ancestor slots -> (b*k,) int64 source row of every output row."""
    b, k = prev_k.shape
    base = torch.arange(b, device=prev_k.device)[:, None] * k
    return (base + prev_k.to(torch.int64)).reshape(b * k)


def permute_beam_caches_plain(kc: torch.Tensor, vc: torch.Tensor,
                              prev_k: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``permute_beam_caches``."""
    src = ancestor_rows(prev_k)
    return kc.index_select(0, src), vc.index_select(0, src)


def permute_beam_caches(kc: torch.Tensor, vc: torch.Tensor,
                        prev_k: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kc, vc) rows reordered by beam ancestry, into new tensors.

    kc, vc: (b*k, ...) caches of one shape and dtype, contiguous, each row a
    multiple of 16 bytes; prev_k: (b, k) int32 ancestor slots in [0, k).
    """
    if kc.device.type == "cpu":
        return permute_beam_caches_plain(kc, vc, prev_k)
    if kc.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % kc.device)
    if (kc.shape != vc.shape or kc.dtype != vc.dtype or prev_k.dim() != 2
            or prev_k.dtype != torch.int32 or kc.shape[0] != prev_k.numel()):
        raise ValueError("kc, vc (b*k, ...) of one shape and dtype and prev_k "
                         "(b, k) int32 expected")
    for t in (kc, vc, prev_k):
        if t.device != kc.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on %s" % kc.device)
    n = kc.shape[0]
    row_bytes = kc[0].numel() * kc.element_size() if n else 0
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in (kc, vc)):
        raise ValueError("cache rows must be 16-byte multiples on 16-byte "
                         "aligned storage, got rows of %d bytes" % row_bytes)
    okc, ovc = torch.empty_like(kc), torch.empty_like(vc)
    if n == 0 or row_bytes == 0:
        return okc, ovc
    lib = _build.load("beam_permute", _SIGNATURES)
    code = lib.navc_permute_beam_caches(
        ctypes.c_void_p(kc.data_ptr()), ctypes.c_void_p(vc.data_ptr()),
        ctypes.c_void_p(prev_k.data_ptr()), ctypes.c_void_p(okc.data_ptr()),
        ctypes.c_void_p(ovc.data_ptr()), n, prev_k.shape[1], row_bytes,
        ctypes.c_void_p(torch.cuda.current_stream(kc.device).cuda_stream))
    _build.check(lib, code, "permute_beam_caches")
    _build.LAUNCHES.count("permute_beam_caches")
    return okc, ovc
