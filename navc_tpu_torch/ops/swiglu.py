"""SwiGLU's activation of the MLAMoE language model's MLPs (K13).

``swiglu(gu, w)`` is ``silu(g) * u * w[:, None]`` of the gate and up halves
of one (rows, 2 * inter) product, ``w`` a routed (token, expert) pair's
weight per row (or None: 1), computed in float32 and rounded once to the
product's type. The CUDA kernel (csrc/swiglu.cu) takes one pass over the
rows; the wrapper launches it for CUDA tensors and raises if the build or
the launch fails, and only for CPU tensors runs the plain version beside
it, which computes the same in PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {"navc_swiglu": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_int, ctypes.c_void_p]}


def swiglu_plain(gu: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``swiglu``."""
    inter = gu.shape[-1] // 2
    act = F.silu(gu[..., :inter].float()) * gu[..., inter:].float()
    if w is not None:
        act = act * w.float()[..., None]
    return act.to(gu.dtype)


def swiglu(gu: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gu (..., 2 * inter) -> (..., inter): silu(gate) * up (* w per row).
    On the card gu is bf16 and contiguous, inter a multiple of 8, w float32
    with one value per row."""
    if gu.device.type == "cpu":
        return swiglu_plain(gu, w)
    if gu.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % gu.device)
    inter = gu.shape[-1] // 2
    rows = gu.numel() // max(1, gu.shape[-1])
    if gu.dtype != torch.bfloat16 or not gu.is_contiguous() or gu.shape[-1] % 16:
        raise ValueError("gu must be contiguous bf16 (..., 2 * inter), inter a multiple of 8")
    if w is not None and (w.dtype != torch.float32 or w.numel() != rows
                          or not w.is_contiguous() or w.device != gu.device):
        raise ValueError("w must be contiguous float32 with one value per row of gu")
    out = torch.empty(gu.shape[:-1] + (inter,), dtype=gu.dtype, device=gu.device)
    if any(t is not None and t.data_ptr() % 16 for t in (gu, out)):
        raise ValueError("gu and the output must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(gu.device).multi_processor_count
    lib = _build.load("swiglu", _SIGNATURES)
    code = lib.navc_swiglu(ctypes.c_void_p(gu.data_ptr()),
                           ctypes.c_void_p(None if w is None else w.data_ptr()),
                           ctypes.c_void_p(out.data_ptr()), rows, inter, sms,
                           ctypes.c_void_p(torch.cuda.current_stream(gu.device).cuda_stream))
    _build.check(lib, code, "swiglu")
    _build.LAUNCHES.count("swiglu")
    return out
