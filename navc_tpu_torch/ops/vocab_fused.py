"""Vocab projection fused with an online softmax: argmax / gather-prob / top-k.

Port of navc_tpu/ops/vocab_fused.py. The NAR refinement loop needs three
scalars per token position from the (N, V) projection (reference
algorithms.py:7-15): the argmax id, its softmax probability, and, for the
teacher rescoring (algorithms.py:196-200), the probability of a given id.
The AR beam step needs the k best log-probs of each beam row with their ids
(reference models/Beam.py:68-79). The kernels (csrc/vocab_fused.cu) compute
them without writing the logits.

Each wrapper launches its CUDA kernel for CUDA tensors and raises if the
build or the launch fails; only for CPU tensors does it run the plain
version beside it. The plain versions are float32 PyTorch with the kernels'
bf16 rounding points (bf16 operands, float32 products and softmax).

W is taken in ``nn.Linear``'s own (V, D) layout — the projection weight, or
the word-embedding table for a tied projection — as bf16, converted once
(``projection_weights``), never per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .select import top_k_stable

MAX_D = 768  # shared-memory bound of the kernels' resident h tile
MAX_D_TOPK = 8192  # K5 streams h with W past MAX_D (its walk's ``stream`` layout)
MAX_K = 8    # register lists of the top-k kernel (beam sizes 1..8)
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIGNATURES = {"navc_project_argmax": _ARGS, "navc_project_gather_prob": _ARGS,
               "navc_project_topk": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}
ARGMAX_ROWS, ARGMAX_V = 128, 128  # row and vocab tiles of the kernels' walk
TOPK_MAX_TILES = 0xFFFF // ARGMAX_V  # K5's lists hold 16-bit ids within a split


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and come back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _scores_plain(h, w, bias):
    scores = _bf(h) @ _bf(w).t()
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    return scores


def project_argmax_plain(h: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (R,) int32 — the first maximum, max prob (R,) f32) of
    softmax(h @ w^T + bias); the plain version of ``project_argmax``."""
    scores = _scores_plain(h, w, bias)
    m = scores.max(dim=-1, keepdim=True).values
    s = torch.exp(scores - m).sum(-1)
    return scores.argmax(dim=-1).to(torch.int32), 1.0 / s


def project_gather_prob_plain(h: torch.Tensor, w: torch.Tensor,
                              targets: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """softmax(h @ w^T + bias)[i, targets[i]] (R,) f32; the plain version of
    ``project_gather_prob``."""
    scores = _scores_plain(h, w, bias)
    m = scores.max(dim=-1, keepdim=True).values
    s = torch.exp(scores - m).sum(-1)
    g = scores.gather(1, targets.to(torch.int64)[:, None])
    return torch.exp(g - m)[:, 0] / s


def project_topk_plain(h: torch.Tensor, w: torch.Tensor, k: int,
                       bias: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-probs (R, k) f32 descending, ids (R, k) int32) of the k best
    entries of log_softmax(h @ w^T + bias), lowest id first among equal
    values; the plain version of ``project_topk``."""
    scores = _scores_plain(h, w, bias)
    m = scores.max(dim=-1, keepdim=True).values
    s = torch.exp(scores - m).sum(-1, keepdim=True)
    top, ids = top_k_stable(scores, k)
    return (top - m) - torch.log(s), ids.to(torch.int32)


def _check(h, w, bias, targets=None, max_d=MAX_D):
    if h.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % h.device)
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError("h (R, D) and w (V, D) expected, got %s and %s"
                         % (tuple(h.shape), tuple(w.shape)))
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("h and w must be bfloat16, got %s and %s"
                        % (h.dtype, w.dtype))
    d = h.shape[1]
    if d % 16 or d > max_d:
        raise ValueError("D must be a multiple of 16 and at most %d, got %d"
                         % (max_d, d))
    tensors = [h, w] + [t for t in (bias, targets) if t is not None]
    for t in tensors:
        if t.device != h.device:
            raise ValueError("all operands must be on %s" % h.device)
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (w.shape[0],)):
        raise ValueError("bias must be float32 (V,)")
    if targets is not None and (targets.dtype != torch.int32
                                or tuple(targets.shape) != (h.shape[0],)):
        raise ValueError("targets must be int32 (R,)")


def _check_aligned(*tensors):
    """TMA reads h, w and the bias from 16-byte aligned addresses."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned (a TMA "
                             "requirement), got an address %% 16 = %d"
                             % (t.data_ptr() % 16))


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=256)  # ints in, ints out: the decode repeats its shapes
def argmax_splits(rows: int, v: int, sms: int,
                  max_per: Optional[int] = None) -> Tuple[int, int]:
    """(splits, tiles per split) of the vocab for ``project_argmax``,
    ``project_gather_prob``, ``project_topk`` and ops/vocab_ce.py's
    ``vocab_ce_fwd`` (K9, the walk's fourth mode) on a card of ``sms`` SMs:
    the grid is row tiles x splits, one block per SM at a time, so a call
    takes ceil(blocks / sms) waves of about (tiles per split + 1) tile times
    each (the 1: loading the block's h rows). Picks the least such cost,
    then the fewest splits, among splits of at most ``max_per`` tiles; no
    split is empty."""
    tiles = -(-v // ARGMAX_V)
    row_tiles = -(-rows // ARGMAX_ROWS)
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        if max_per is not None and per > max_per:
            continue
        splits = -(-tiles // per)
        cost = -(-row_tiles * splits // sms) * (per + 1)
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), (splits, per))
    return best[1]


def split_ranges(v: int, splits: int, per: int):
    """The [begin, end) vocab columns of each split."""
    return [(j * per * ARGMAX_V, min(v, (j + 1) * per * ARGMAX_V))
            for j in range(splits)]


def _launch_argmax(entry, h, w, bias, targets, out):
    """Launch K3 (``targets`` None) or K4 with partial-state scratch for
    the planned vocab split."""
    _check_aligned(h, w, bias)
    rows, d = h.shape
    v = w.shape[0]
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits, per = argmax_splits(rows, v, sms)
    pm = torch.empty((splits, rows), dtype=torch.float32, device=h.device)
    ps = torch.empty_like(pm)
    px = torch.empty((splits, rows), device=h.device,
                     dtype=torch.int32 if targets is None else torch.float32)
    lib = _build.load("vocab_fused", _SIGNATURES)
    ptrs = ([h, w, bias] + ([] if targets is None else [targets]) + out
            + [pm, ps, px])
    code = getattr(lib, entry)(*[_ptr(t) for t in ptrs], rows, d, v, splits,
                               per, _stream(h))
    return lib, code


def project_argmax(h: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax id (int32) and max softmax prob (f32) of each row of
    ``h @ w^T + bias``, lowest id on ties. h (R, D) bf16; w (V, D) bf16;
    bias (V,) f32 or None; on the card all 16-byte aligned."""
    if h.device.type == "cpu":
        return project_argmax_plain(h, w, bias)
    _check(h, w, bias)
    rows = h.shape[0]
    ids = torch.empty(rows, dtype=torch.int32, device=h.device)
    maxp = torch.empty(rows, dtype=torch.float32, device=h.device)
    if rows == 0:
        return ids, maxp
    lib, code = _launch_argmax("navc_project_argmax", h, w, bias, None,
                               [ids, maxp])
    _build.check(lib, code, "project_argmax")
    _build.LAUNCHES.count("project_argmax")
    return ids, maxp


def project_gather_prob(h: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(h @ w^T + bias)[i, targets[i]] (R,) f32 without the logits;
    0 for a target outside [0, V). h (R, D) bf16; w (V, D) bf16; targets
    (R,) int32; bias (V,) f32 or None; on the card h, w and the bias 16-byte
    aligned."""
    if h.device.type == "cpu":
        return project_gather_prob_plain(h, w, targets, bias)
    _check(h, w, bias, targets)
    prob = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    if h.shape[0] == 0:
        return prob
    lib, code = _launch_argmax("navc_project_gather_prob", h, w, bias, targets,
                               [prob])
    _build.check(lib, code, "project_gather_prob")
    _build.LAUNCHES.count("project_gather_prob")
    return prob


def project_topk(h: torch.Tensor, w: torch.Tensor, k: int,
                 bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best log-probs of each row of log_softmax(h @ w^T + bias),
    descending, and their ids, lowest id first among equal values; the
    logits are never written. h (R, D) bf16; w (V, D) bf16; bias (V,) f32 or
    None; 1 <= k <= min(MAX_K, V); on the card all 16-byte aligned. Returns
    ((R, k) f32, (R, k) int32). D up to MAX_D keeps h's rows in shared
    memory; wider (up to MAX_D_TOPK) streams them with W's tiles."""
    if h.device.type == "cpu":
        return project_topk_plain(h, w, k, bias)
    _check(h, w, bias, max_d=MAX_D_TOPK)
    if not 1 <= k <= min(MAX_K, w.shape[0]):
        raise ValueError("k must be in [1, min(%d, V)], got %d" % (MAX_K, k))
    _check_aligned(h, w, bias)
    rows, d = h.shape
    v = w.shape[0]
    lp = torch.empty((rows, k), dtype=torch.float32, device=h.device)
    ids = torch.empty((rows, k), dtype=torch.int32, device=h.device)
    if rows == 0:
        return lp, ids
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits, per = argmax_splits(rows, v, sms, TOPK_MAX_TILES)
    pm = torch.empty((splits, rows), dtype=torch.float32, device=h.device)
    ps = torch.empty_like(pm)
    pv = torch.empty((splits, rows, k), dtype=torch.float32, device=h.device)
    pi = torch.empty((splits, rows, k), dtype=torch.int32, device=h.device)
    lib = _build.load("vocab_fused", _SIGNATURES)
    code = lib.navc_project_topk(*[_ptr(t) for t in (h, w, bias, lp, ids, pm, ps, pv, pi)],
                                 rows, d, v, k, splits, per, _stream(h))
    _build.check(lib, code, "project_topk")
    _build.LAUNCHES.count("project_topk")
    return lp, ids


def projection_weights(model) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(w (V, D) bf16, bias (V,) f32 or None) for the vocab projection.

    Untied: the bias-free ``tgt_word_prj`` weight. Tied (reference
    seq2seq.py:27-33): the word-embedding table plus the standalone bias.
    Both are already (V, D); the bf16 copy is made here, once per caller.
    """
    w = model.projection_weight().detach().to(torch.bfloat16).contiguous()
    bias = None
    if model.tgt_word_prj is None:
        bias = model.tgt_word_prj_bias.detach().to(torch.float32).contiguous()
    return w, bias
