"""Vocab projection fused with the cross-entropy of the training step.

Port of navc_tpu/ops/vocab_ce.py. The loss needs two scalars per row of the
(N, V) projection (reference misc/crit.py:76-114): the log-softmax value at
the label (NLL, perplexity) and the argmax id (word accuracy).
``vocab_ce_train`` returns them without writing the logits (K9, a mode of
the vocab walk in csrc/vocab_fused.cu, ``navc_ce_fwd``), and its backward
recomputes the scores and forms dh, dW and db without writing their
gradient (K10, csrc/vocab_ce.cu ``ce_bwd_dh_kernel`` and
``ce_bwd_dw_kernel``), over the rows whose dg is not 0 only (``live_first``:
a PAD label's row adds exactly nothing). Both backward launches split their
work across blocks by plans made here (``dh_plan``, ``dw_plan``) and sum the
float32 partials in a fixed order: no atomics.

Each kernel wrapper launches its CUDA kernel for CUDA tensors, or raises;
only for CPU tensors does it run the plain version beside it
(``vocab_ce_fwd_plain``, ``vocab_ce_bwd_plain``): float32 PyTorch with the
kernels' rounding points in the compute dtype — operands, and ds before
both backward products. On the card the compute dtype is bfloat16.

W is the live (V, D) parameter in ``nn.Linear``'s layout: untied the
bias-free ``tgt_word_prj.weight``, tied the word-embedding table with the
``tgt_word_prj_bias`` (navc_tpu ops/vocab_fused.py ``projection_weights``,
transposed). Gradients reach both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from . import _build
from .vocab_fused import _check_aligned, argmax_splits

MAX_D = 512  # the backward's accumulators: 256 of D per warpgroup
CE_TILE = 64  # rows per dh block and per dW chunk, vocab rows per dW block
CE_TILE_V = 64  # vocab columns per dh tile: two W stages fit beside h
# The split planners' model of the card, fitted to the launches' times on an
# H100 at D 512, V 10048, N 1920 and 61440 (chip_smoke.py, PERF.md): an SM's
# rate on these products, and the memory's effective rate for partial sums.
SM_FLOPS, HBM_BYTES = 3.75e12, 2.5e12
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD = {"navc_ce_fwd": [_P] * 11 + [_I] * 5 + [_P]}
_LIVE = {"navc_ce_live_first": [_P] * 6 + [_I] * 2 + [_P]}
_BWD = {"navc_ce_bwd_dh": [_P] * 9 + [_I] + [_P] + [_I] * 5 + [_P],
        "navc_ce_bwd_dw": [_P] * 11 + [_I] * 4 + [_P]}


def _rnd(t: torch.Tensor, cdt) -> torch.Tensor:
    """``t`` rounded to the compute dtype, as float32."""
    t = t.to(torch.float32)
    return t if cdt == torch.float32 else t.to(cdt).to(torch.float32)


def _scores(h, w, bias, cdt):
    s = _rnd(h, cdt) @ _rnd(w, cdt).t()
    return s if bias is None else s + bias.to(torch.float32)


def vocab_ce_fwd_plain(h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                       labels: torch.Tensor, compute_dtype=torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``vocab_ce_fwd``: (g (N,) f32 label log-prob, pred (N,)
    int32 first argmax, z (N,) f32 log-sum-exp) of h @ w^T + bias."""
    s = _scores(h, w, bias, compute_dtype)
    m = s.amax(-1)
    lse = torch.log(torch.exp(s - m[:, None]).sum(-1))
    g = s.gather(1, labels.long()[:, None])[:, 0]
    return (g - m) - lse, s.argmax(-1).to(torch.int32), m + lse


def vocab_ce_bwd_plain(h, w, bias, labels, z, dg, compute_dtype=torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``vocab_ce_bwd``: (dh (N, D), dW (V, D), db (V,) or
    None), all float32."""
    cdt = compute_dtype
    s = _scores(h, w, bias, cdt)
    onehot = torch.zeros_like(s).scatter_(1, labels.long()[:, None], 1.0)
    ds = _rnd(dg.to(torch.float32)[:, None] * (onehot - torch.exp(s - z[:, None])), cdt)
    dh = ds @ _rnd(w, cdt)
    dw = ds.t() @ _rnd(h, cdt)
    return dh, dw, None if bias is None else ds.sum(0)


def _ptr(t: Optional[torch.Tensor]):
    return _P(None if t is None else t.data_ptr())


def _split_plan(units: int, items: int, sms: int, item_flops: float,
                merge_bytes: Callable[[int], float]) -> Tuple[int, int]:
    """(splits, items per split) for a grid of ``units`` x splits blocks, one
    block per SM at a time, each walking its split's items: a call takes
    ceil(blocks / sms) waves of (items per split + 1) item times (the 1:
    the block's resident operand), plus, with splits, a pass over
    ``merge_bytes(splits)`` bytes of partial sums and output (written, read
    and summed, written). Picks the least such time, then the fewest
    splits; no split is empty."""
    best = None
    for want in range(1, items + 1):
        per = -(-items // want)
        splits = -(-items // per)
        waves = -(-units * splits // sms)
        cost = (waves * (per + 1) * item_flops / SM_FLOPS
                + (merge_bytes(splits) / HBM_BYTES if splits > 1 else 0.0))
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), (splits, per))
    return best[1]


@functools.lru_cache(maxsize=64)
def dh_plan(rows: int, v: int, d: int, sms: int) -> Tuple[int, int]:
    """(splits, vocab tiles per split) of ``ce_bwd_dh``: blocks are row tiles
    of CE_TILE x vocab splits of CE_TILE_V-column tiles; with splits, float32
    partial dh (splits, rows, d) are written, then read and summed."""
    return _split_plan(-(-rows // CE_TILE), -(-v // CE_TILE_V), sms,
                       2 * 2 * CE_TILE * CE_TILE_V * d,
                       lambda s: (2 * s + 1) * rows * d * 4)


@functools.lru_cache(maxsize=64)
def dw_plan(rows: int, v: int, d: int, sms: int) -> int:
    """The row splits of ``ce_bwd_dw``: blocks are vocab tiles of CE_TILE x
    row splits; with splits, float32 partial dW and db (splits, v, d + 1)
    are written, then read and summed. Planned for ``rows`` rows; the kernel
    cuts the CE_TILE-row chunks of the rows it runs (those with dg != 0)
    into that many runs of equal length, none empty when every row runs."""
    return _split_plan(-(-v // CE_TILE), -(-rows // CE_TILE), sms,
                       2 * 2 * CE_TILE * CE_TILE * d,
                       lambda s: (2 * s + 1) * v * (d + 1) * 4)[0]


def live_first_plain(h, labels, z, dg):
    """Plain version of ``live_first``, every row of hl written."""
    order = torch.argsort(dg == 0, stable=True)
    meta = torch.zeros((5, h.shape[0]), dtype=torch.int32, device=h.device)
    meta[0] = order.to(torch.int32)
    meta[1] = labels[order].to(torch.int32)
    meta[2] = z[order].to(torch.float32).view(torch.int32)
    meta[3] = dg[order].to(torch.float32).view(torch.int32)
    meta[4, 0] = int((dg != 0).sum())
    return h[order], meta


def live_first(h, labels, z, dg):
    """K10's compaction: the backward's rows with dg != 0 first, in their
    order, then the others. Returns (hl, meta): hl, h's rows in that order
    (on the card only up to the end of the last CE_TILE-row tile that holds
    a row with dg != 0: the launches read no others); meta (5, N) int32:
    each row's index in the caller's order, then labels, z and dg in that
    order (z and dg as float32 bits), and at [4, 0] the number of rows with
    dg != 0. On CUDA tensors one call of ``navc_ce_live_first``, without a
    host sync: PyTorch's sort, count and gathers took four operators and
    ~185 us of host time a call beside an H100 (chip_smoke.py), and the
    B=64 step is bound by the host. On CPU tensors the plain version."""
    if h.device.type == "cpu":
        return live_first_plain(h, labels, z, dg)
    n, d = h.shape
    hl = torch.empty_like(h)
    meta = torch.empty((5, n), dtype=torch.int32, device=h.device)
    lib = _build.load("vocab_ce", _LIVE)
    _build.check(lib, lib.navc_ce_live_first(
        *[_ptr(t) for t in (h, labels, z, dg, hl, meta)], n, d, _stream(h)), "ce_live_first")
    return hl, meta


def _meta_ptrs(meta: torch.Tensor):
    """Pointers to ``live_first``'s meta rows: order, labels, z, dg, live."""
    base, n = meta.data_ptr(), meta.shape[1]
    return [_P(base + i * n * 4) for i in range(5)]


def _check(h, w, bias, labels):
    if h.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % h.device)
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError("h (N, D) and w (V, D) expected, got %s and %s"
                         % (tuple(h.shape), tuple(w.shape)))
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("h and w must be bfloat16, got %s and %s" % (h.dtype, w.dtype))
    d = h.shape[1]
    if d % 32 or d > MAX_D:
        raise ValueError("D must be a multiple of 32 and at most %d, got %d" % (MAX_D, d))
    if labels.dtype != torch.int32 or tuple(labels.shape) != (h.shape[0],):
        raise ValueError("labels must be int32 (N,)")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (w.shape[0],)):
        raise ValueError("bias must be float32 (V,)")
    for t in (h, w, bias, labels):
        if t is not None and (t.device != h.device or not t.is_contiguous()):
            raise ValueError("operands must be contiguous and on %s" % h.device)


def _stream(t: torch.Tensor):
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(t: torch.Tensor) -> int:
    return _sm_count(t.device.index)


def vocab_ce_fwd(h, w, bias, labels, compute_dtype=torch.bfloat16):
    """K9: (g, pred, z) as ``vocab_ce_fwd_plain``. On CUDA: h (N, D) and w
    (V, D) bfloat16, bias (V,) float32 or None, labels (N,) int32 in [0, V),
    all contiguous, h, w and the bias 16-byte aligned; the compute dtype
    bfloat16."""
    if h.device.type == "cpu":
        return vocab_ce_fwd_plain(h, w, bias, labels, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the vocab CE kernels compute in bfloat16 only")
    _check(h, w, bias, labels)
    _check_aligned(h, w, bias)
    n, d = h.shape
    v = w.shape[0]
    g = torch.empty(n, dtype=torch.float32, device=h.device)
    pred = torch.empty(n, dtype=torch.int32, device=h.device)
    z = torch.empty(n, dtype=torch.float32, device=h.device)
    if n:
        splits, per = argmax_splits(n, v, _sms(h))
        # the split's partial (max, sum-exp, argmax, label logit) per row:
        # four (splits, n) arrays of 4-byte words in one allocation, the
        # argmax's int32
        part = torch.empty((4, splits, n), dtype=torch.float32, device=h.device)
        pm, ps, pa, pg = (_P(part.data_ptr() + i * splits * n * 4) for i in range(4))
        lib = _build.load("vocab_fused", _FWD)
        _build.check(lib, lib.navc_ce_fwd(
            *[_ptr(t) for t in (h, w, bias, labels, g, pred, z)], pm, ps, pa, pg,
            n, d, v, splits, per, _stream(h)), "ce_fwd")
        _build.LAUNCHES.count("ce_fwd")
    return g, pred, z


def vocab_ce_bwd(h, w, bias, labels, z, dg, compute_dtype=torch.bfloat16,
                 dh_dtype=torch.float32):
    """K10 (two launches): (dh (N, D) in ``dh_dtype``, dW (V, D) float32,
    db (V,) float32 or None when ``bias`` is None). z from ``vocab_ce_fwd``;
    dg (N,) float32, the gradient of g. Operands as ``vocab_ce_fwd``."""
    if h.device.type == "cpu":
        dh, dw, db = vocab_ce_bwd_plain(h, w, bias, labels, z, dg, compute_dtype)
        return dh.to(dh_dtype), dw, db
    if compute_dtype != torch.bfloat16:
        raise ValueError("the vocab CE kernels compute in bfloat16 only")
    if dh_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("dh_dtype must be bfloat16 or float32")
    _check(h, w, bias, labels)
    _check_aligned(h, w, bias)
    n, d = h.shape
    v = w.shape[0]
    for t in (z, dg):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or t.device != h.device or not t.is_contiguous()):
            raise ValueError("z and dg must be contiguous float32 (N,) on %s" % h.device)
    dh = torch.zeros((n, d), dtype=dh_dtype, device=h.device)
    dw = torch.empty((v, d), dtype=torch.float32, device=h.device)
    db = None if bias is None else torch.empty(v, dtype=torch.float32, device=h.device)
    if n == 0:
        dw.zero_()
        if db is not None:
            db.zero_()
        return dh, dw, db
    lib = _build.load("vocab_ce", _BWD)
    hl, meta = live_first(h, labels, z, dg)
    order, lab, zl, gl, live = _meta_ptrs(meta)
    ops = [_ptr(hl), _ptr(w), _ptr(bias), lab, zl, gl, live]
    sms = _sms(h)
    splits, per = dh_plan(n, v, d, sms)
    part = (torch.empty((splits, n, d), dtype=torch.float32, device=h.device)
            if splits > 1 else None)
    _build.check(lib, lib.navc_ce_bwd_dh(
        *ops, order, _ptr(dh), int(dh_dtype == torch.bfloat16), _ptr(part), n,
        d, v, splits, per, _stream(h)), "ce_bwd_dh")
    _build.LAUNCHES.count("ce_bwd_dh")
    splits = dw_plan(n, v, d, sms)
    part = dbpart = None
    if splits > 1:
        part = torch.empty((splits, v, d), dtype=torch.float32, device=h.device)
        if bias is not None:
            dbpart = torch.empty((splits, v), dtype=torch.float32, device=h.device)
    _build.check(lib, lib.navc_ce_bwd_dw(
        *ops, _ptr(dw), _ptr(db), _ptr(part), _ptr(dbpart), n, d, v, splits,
        _stream(h)), "ce_bwd_dw")
    _build.LAUNCHES.count("ce_bwd_dw")
    return dh, dw, db


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a fresh copy of it where its address is not 16-byte aligned
    (a view into another tensor): TMA reads the kernels' operands."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, bias, labels, cdt):
        bk = None if bias is None else bias.detach().to(torch.float32).contiguous()
        if h.device.type == "cuda":  # kernel operands
            hk = _aligned(h.detach().to(cdt).contiguous())
            wk = _aligned(w.detach().to(cdt).contiguous())
            bk = _aligned(bk)
        else:
            hk, wk = h.detach(), w.detach()
        lab = labels.to(torch.int32).contiguous()
        g, pred, z = vocab_ce_fwd(hk, wk, bk, lab, cdt)
        ctx.save_for_backward(hk, wk, bk, lab, z)
        ctx.cdt = cdt
        ctx.dtypes = (h.dtype, w.dtype, None if bias is None else bias.dtype)
        ctx.mark_non_differentiable(pred)
        return g, pred

    @staticmethod
    def backward(ctx, dg, _dpred):
        hk, wk, bk, lab, z = ctx.saved_tensors
        hdt, wdt, bdt = ctx.dtypes
        dh_dtype = hdt if hdt in (torch.bfloat16, torch.float32) else torch.float32
        dh, dw, db = vocab_ce_bwd(hk, wk, bk, lab, z, dg.to(torch.float32).contiguous(),
                                  ctx.cdt, dh_dtype)
        return (dh.to(hdt), dw.to(wdt), None if db is None else db.to(bdt), None, None)


def vocab_ce_train(hidden: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                   labels: torch.Tensor, compute_dtype=torch.bfloat16
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (label log-prob f32, argmax id int32) of softmax(hidden @ w^T
    + bias), with gradients to hidden, w and bias through K10.

    hidden: (..., D); w: (V, D), the live projection parameter; bias: (V,)
    or None (untied); labels: (...,) int ids aligned with hidden's rows.
    PAD and valid-row masking stay with the caller: a masked row gets a zero
    gradient, which zeroes its ds row."""
    lead = hidden.shape[:-1]
    g, pred = _VocabCE.apply(hidden.reshape(-1, hidden.shape[-1]), w, bias,
                             labels.reshape(-1), compute_dtype)
    return g.reshape(lead), pred.reshape(lead)
