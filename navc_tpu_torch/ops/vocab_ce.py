"""Vocab projection fused with the cross-entropy of the training step.

Port of navc_tpu/ops/vocab_ce.py. The loss needs two scalars per row of the
(N, V) projection (reference misc/crit.py:76-114): the log-softmax value at
the label (NLL, perplexity) and the argmax id (word accuracy).
``vocab_ce_train`` returns them without writing the logits (K9,
csrc/vocab_ce.cu ``ce_fwd_kernel``), and its backward recomputes the scores
and forms dh, dW and db without writing their gradient (K10,
``ce_bwd_dh_kernel`` and ``ce_bwd_dw_kernel``).

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
from typing import Optional, Tuple

import torch

from . import _build

MAX_D = 512  # the backward's register accumulators: D / 32 per warp
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "navc_ce_fwd": [_P] * 7 + [_I] * 3 + [_P],
    "navc_ce_bwd_dh": [_P] * 7 + [_I] * 4 + [_P],
    "navc_ce_bwd_dw": [_P] * 8 + [_I] * 3 + [_P],
}


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


def vocab_ce_fwd(h, w, bias, labels, compute_dtype=torch.bfloat16):
    """K9: (g, pred, z) as ``vocab_ce_fwd_plain``. On CUDA: h (N, D) and w
    (V, D) bfloat16, bias (V,) float32 or None, labels (N,) int32, all
    contiguous; the compute dtype bfloat16."""
    if h.device.type == "cpu":
        return vocab_ce_fwd_plain(h, w, bias, labels, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the vocab CE kernels compute in bfloat16 only")
    _check(h, w, bias, labels)
    n, d = h.shape
    g = torch.empty(n, dtype=torch.float32, device=h.device)
    pred = torch.empty(n, dtype=torch.int32, device=h.device)
    z = torch.empty(n, dtype=torch.float32, device=h.device)
    if n:
        lib = _build.load("vocab_ce", _SIGNATURES)
        _build.check(lib, lib.navc_ce_fwd(_ptr(h), _ptr(w), _ptr(bias), _ptr(labels),
                                          _ptr(g), _ptr(pred), _ptr(z), n, d,
                                          w.shape[0], _stream(h)), "ce_fwd")
        _build.LAUNCHES["ce_fwd"] += 1
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
    n, d = h.shape
    v = w.shape[0]
    for t in (z, dg):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n,)
                or t.device != h.device or not t.is_contiguous()):
            raise ValueError("z and dg must be contiguous float32 (N,) on %s" % h.device)
    dh = torch.empty((n, d), dtype=dh_dtype, device=h.device)
    dw = torch.empty((v, d), dtype=torch.float32, device=h.device)
    db = None if bias is None else torch.empty(v, dtype=torch.float32, device=h.device)
    if n == 0:
        dw.zero_()
        if db is not None:
            db.zero_()
        return dh, dw, db
    lib = _build.load("vocab_ce", _SIGNATURES)
    _build.check(lib, lib.navc_ce_bwd_dh(
        _ptr(h), _ptr(w), _ptr(bias), _ptr(labels), _ptr(z), _ptr(dg), _ptr(dh),
        int(dh_dtype == torch.bfloat16), n, d, v, _stream(h)), "ce_bwd_dh")
    _build.LAUNCHES["ce_bwd_dh"] += 1
    _build.check(lib, lib.navc_ce_bwd_dw(
        _ptr(h), _ptr(w), _ptr(bias), _ptr(labels), _ptr(z), _ptr(dg), _ptr(dw),
        _ptr(db), n, d, v, _stream(h)), "ce_bwd_dw")
    _build.LAUNCHES["ce_bwd_dw"] += 1
    return dh, dw, db


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, bias, labels, cdt):
        if h.device.type == "cuda":  # kernel operands
            hk = h.detach().to(cdt).contiguous()
            wk = w.detach().to(cdt).contiguous()
        else:
            hk, wk = h.detach(), w.detach()
        bk = None if bias is None else bias.detach().to(torch.float32).contiguous()
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
