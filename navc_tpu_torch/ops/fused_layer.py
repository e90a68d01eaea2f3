"""The NAR decoder layer fused into one kernel (dense and sparse-query forms).

Port of navc_tpu/ops/fused_layer.py. ``fused_layer`` (K1) runs the whole
post-LN BertLayer in eval mode for every canvas row: the embedding epilogue
``LayerNorm(raw + static)``, masked self-attention (key-pad, −10e6 fill,
``causal`` for the AR teacher), cross-attention over hoisted bf16 K/V, and
the gelu_new FFN, with residual × non-pad multiplier after every stage.
``fused_layer_qsub`` (K2) computes the same rows only at the re-masked
query slots named by an index tensor (qidx (N, K), −1 = unused slot); their
raw embedding is the constant ``<mask>`` row, keys and values span the
full canvas, and unused slots give zero rows. Its rows equal K1's rows at
those positions.

``fused_layer_unfolded`` (K1u) is the eval layer on already-embedded rows
with the cross K/V projected in the kernel from ``enc``: the training
layer's forward (K11) with both dropout probabilities 0, so it shares K11's
device code and plain version. No decode path of navc_tpu calls this form
(its decodes pass ``static=``, which selects K1).

All three are one CUDA source (csrc/fused_layer.cu). Each wrapper launches it for
CUDA tensors and raises if the build or the launch fails; only for CPU
tensors does it run the plain version beside it — float32 PyTorch with the
kernel's bf16 rounding points (bf16 matmul operands with float32
accumulation, float32 bias, LayerNorm and softmax; ``_attend_2d`` /
``_layer_body`` of the JAX kernel).

Weights are a ``LayerWeights`` made once from a BertLayer: bf16 matrices in
``nn.Linear``'s (out, in) layout, float32 biases.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build
from ..models.layers import MASK_FILL
from .fused_layer_train import (TrainArgs, check_operands, kernel_args,
                                train_fwd_plain)

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
MAX_ROWS = 32  # canvas length, query slots and encoder positions per block


@dataclass
class LayerWeights:
    """Kernel operands of one BertLayer: (out, in) bf16 matrices, f32 biases.
    Field order is the kernel's (wq_s .. wo_c, then the FFN)."""
    wq_s: torch.Tensor
    wk_s: torch.Tensor
    wv_s: torch.Tensor
    wo_s: torch.Tensor
    wq_c: torch.Tensor
    wk_c: torch.Tensor
    wv_c: torch.Tensor
    wo_c: torch.Tensor
    bq_s: torch.Tensor
    bk_s: torch.Tensor
    bv_s: torch.Tensor
    bo_s: torch.Tensor
    bq_c: torch.Tensor
    bk_c: torch.Tensor
    bv_c: torch.Tensor
    bo_c: torch.Tensor
    wi: torch.Tensor
    bi: torch.Tensor
    wo2: torch.Tensor
    bo2: torch.Tensor


MATS = ("wq_s", "wk_s", "wv_s", "wo_s", "wq_c", "wk_c", "wv_c", "wo_c")
BIASES = ("bq_s", "bk_s", "bv_s", "bo_s", "bq_c", "bk_c", "bv_c", "bo_c")


def layer_weights(layer, dtype=torch.bfloat16) -> LayerWeights:
    """``LayerWeights`` of a ``models.layers.BertLayer`` (converted once),
    the matrices in ``dtype``."""
    def mat(lin):
        return lin.weight.detach().to(dtype).contiguous()

    def vec(lin):
        return lin.bias.detach().to(torch.float32).contiguous()

    out = {}
    for sfx, block in (("s", layer.attention), ("c", layer.attend_to_enc_output)):
        for name, lin in (("q", block.self.query), ("k", block.self.key),
                          ("v", block.self.value), ("o", block.output.dense)):
            out["w%s_%s" % (name, sfx)] = mat(lin)
            out["b%s_%s" % (name, sfx)] = vec(lin)
    out["wi"], out["bi"] = mat(layer.intermediate.dense), vec(layer.intermediate.dense)
    out["wo2"], out["bo2"] = mat(layer.output.dense), vec(layer.output.dense)
    return LayerWeights(**out)


def hoist_cross_kv(enc: torch.Tensor, w: LayerWeights
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from enc_output, (N, Le, H) bf16 each: bf16
    operands, float32 accumulation, the float32 bias added, and only then
    the cast to bf16 — the kernel's own arithmetic. They are invariant
    across refinement iterations and length-beam rows, so a decode projects
    them once per video. A plain GEMM, left to ``torch.matmul``."""
    e = _bf(enc)
    ke = (e @ w.wk_c.to(torch.float32).t() + w.bk_c).to(torch.bfloat16)
    ve = (e @ w.wv_c.to(torch.float32).t() + w.bv_c).to(torch.bfloat16)
    return ke.contiguous(), ve.contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ w^T with float32 accumulation; w is (out, in) bf16."""
    return _bf(x) @ w.to(torch.float32).t()


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def _attend(xq, k16, v16, masked, wq, bq, wo, bo, n_head):
    """Per-head attention as _attend_2d; k16/v16 are bf16-valued keys and
    values, masked (N, Lq, Lk) True where the score gets MASK_FILL. Returns
    the pre-residual float32 output."""
    n, lq, h = xq.shape
    d = h // n_head
    q = _bf(_mm(xq, wq) + bq).view(n, lq, n_head, d)
    k = k16.view(n, -1, n_head, d)
    v = v16.view(n, -1, n_head, d)
    bias = torch.where(masked, MASK_FILL, 0.0)[:, None]
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k) * (1.0 / math.sqrt(d)) + bias
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    ctx = torch.einsum("nhqk,nkhd->nqhd", _bf(probs), v).reshape(n, lq, h)
    return _mm(ctx, wo) + bo


def _layer_rest(xq, x_keys, kp, npm, ke, ve, w, n_head, causal):
    """Self-attention (keys: x_keys rows), cross-attention and FFN for the
    query rows xq, as _layer_body."""
    n, lq, _ = xq.shape
    lk = x_keys.shape[1]
    masked = kp[:, None, :].expand(n, lq, lk)
    if causal:
        masked = masked | torch.ones(lq, lk, dtype=torch.bool,
                                     device=xq.device).triu(1)[None]
    k16 = _bf(_mm(x_keys, w.wk_s) + w.bk_s)
    v16 = _bf(_mm(x_keys, w.wv_s) + w.bv_s)
    att = (_attend(xq, k16, v16, masked, w.wq_s, w.bq_s, w.wo_s, w.bo_s,
                   n_head) + xq) * npm
    no_mask = torch.zeros(n, lq, ke.shape[1], dtype=torch.bool, device=xq.device)
    cross = _attend(att, ke.to(torch.float32), ve.to(torch.float32), no_mask,
                    w.wq_c, w.bq_c, w.wo_c, w.bo_c, n_head)
    att = (cross + att) * npm
    inter = _gelu_new(_mm(att, w.wi) + w.bi)
    return ((_mm(inter, w.wo2) + w.bo2) + att) * npm


def fused_layer_plain(raw, static, kp, ke, ve, w: LayerWeights, ln_scale,
                      ln_bias, n_head: int, causal: bool = False,
                      ln_eps: float = 1e-5, out_dtype=torch.float32):
    """Plain version of ``fused_layer``."""
    x = _ln(raw.to(torch.float32) + static.to(torch.float32),
            ln_scale.to(torch.float32), ln_bias.to(torch.float32), ln_eps)
    npm = (~kp).to(torch.float32)[..., None]
    return _layer_rest(x, x, kp, npm, ke, ve, w, n_head, causal).to(out_dtype)


def fused_layer_qsub_plain(qidx, mask_row, raw, static, kp, ke, ve,
                           w: LayerWeights, ln_scale, ln_bias, n_head: int,
                           ln_eps: float = 1e-5, out_dtype=torch.float32):
    """Plain version of ``fused_layer_qsub``."""
    lns, lnb = ln_scale.to(torch.float32), ln_bias.to(torch.float32)
    st = static.to(torch.float32)
    x = _ln(raw.to(torch.float32) + st, lns, lnb, ln_eps)
    valid = qidx >= 0
    pos = qidx.clamp(min=0).to(torch.int64)
    static_q = torch.gather(st, 1, pos[..., None].expand(-1, -1, st.shape[2]))
    static_q = static_q * valid[..., None]
    xq = _ln(mask_row.to(torch.float32) + static_q, lns, lnb, ln_eps)
    npm_q = valid.to(torch.float32)[..., None]
    return _layer_rest(xq, x, kp, npm_q, ke, ve, w, n_head, False).to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


class _LayerArgs(ctypes.Structure):
    """Mirror of ``struct LayerArgs`` in csrc/fused_layer.cu."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "raw", "stat", "lns", "lnb", "kp", "ke", "ve", "qidx", "mrow")]
        + [("w", ctypes.c_void_p * 8), ("b", ctypes.c_void_p * 8)]
        + [(name, ctypes.c_void_p) for name in ("wi", "bi", "wo2", "bo2", "out")]
        + [(name, ctypes.c_int) for name in (
            "out_bf16", "n", "L", "Le", "K", "H", "I", "n_head", "causal")]
        + [("scale", ctypes.c_float), ("eps", ctypes.c_float)])


def _check(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, out_dtype):
    if raw.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % raw.device)
    n, l, h = raw.shape
    checks = [
        (static.shape == raw.shape, "static must match raw (N, L, H)"),
        (tuple(kp.shape) == (n, l) and kp.dtype == torch.bool,
         "kp must be bool (N, L)"),
        (ke.dim() == 3 and ke.shape == ve.shape and ke.shape[0] == n
         and ke.shape[2] == h, "ke/ve must be (N, Le, H)"),
        (raw.dtype == static.dtype == ke.dtype == ve.dtype == torch.bfloat16,
         "raw, static, ke, ve must be bfloat16"),
        (ln_scale.dtype == ln_bias.dtype == torch.float32
         and tuple(ln_scale.shape) == tuple(ln_bias.shape) == (h,),
         "LayerNorm scale/bias must be float32 (H,)"),
        (l <= MAX_ROWS and ke.shape[1] <= MAX_ROWS,
         "canvas and encoder lengths must be <= %d" % MAX_ROWS),
        (h % 128 == 0 and h <= 512, "H must be a multiple of 128, <= 512"),
        (h % n_head == 0 and (h // n_head) % 16 == 0,
         "head width must be a multiple of 16"),
        (w.wi.shape[0] % 16 == 0 and tuple(w.wi.shape) == (w.wi.shape[0], h),
         "FFN width must be a multiple of 16"),
        (out_dtype in (torch.bfloat16, torch.float32),
         "out_dtype must be bfloat16 or float32"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    ops = [raw, static, kp, ke, ve, ln_scale, ln_bias] + [
        getattr(w, f) for f in LayerWeights.__dataclass_fields__]
    for t in ops:
        if t.device != raw.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on %s" % raw.device)
    for name in MATS:
        m = getattr(w, name)
        if m.dtype != torch.bfloat16 or tuple(m.shape) != (h, h):
            raise ValueError("%s must be bfloat16 (H, H)" % name)


def _launch(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, causal,
            ln_eps, out, qidx=None, mask_row=None):
    n, l, h = raw.shape
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = _LayerArgs(
        raw=p(raw), stat=p(static), lns=p(ln_scale), lnb=p(ln_bias), kp=p(kp),
        ke=p(ke), ve=p(ve), qidx=p(qidx), mrow=p(mask_row),
        w=(ctypes.c_void_p * 8)(*[p(getattr(w, k)) for k in MATS]),
        b=(ctypes.c_void_p * 8)(*[p(getattr(w, k)) for k in BIASES]),
        wi=p(w.wi), bi=p(w.bi), wo2=p(w.wo2), bo2=p(w.bo2), out=p(out),
        out_bf16=int(out.dtype == torch.bfloat16), n=n, L=l, Le=ke.shape[1],
        K=0 if qidx is None else qidx.shape[1], H=h, I=w.wi.shape[0],
        n_head=n_head, causal=int(causal),
        scale=1.0 / math.sqrt(h // n_head), eps=ln_eps)
    lib = _build.load("fused_layer", {
        "navc_fused_layer": [ctypes.POINTER(_LayerArgs), ctypes.c_void_p]})
    code = lib.navc_fused_layer(
        ctypes.byref(args),
        ctypes.c_void_p(torch.cuda.current_stream(raw.device).cuda_stream))
    _build.check(lib, code, "fused_layer")


def fused_layer(raw, static, kp, ke, ve, w: LayerWeights, ln_scale, ln_bias,
                n_head: int, causal: bool = False, ln_eps: float = 1e-5,
                out_dtype=torch.float32) -> torch.Tensor:
    """K1: the whole layer for every canvas row.

    raw: (N, L, H) raw word embeddings; static: (N, L, H) position (+
    category) (+ mean-pooled enc) features; kp: (N, L) bool, True at PAD;
    ke/ve: (N, Le, H) hoisted cross K/V (``hoist_cross_kv``). Returns
    (N, L, H) in ``out_dtype``.
    """
    if raw.device.type == "cpu":
        return fused_layer_plain(raw, static, kp, ke, ve, w, ln_scale, ln_bias,
                                 n_head, causal, ln_eps, out_dtype)
    _check(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, out_dtype)
    out = torch.empty(raw.shape, dtype=out_dtype, device=raw.device)
    if raw.shape[0]:
        _launch(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, causal,
                ln_eps, out)
        _build.LAUNCHES["fused_layer"] += 1
    return out


def fused_layer_qsub(qidx, mask_row, raw, static, kp, ke, ve, w: LayerWeights,
                     ln_scale, ln_bias, n_head: int, ln_eps: float = 1e-5,
                     out_dtype=torch.float32) -> torch.Tensor:
    """K2: the layer's rows at the query slots only (non-causal).

    qidx: (N, K) int32 canvas position of each query slot, −1 = unused;
    mask_row: (H,) the ``<mask>`` word embedding; other operands as
    ``fused_layer``. Returns (N, K, H); unused slots are zero rows.
    """
    if raw.device.type == "cpu":
        return fused_layer_qsub_plain(qidx, mask_row, raw, static, kp, ke, ve,
                                      w, ln_scale, ln_bias, n_head, ln_eps,
                                      out_dtype)
    _check(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, out_dtype)
    n, l, h = raw.shape
    if (qidx.dtype != torch.int32 or qidx.dim() != 2 or qidx.shape[0] != n
            or qidx.shape[1] > MAX_ROWS or not qidx.is_contiguous()
            or qidx.device != raw.device):
        raise ValueError("qidx must be contiguous int32 (N, K <= %d)" % MAX_ROWS)
    if (mask_row.dtype != torch.bfloat16 or tuple(mask_row.shape) != (h,)
            or mask_row.device != raw.device or not mask_row.is_contiguous()):
        raise ValueError("mask_row must be bfloat16 (H,) on %s" % raw.device)
    out = torch.empty((n, qidx.shape[1], h), dtype=out_dtype, device=raw.device)
    if n and qidx.shape[1]:
        _launch(raw, static, kp, ke, ve, w, ln_scale, ln_bias, n_head, False,
                ln_eps, out, qidx=qidx, mask_row=mask_row)
        _build.LAUNCHES["fused_layer_qsub"] += 1
    return out


def _train_dict(w: LayerWeights):
    return {k: getattr(w, k) for k in LayerWeights.__dataclass_fields__}


def fused_layer_unfolded_plain(x, enc, kp, w: LayerWeights, n_head: int,
                               causal: bool = False, out_dtype=torch.float32):
    """Plain version of ``fused_layer_unfolded``: ``train_fwd_plain`` at
    p = p_input = 0 with bf16 rounding points."""
    return train_fwd_plain(x, enc, kp, _train_dict(w), 0, n_head=n_head,
                           causal=causal, p=0.0, p_input=0.0,
                           compute_dtype=torch.bfloat16, out_dtype=out_dtype)[0]


def fused_layer_unfolded(x, enc, kp, w: LayerWeights, n_head: int,
                         causal: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """K1u: the eval BertLayer on embedded rows.

    x: (N, L, H) post-embedding states; enc: (N, Le, H) encoder output (its
    cross K/V are projected in the kernel); kp: (N, L) bool, True at PAD;
    w: ``layer_weights``. On CUDA x and enc must be float32 (navc_tpu's
    kernel reads x as float32). Returns (N, L, H) in ``out_dtype``."""
    if x.device.type == "cpu":
        return fused_layer_unfolded_plain(x, enc, kp, w, n_head, causal, out_dtype)
    wd = _train_dict(w)
    check_operands(x, enc, kp, wd, n_head, torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("out_dtype must be bfloat16 or float32")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.shape[0]:
        a = kernel_args(x, enc, kp, wd, 0, n_head, causal, 0.0, 0.0,
                        out=out.data_ptr(), out_bf16=int(out_dtype == torch.bfloat16))
        lib = _build.load("fused_layer", {
            "navc_fused_layer_unfolded": [ctypes.POINTER(TrainArgs), ctypes.c_void_p]})
        _build.check(lib, lib.navc_fused_layer_unfolded(
            ctypes.byref(a),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)),
            "fused_layer_unfolded")
        _build.LAUNCHES["fused_layer_unfolded"] += 1
    return out
