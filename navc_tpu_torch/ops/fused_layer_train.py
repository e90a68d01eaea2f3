"""The decoder layer of the training step: forward and backward kernels.

Port of navc_tpu/ops/fused_layer_train.py. ``fused_bert_layer_train`` runs
one post-LN BertLayer in train mode — input dropout, self-attention,
cross-attention over the encoder output, the gelu_new FFN, hidden dropout at
four sites, the residual times the non-pad multiplier after every stage —
as a ``torch.autograd.Function`` whose backward recomputes the attention
instead of saving it. The only residual kept is ``r2`` (the FFN input) in
the compute dtype.

Four CUDA kernels (csrc/fused_layer_train.cu), one wrapper each:

  ``train_fwd``         K11, the forward (out, r2)
  ``ffn_bwd_operands``  K12a, the FFN backward: dr2, and the operands of the
                        FFN weight gradients
  ``attn_bwd_operands`` K12b, the attention backward by recompute: dx, denc,
                        and the operands of the 16 attention gradients
  ``weight_grads``      every dW = Bᵀ·A over all rows, and every bias
                        gradient, in a fixed order

K11, K12a and K12b multiply all N·Lp rows of the batch at once
(csrc/row_gemm.cuh's TMA + wgmma walk), each as a few launches from one C
entry on scratch that its wrapper allocates for the call. The TPU
kernels carry the weight gradients across their sequential grid in
VMEM scratch; CUDA blocks run in parallel, so K12a/K12b write the per-row
operands of each product (rounded to the compute dtype, where the JAX kernel
rounds them) and per-sequence float32 column sums of each bias operand, and
``weight_grads`` reduces them. Each wrapper launches its kernel for CUDA
tensors or raises; only for CPU tensors does it run the plain version beside
it — float32 PyTorch with the kernels' rounding points (every product takes
compute-dtype operands and accumulates in float32; biases, softmax and bias
gradients stay float32).

Dropout masks come from a counter hash (``hash24``), bit for bit the JAX
kernel's: sequence ``s``, position ``j``, column ``c`` sit at lattice row
``(s % 8) * round_up(L, 8) + j`` of tile ``s // 8`` (the JAX wrapper's tile
of 8 sequences), whatever the CUDA block shape. Matrices are in
``nn.Linear``'s (out, in) layout throughout.

The seed is an int or, as navc_tpu's kernels take it, a (1,) int32 tensor.
On the card the kernels read it where it lies (``device_seed``): the
wrappers pass its address and never read its value on the host, so a step
captured as a CUDA graph draws the masks of whatever seed the stream wrote
there before the replay. The plain versions read it on the host
(``seed_value``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from . import _build
from ..models.layers import MASK_FILL

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
WEIGHT_KEYS = ("wq_s", "bq_s", "wk_s", "bk_s", "wv_s", "bv_s", "wo_s", "bo_s",
               "wq_c", "bq_c", "wk_c", "bk_c", "wv_c", "bv_c", "wo_c", "bo_c",
               "wi", "bi", "wo2", "bo2")
MATS = ("wq_s", "wk_s", "wv_s", "wo_s", "wq_c", "wk_c", "wv_c", "wo_c")
BIASES = ("bq_s", "bk_s", "bv_s", "bo_s", "bq_c", "bk_c", "bv_c", "bo_c")
TB = 8          # sequences per tile of the dropout lattice (navc_tpu's tb)
ROW_TILE = 16   # kernel row padding: r2 and the operand rows are (N, Lp, .)
MAX_ROWS = 32   # decoder and encoder rows per block

# navc_tpu's int32 mixing constants (as uint32 in the comments)
_MC1 = -1640531527   # 0x9E3779B9
_MC2 = -2048144789   # 0x85EBCA6B
_MC3 = -1028477379   # 0xC2B2AE3D
_MM1 = 2146121005    # 0x7FEB352D
_MM2 = -2070006133   # 0x849E368B
_M32 = 0xFFFFFFFF

SITE_SELF_OUT, SITE_CROSS_OUT, SITE_FFN_DOWN, SITE_FFN_FINAL, SITE_INPUT = range(5)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# The dropout lattice
# ---------------------------------------------------------------------------


def seed_value(seed) -> int:
    """The seed as a host int: an int, or the element of a one-element
    tensor (a read that waits for the card when it lies there)."""
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def device_seed(seed, device) -> torch.Tensor:
    """The seed as the kernels read it: a (1,) int32 tensor on ``device``.
    A tensor must already be one (it is passed on as it is, unread); an int
    becomes one by a fill on the card, no copy from the host."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
            raise ValueError("a tensor seed must be a (1,) int32 on %s, got %s %s on %s"
                             % (device, seed.dtype, tuple(seed.shape), seed.device))
        return seed
    s = int(seed) & _M32
    return torch.full((1,), s - (1 << 32) if s >> 31 else s, dtype=torch.int32,
                      device=device)


def _hash(seed, tile, site: int, r, c) -> torch.Tensor:
    """murmur3 fmix of ``r * MC1 + c * MC2 + key`` in uint32 arithmetic,
    held in int64: every product stays below 2^63 and is cut to 32 bits, and
    ``>>`` of a value in [0, 2^32) is the logical shift. ``seed`` an int or
    a one-element tensor, read on the host."""
    key = (seed_value(seed) + (tile * 11 + site) * _MC3) & _M32
    x = (r * _MC1 + c * _MC2 + key) & _M32
    x = x ^ (x >> 16)
    x = (x * _MM1) & _M32
    x = x ^ (x >> 13)
    x = (x * _MM2) & _M32
    x = x ^ (x >> 16)
    return x & 0x00FFFFFF


def hash24(seed, tile: int, site: int, rows: int, cols: int,
           device=None) -> torch.Tensor:
    """Uniform 24-bit integers (int64) on a (rows, cols) lattice, as
    navc_tpu's ``_hash24``."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return _hash(seed, tile, site, r, c)


def lattice_bits(seed, site: int, n: int, l: int, h: int,
                 device=None) -> torch.Tensor:
    """(N, L, H) hash bits of one dropout site for N sequences of L rows."""
    s = torch.arange(n, dtype=torch.int64, device=device)[:, None, None]
    j = torch.arange(l, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(h, dtype=torch.int64, device=device)[None, None, :]
    return _hash(seed, s // TB, site, (s % TB) * _round_up(l, 8) + j, c)


def dropmul(v: torch.Tensor, seed, site: int, p: float) -> torch.Tensor:
    """Dropout(p) of float32 (N, L, H) ``v`` with the lattice mask: keep
    where bits >= round(p * 2^24), scaled by 1 / (1 - p)."""
    if p <= 0.0:
        return v
    th = int(round(p * float(1 << 24)))
    bits = lattice_bits(seed, site, *v.shape, device=v.device)
    return v * ((bits >= th).to(torch.float32) * (1.0 / (1.0 - p)))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rnd(t: torch.Tensor, cdt) -> torch.Tensor:
    t = t.to(torch.float32)
    return t if cdt == torch.float32 else t.to(cdt).to(torch.float32)


def _mm(a, b, cdt):
    """a @ b with operands rounded to the compute dtype, float32 sums."""
    return _rnd(a, cdt) @ _rnd(b, cdt)


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def _gelu_new_grad(a):
    u = SQRT_2_OVER_PI * (a + 0.044715 * a * a * a)
    th = torch.tanh(u)
    du = SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * a * a)
    return 0.5 * (1.0 + th) + 0.5 * a * (1.0 - th * th) * du


def _heads(t, n_head):
    n, l, h = t.shape
    return t.reshape(n, l, n_head, h // n_head).transpose(1, 2)


def _merge(t):
    n, nh, l, d = t.shape
    return t.transpose(1, 2).reshape(n, l, nh * d)


def _attend(q, k, v, masked, n_head, cdt):
    """Per-head masked softmax attention. masked (N, Lq, Lk) bool or None.
    Returns (probs (N, nh, Lq, Lk) float32, ctx (N, Lq, H) float32)."""
    scale = 1.0 / math.sqrt(q.shape[2] // n_head)
    scores = _mm(_heads(q, n_head), _heads(k, n_head).transpose(-1, -2), cdt) * scale
    if masked is not None:
        scores = scores + torch.where(masked, MASK_FILL, 0.0)[:, None]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    return p, _merge(_mm(p, _heads(v, n_head), cdt))


def _attend_bwd(dctx, p, q, k, v, n_head, cdt):
    """Backward of ``_attend`` given dctx and the (recomputed) probs:
    (dq, dk, dv), each (N, rows, H) float32."""
    scale = 1.0 / math.sqrt(q.shape[2] // n_head)
    dc = _heads(dctx, n_head)
    dv = _mm(p.transpose(-1, -2), dc, cdt)
    dp = _mm(dc, _heads(v, n_head).transpose(-1, -2), cdt)
    ds = (dp - (dp * p).sum(-1, keepdim=True)) * p * scale
    dq = _mm(ds, _heads(k, n_head), cdt)
    dk = _mm(ds.transpose(-1, -2), _heads(q, n_head), cdt)
    return _merge(dq), _merge(dk), _merge(dv)


def _lin(x, w, b, cdt):
    return _mm(x, w.t(), cdt) + b.to(torch.float32)


def _self_mask(kp, causal):
    n, l = kp.shape
    masked = kp[:, None, :].expand(n, l, l)
    if causal:
        masked = masked | torch.ones(l, l, dtype=torch.bool,
                                     device=kp.device).triu(1)[None]
    return masked


def _self_cross_fwd(x, enc, kp, w, seed, n_head, causal, p, p_input, cdt):
    """Self- and cross-attention stages, as navc_tpu's ``_self_cross_fwd``
    (shared by the forward and the attention backward's recompute)."""
    x = dropmul(x.to(torch.float32), seed, SITE_INPUT, p_input)
    enc = enc.to(torch.float32)
    npm = (~kp).to(torch.float32)[..., None]
    q1, k1, v1 = (_lin(x, w["w%s_s" % t], w["b%s_s" % t], cdt) for t in "qkv")
    ps1, c1 = _attend(q1, k1, v1, _self_mask(kp, causal), n_head, cdt)
    o1 = dropmul(_lin(c1, w["wo_s"], w["bo_s"], cdt), seed, SITE_SELF_OUT, p)
    r1 = (o1 + x) * npm
    q2 = _lin(r1, w["wq_c"], w["bq_c"], cdt)
    k2, v2 = (_lin(enc, w["w%s_c" % t], w["b%s_c" % t], cdt) for t in "kv")
    ps2, c2 = _attend(q2, k2, v2, None, n_head, cdt)
    o2 = dropmul(_lin(c2, w["wo_c"], w["bo_c"], cdt), seed, SITE_CROSS_OUT, p)
    r2 = (o2 + r1) * npm
    return dict(x=x, enc=enc, npm=npm, q1=q1, k1=k1, v1=v1, ps1=ps1, c1=c1,
                r1=r1, q2=q2, k2=k2, v2=v2, ps2=ps2, c2=c2, r2=r2)


def _pad_rows(t: torch.Tensor, lp: int) -> torch.Tensor:
    """(N, L, C) -> (N, Lp, C) with zero rows after L."""
    n, l, c = t.shape
    if l == lp:
        return t
    return torch.cat([t, t.new_zeros(n, lp - l, c)], 1)


def _flat(t: torch.Tensor, lp: int, cdt) -> torch.Tensor:
    """Operand rows: (N, L, C) rounded to cdt, padded to (N * Lp, C)."""
    return _rnd(_pad_rows(t, lp), cdt).reshape(-1, t.shape[2])


def train_fwd_plain(x, enc, kp, w, seed, *, n_head, causal=False, p=0.5,
                    p_input=0.0, compute_dtype=torch.bfloat16,
                    out_dtype=torch.float32):
    """Plain version of ``train_fwd`` (navc_tpu ``_fwd_kernel``): returns
    (out (N, L, H) in ``out_dtype``, r2 (N, Lp, H) in the compute dtype,
    zero rows after L)."""
    cdt = compute_dtype
    st = _self_cross_fwd(x, enc, kp, w, seed, n_head, causal, p, p_input, cdt)
    r2, npm = st["r2"], st["npm"]
    g = _gelu_new(_lin(r2, w["wi"], w["bi"], cdt))
    d = dropmul(_lin(g, w["wo2"], w["bo2"], cdt), seed, SITE_FFN_DOWN, p)
    t = dropmul(d + r2, seed, SITE_FFN_FINAL, p)
    lp = _round_up(x.shape[1], ROW_TILE)
    return (t * npm).to(out_dtype), _pad_rows(r2, lp).to(cdt)


class Product(NamedTuple):
    """One weight gradient: dW = Pᵀ·Q over all rows and db = the sum over
    sequences of ``part`` (per-sequence float32 column sums of P)."""
    w: str
    b: str
    P: torch.Tensor     # (R, M) operand rows, compute-dtype values
    Q: torch.Tensor     # (R, K)
    part: torch.Tensor  # (N, M) float32


def ffn_bwd_operands_plain(r2, dy, kp, w, seed, *, p=0.5,
                           compute_dtype=torch.bfloat16):
    """Plain version of ``ffn_bwd_operands`` (navc_tpu ``_ffn_bwd_kernel``):
    (dr2 (N, L, H) float32, [Product wi, Product wo2])."""
    cdt = compute_dtype
    n, l, h = dy.shape
    lp = r2.shape[1]
    npm = (~kp).to(torch.float32)[..., None]
    dt = dropmul(dy.to(torch.float32) * npm, seed, SITE_FFN_FINAL, p)
    dd = dropmul(dt, seed, SITE_FFN_DOWN, p)
    r2f = r2[:, :l].to(torch.float32)
    a = _lin(r2f, w["wi"], w["bi"], cdt)
    g = _gelu_new(a)
    da = _mm(dd, w["wo2"], cdt) * _gelu_new_grad(a)
    dr2 = dt + _mm(da, w["wi"], cdt)
    return dr2, [
        Product("wi", "bi", _flat(da, lp, cdt), _flat(r2f, lp, cdt), da.sum(1)),
        Product("wo2", "bo2", _flat(dd, lp, cdt), _flat(g, lp, cdt), dd.sum(1))]


def attn_bwd_operands_plain(x, enc, dr2, kp, w, seed, *, n_head, causal=False,
                            p=0.5, p_input=0.0, compute_dtype=torch.bfloat16):
    """Plain version of ``attn_bwd_operands`` (navc_tpu ``_attn_bwd_kernel``):
    (dx (N, L, H), denc (N, Le, H), the 8 attention Products), float32."""
    cdt = compute_dtype
    st = _self_cross_fwd(x, enc, kp, w, seed, n_head, causal, p, p_input, cdt)
    npm = st["npm"]
    lp = _round_up(x.shape[1], ROW_TILE)
    lep = _round_up(enc.shape[1], ROW_TILE)
    dr2 = dr2.to(torch.float32)

    do2 = dropmul(dr2 * npm, seed, SITE_CROSS_OUT, p)
    dr1 = dr2 * npm
    dc2 = _mm(do2, w["wo_c"], cdt)
    dq2, dk2, dv2 = _attend_bwd(dc2, st["ps2"], st["q2"], st["k2"], st["v2"],
                                n_head, cdt)
    dr1 = dr1 + _mm(dq2, w["wq_c"], cdt)
    denc = _mm(dk2, w["wk_c"], cdt) + _mm(dv2, w["wv_c"], cdt)

    do1 = dropmul(dr1 * npm, seed, SITE_SELF_OUT, p)
    dx = dr1 * npm
    dc1 = _mm(do1, w["wo_s"], cdt)
    dq1, dk1, dv1 = _attend_bwd(dc1, st["ps1"], st["q1"], st["k1"], st["v1"],
                                n_head, cdt)
    dx = (dx + _mm(dq1, w["wq_s"], cdt) + _mm(dk1, w["wk_s"], cdt)
          + _mm(dv1, w["wv_s"], cdt))
    dx = dropmul(dx, seed, SITE_INPUT, p_input)

    x_, r1 = (_flat(st[k], lp, cdt) for k in ("x", "r1"))
    enc_ = _flat(st["enc"], lep, cdt)
    prods = [
        Product("wq_s", "bq_s", _flat(dq1, lp, cdt), x_, dq1.sum(1)),
        Product("wk_s", "bk_s", _flat(dk1, lp, cdt), x_, dk1.sum(1)),
        Product("wv_s", "bv_s", _flat(dv1, lp, cdt), x_, dv1.sum(1)),
        Product("wo_s", "bo_s", _flat(do1, lp, cdt), _flat(st["c1"], lp, cdt),
                do1.sum(1)),
        Product("wq_c", "bq_c", _flat(dq2, lp, cdt), r1, dq2.sum(1)),
        Product("wk_c", "bk_c", _flat(dk2, lep, cdt), enc_, dk2.sum(1)),
        Product("wv_c", "bv_c", _flat(dv2, lep, cdt), enc_, dv2.sum(1)),
        Product("wo_c", "bo_c", _flat(do2, lp, cdt), _flat(st["c2"], lp, cdt),
                do2.sum(1)),
    ]
    return dx, denc, prods


def weight_grads_plain(prods: List[Product]) -> Dict[str, torch.Tensor]:
    """Plain version of ``weight_grads``: {w: Pᵀ·Q, b: Σ part}, float32."""
    out = {}
    for pr in prods:
        out[pr.w] = pr.P.to(torch.float32).t() @ pr.Q.to(torch.float32)
        out[pr.b] = pr.part.sum(0)
    return out


def train_ffn_bwd_plain(r2, dy, kp, w, seed, *, p=0.5,
                        compute_dtype=torch.bfloat16):
    """(dr2, {wi, bi, wo2, bo2}) of navc_tpu's FFN backward, plain."""
    dr2, prods = ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=p,
                                        compute_dtype=compute_dtype)
    return dr2, weight_grads_plain(prods)


def train_attn_bwd_plain(x, enc, dr2, kp, w, seed, *, n_head, causal=False,
                         p=0.5, p_input=0.0, compute_dtype=torch.bfloat16):
    """(dx, denc, the 16 attention gradients) of navc_tpu's attention
    backward, plain."""
    dx, denc, prods = attn_bwd_operands_plain(
        x, enc, dr2, kp, w, seed, n_head=n_head, causal=causal, p=p,
        p_input=p_input, compute_dtype=compute_dtype)
    return dx, denc, weight_grads_plain(prods)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

WS_X, WS_C1, WS_R1, WS_C2, WS_DO1, WS_DQ1, WS_DK1, WS_DV1, WS_DO2, WS_DQ2, \
    WS_ENC, WS_DK2, WS_DV2, WS_G, WS_DA, WS_DD = range(16)
MAX_PRODUCTS = 8


class TrainArgs(ctypes.Structure):
    """Mirror of ``struct TrainArgs`` in csrc/layer_common.cuh."""
    _fields_ = ([("x", ctypes.c_void_p), ("enc", ctypes.c_void_p),
                 ("kp", ctypes.c_void_p), ("seed", ctypes.c_void_p),
                 ("w", ctypes.c_void_p * 8), ("b", ctypes.c_void_p * 8)]
                + [(f, ctypes.c_void_p) for f in (
                    "wi", "bi", "wo2", "bo2", "out", "r2", "dy", "dr2", "dx",
                    "denc")]
                + [("ws", ctypes.c_void_p * 16), ("part", ctypes.c_void_p * 10),
                   ("scr", ctypes.c_void_p * 6)]
                + [(f, ctypes.c_int) for f in (
                    "out_bf16", "n", "L", "Le", "H", "I", "n_head", "causal",
                    "Lp", "Lep", "on_hidden", "on_input")]
                + [("th_hidden", ctypes.c_uint),
                   ("th_input", ctypes.c_uint), ("keep_hidden", ctypes.c_float),
                   ("keep_input", ctypes.c_float), ("scale", ctypes.c_float)])


class _ProductArgs(ctypes.Structure):
    """Mirror of ``struct ProductArgs``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("P", "Q", "C", "part", "db")]
                + [(f, ctypes.c_int) for f in ("R", "M", "K", "N", "tile0", "bias0")])


class _WgradArgs(ctypes.Structure):
    _fields_ = [("prod", _ProductArgs * MAX_PRODUCTS), ("count", ctypes.c_int),
                ("blocks", ctypes.c_int)]


WGRAD_TILE = 128        # the reduction's output tile: 128 of M x 128 of K
WGRAD_BIAS_COLS = 288   # bias columns per block of the reduction (a thread each)


def wgrad_plan(shapes: List[Tuple[int, int]]) -> Tuple[List[int], List[int], int]:
    """The reduction's grid for products of (M, K) outputs: (first tile
    block of each product, first bias block of each product, blocks). The
    tile blocks come first, product by product, each product's tiles
    row-major over its (M / 128, K / 128) grid; then the bias blocks."""
    tile0, bias0, b = [], [], 0
    for m, k in shapes:
        tile0.append(b)
        b += -(-m // WGRAD_TILE) * -(-k // WGRAD_TILE)
    for m, _ in shapes:
        bias0.append(b)
        b += -(-m // WGRAD_BIAS_COLS)
    return tile0, bias0, b


def _lib():
    args, ptr = ctypes.POINTER(TrainArgs), ctypes.c_void_p
    return _build.load("fused_layer_train", {
        "navc_train_fwd": [args, ptr, ptr], "navc_fused_layer_unfolded": [args, ptr, ptr],
        "navc_train_ffn_bwd": [args, ptr],
        "navc_train_attn_bwd": [args, ptr, ptr],
        "navc_train_wgrad": [ctypes.POINTER(_WgradArgs), ptr]})


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _p(t):
    return None if t is None else t.data_ptr()


def _threshold(p: float) -> Tuple[int, int, float]:
    """(on, threshold, keep scale) of a dropout probability."""
    if p <= 0.0:
        return 0, 0, 1.0
    return 1, int(round(p * float(1 << 24))), 1.0 / (1.0 - p)


def kernel_weights(weights: Dict[str, torch.Tensor], compute_dtype
                   ) -> Dict[str, torch.Tensor]:
    """Layer weights as kernel operands: matrices in the compute dtype,
    biases float32, all contiguous."""
    return {k: v.to(compute_dtype if v.dim() == 2 else torch.float32).contiguous()
            for k, v in weights.items()}


def check_operands(x, enc, kp, w, n_head, compute_dtype):
    """Raise on what the kernels do not take; ``enc`` None for K12a."""
    if x.device.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % x.device)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the training kernels compute in bfloat16 only; "
                         "compute_dtype %s is not implemented on CUDA" % compute_dtype)
    n, l, h = x.shape
    inter = w["wi"].shape[0]
    checks = [
        (x.dtype == torch.float32, "x, dy and enc must be float32"),
        (enc is None or (enc.dtype == torch.float32 and enc.dim() == 3
                         and enc.shape[0] == n and enc.shape[2] == h
                         and enc.shape[1] <= MAX_ROWS),
         "enc must be float32 (N, Le <= %d, H)" % MAX_ROWS),
        (tuple(kp.shape) == (n, l) and kp.dtype == torch.bool, "kp must be bool (N, L)"),
        (l <= MAX_ROWS, "the decoder length must be <= %d" % MAX_ROWS),
        (h % 128 == 0 and h <= 512, "H must be a multiple of 128, <= 512"),
        (n_head is None or (h % n_head == 0 and (h // n_head) % 16 == 0
                            and n_head <= 8),
         "at most 8 heads, head width a multiple of 16"),
        (inter % 32 == 0 and tuple(w["wi"].shape) == (inter, h)
         and tuple(w["wo2"].shape) == (h, inter), "FFN width must be a multiple of 32"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    for k in WEIGHT_KEYS:
        t = w[k]
        want = torch.bfloat16 if t.dim() == 2 else torch.float32
        if t.dtype != want or t.device != x.device or not t.is_contiguous():
            raise ValueError("%s must be contiguous %s on %s" % (k, want, x.device))
    for k in MATS:
        if tuple(w[k].shape) != (h, h):
            raise ValueError("%s must be (H, H)" % k)
    for t in (x, kp) if enc is None else (x, enc, kp):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on %s" % x.device)


def check_aligned(what, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("%s must be 16-byte aligned (a TMA requirement)" % what)


def kernel_args(x, enc, kp, w, seed, n_head, causal, p, p_input, **ptrs):
    """The TrainArgs of a launch; ``seed`` the ``device_seed`` tensor, which
    the caller keeps alive until the launch is queued."""
    n, l, h = x.shape
    le = enc.shape[1]
    on, th, keep = _threshold(p)
    on_in, th_in, keep_in = _threshold(p_input)
    a = TrainArgs(
        x=_p(x), enc=_p(enc), kp=_p(kp), seed=_p(seed),
        w=(ctypes.c_void_p * 8)(*[_p(w[k]) for k in MATS]),
        b=(ctypes.c_void_p * 8)(*[_p(w[k]) for k in BIASES]),
        wi=_p(w["wi"]), bi=_p(w["bi"]), wo2=_p(w["wo2"]), bo2=_p(w["bo2"]),
        n=n, L=l, Le=le, H=h, I=w["wi"].shape[0], n_head=n_head,
        causal=int(causal), Lp=_round_up(l, ROW_TILE), Lep=_round_up(le, ROW_TILE),
        on_hidden=on, on_input=on_in,
        th_hidden=th, th_input=th_in, keep_hidden=keep,
        keep_input=keep_in, scale=1.0 / math.sqrt(h // n_head))
    for name, val in ptrs.items():
        if name in ("ws", "part", "scr"):
            arr = getattr(a, name)
            for i, t in val.items():  # a tensor or an address
                arr[i] = _p(t) if torch.is_tensor(t) else t
        else:
            setattr(a, name, val)
    return a


def fwd_scratch(n: int, l: int, le: int, h: int, inter: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The scratch of one forward call on the row walk (K11, and K1u on the
    same launches), {name: (shape, dtype)}: ``rows``, five bf16 tenants of
    the N·Lp decoder rows (x' then r1, Q1 then Q2, K1, V1, c1 then c2);
    ``enc_rows``, three of the N·Lep encoder rows (enc, K2, V2); the FFN
    activations ``g``; the float32 residual stream ``res`` (r1, then r2);
    and ``r2`` (N, Lp, H), which K11 returns. Lp, Lep: L and Le rounded up
    to ROW_TILE. Each alias is written after its first tenant's last reader
    in the launch order of navc_train_fwd. Every (rows, H) slice starts
    16-byte aligned, as TMA needs: H is a multiple of 128."""
    lp, lep = _round_up(l, ROW_TILE), _round_up(le, ROW_TILE)
    bf = torch.bfloat16
    return {"rows": ((5, n * lp, h), bf), "enc_rows": ((3, n * lep, h), bf),
            "g": ((n * lp, inter), bf), "res": ((n * lp, h), torch.float32),
            "r2": ((n, lp, h), bf)}


def fwd_call(entry, x, enc, kp, w, seed, n_head, causal, p, p_input, out,
             compute_dtype=torch.bfloat16):
    """The forward's launch sequence through the C entry ``entry``
    (navc_train_fwd, or K1u's navc_fused_layer_unfolded) into ``out``, on
    scratch allocated for the call (``fwd_scratch``). Returns r2. Raises on
    operands the kernels do not take."""
    check_operands(x, enc, kp, w, n_head, compute_dtype)
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("out_dtype must be bfloat16 or float32")
    check_aligned("the layer's matrices", *[w[k] for k in MATS + ("wi", "wo2")])
    seed = device_seed(seed, x.device)
    n, l, h = x.shape
    # in fwd_scratch's order; the tenants of rows and enc_rows by address
    rows, enc_rows, gel, res, r2 = (
        torch.empty(shape, dtype=dt, device=x.device)
        for shape, dt in fwd_scratch(n, l, enc.shape[1], h, w["wi"].shape[0]).values())
    if n:
        xr, q, k1, v1, c = (rows.data_ptr() + i * rows.stride(0) * 2 for i in range(5))
        enc_, k2, v2 = (enc_rows.data_ptr() + i * enc_rows.stride(0) * 2 for i in range(3))
        a = kernel_args(x, enc, kp, w, seed, n_head, causal, p, p_input, out=_p(out),
                        r2=_p(r2), out_bf16=int(out.dtype == torch.bfloat16),
                        ws={WS_X: xr, WS_R1: xr, WS_C1: c, WS_C2: c, WS_ENC: enc_,
                            WS_G: gel},
                        scr=dict(enumerate((q, k1, v1, q, k2, v2))))
        lib = _lib()
        _build.check(lib, getattr(lib, entry)(ctypes.byref(a), _p(res), _stream(x)),
                     entry[len("navc_"):])
    return r2


def train_fwd(x, enc, kp, w, seed, *, n_head, causal=False, p=0.5, p_input=0.0,
              compute_dtype=torch.bfloat16, out_dtype=torch.float32):
    """K11: the layer forward. x (N, L, H) float32 post-embedding states; enc
    (N, Le, H) float32; kp (N, L) bool, True at PAD; w ``kernel_weights``;
    seed an int or a (1,) int32 tensor on x's device. Returns (out (N, L, H)
    in ``out_dtype``, r2 (N, Lp, H) in the
    compute dtype, Lp = round_up(L, 16), zero rows after L)."""
    if x.device.type == "cpu":
        return train_fwd_plain(x, enc, kp, w, seed, n_head=n_head, causal=causal,
                               p=p, p_input=p_input, compute_dtype=compute_dtype,
                               out_dtype=out_dtype)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    r2 = fwd_call("navc_train_fwd", x, enc, kp, w, seed, n_head, causal, p, p_input,
                  out, compute_dtype)
    if x.shape[0]:
        _build.LAUNCHES.count("train_fwd")
    return out, r2


def ffn_bwd_operands(r2, dy, kp, w, seed, *, p=0.5, compute_dtype=torch.bfloat16):
    """K12a: the FFN backward. r2 from ``train_fwd``; dy (N, L, H) float32.
    Returns (dr2 (N, L, H) float32, [Product wi, Product wo2])."""
    if dy.device.type == "cpu":
        return ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=p,
                                      compute_dtype=compute_dtype)
    n, l, h = dy.shape
    lp = _round_up(l, ROW_TILE)
    check_operands(dy, None, kp, w, None, compute_dtype)
    if r2.dtype != torch.bfloat16 or tuple(r2.shape) != (n, lp, h) \
            or not r2.is_contiguous():
        raise ValueError("r2 must be train_fwd's contiguous bf16 (N, Lp, H)")
    check_aligned("r2, wi and wo2", r2, w["wi"], w["wo2"])
    seed = device_seed(seed, dy.device)
    inter = w["wi"].shape[0]
    dev = dy.device
    dr2 = torch.empty((n, l, h), dtype=torch.float32, device=dev)
    # g and da as one allocation (a view of each: fewer host operators)
    g, da = torch.empty((2, n * lp, inter), dtype=torch.bfloat16, device=dev).unbind(0)
    dd = torch.empty((n * lp, h), dtype=torch.bfloat16, device=dev)
    pbi = torch.empty((n, inter), dtype=torch.float32, device=dev)
    pbd = torch.empty((n, h), dtype=torch.float32, device=dev)
    if n:
        a = kernel_args(dy, dy.new_empty((n, 0, h)), kp, w, seed, 1, False, p, 0.0,
                        r2=_p(r2), dy=_p(dy), dr2=_p(dr2),
                        ws={WS_G: g, WS_DA: da, WS_DD: dd}, part={8: pbi, 9: pbd})
        lib = _lib()
        _build.check(lib, lib.navc_train_ffn_bwd(ctypes.byref(a), _stream(dy)),
                     "train_ffn_bwd")
        _build.LAUNCHES.count("train_ffn_bwd")
    return dr2, [Product("wi", "bi", da, r2.view(n * lp, h), pbi),
                 Product("wo2", "bo2", dd, g, pbd)]


ATTN_LP_ROWS = (WS_X, WS_C1, WS_R1, WS_C2, WS_DO1, WS_DQ1, WS_DK1, WS_DV1, WS_DO2, WS_DQ2)
ATTN_LEP_ROWS = (WS_ENC, WS_DK2, WS_DV2)


def attn_bwd_operands(x, enc, dr2, kp, w, seed, *, n_head, causal=False, p=0.5,
                      p_input=0.0, compute_dtype=torch.bfloat16):
    """K12b: the attention backward, recomputing the self- and
    cross-attention forward (K11's per-head softmax). Returns (dx (N, L, H),
    denc (N, Le, H), the 8 attention Products), float32."""
    if x.device.type == "cpu":
        return attn_bwd_operands_plain(x, enc, dr2, kp, w, seed, n_head=n_head,
                                       causal=causal, p=p, p_input=p_input,
                                       compute_dtype=compute_dtype)
    check_operands(x, enc, kp, w, n_head, compute_dtype)
    if dr2.dtype != torch.float32 or dr2.shape != x.shape or not dr2.is_contiguous():
        raise ValueError("dr2 must be contiguous float32 (N, L, H)")
    check_aligned("the attention weights", *[w[k] for k in MATS])
    seed = device_seed(seed, x.device)
    n, l, h = x.shape
    le = enc.shape[1]
    lp, lep = _round_up(l, ROW_TILE), _round_up(le, ROW_TILE)
    dev = x.device
    bf = torch.bfloat16

    def stack(k, rows, dtype=bf):  # k tensors of (rows, H) in one allocation
        return torch.empty((k, rows, h), dtype=dtype, device=dev).unbind(0)

    dx = torch.empty((n, l, h), dtype=torch.float32, device=dev)
    denc = torch.empty((n, le, h), dtype=torch.float32, device=dev)
    ws = dict(zip(ATTN_LP_ROWS, stack(len(ATTN_LP_ROWS), n * lp)))
    ws.update(zip(ATTN_LEP_ROWS, stack(len(ATTN_LEP_ROWS), n * lep)))
    part = dict(enumerate(stack(8, n, torch.float32)))
    # this call's scratch, by address: Q/K/V of both attentions (S_Q1 .. S_V2)
    # and dC of one (dC2, then dC1)
    lps, leps = torch.empty((5, n * lp, h), dtype=bf, device=dev), \
        torch.empty((2, n * lep, h), dtype=bf, device=dev)
    q1, k1, v1, q2, dc = (lps.data_ptr() + i * lps.stride(0) * 2 for i in range(5))
    k2, v2 = (leps.data_ptr() + i * leps.stride(0) * 2 for i in range(2))
    if n:
        a = kernel_args(x, enc, kp, w, seed, n_head, causal, p, p_input, dr2=_p(dr2),
                        dx=_p(dx), denc=_p(denc), ws=ws, part=part,
                        scr=dict(enumerate((q1, k1, v1, q2, k2, v2))))
        lib = _lib()
        _build.check(lib, lib.navc_train_attn_bwd(ctypes.byref(a), dc, _stream(x)),
                     "train_attn_bwd")
        _build.LAUNCHES.count("train_attn_bwd")
    spec = (("wq_s", "bq_s", WS_DQ1, WS_X), ("wk_s", "bk_s", WS_DK1, WS_X),
            ("wv_s", "bv_s", WS_DV1, WS_X), ("wo_s", "bo_s", WS_DO1, WS_C1),
            ("wq_c", "bq_c", WS_DQ2, WS_R1), ("wk_c", "bk_c", WS_DK2, WS_ENC),
            ("wv_c", "bv_c", WS_DV2, WS_ENC), ("wo_c", "bo_c", WS_DO2, WS_C2))
    return dx, denc, [Product(wn, bn, ws[pi], ws[qi], part[i])
                      for i, (wn, bn, pi, qi) in enumerate(spec)]


def weight_grads(prods: List[Product]) -> Dict[str, torch.Tensor]:
    """The weight-gradient reduction: for every Product, dW = Pᵀ·Q (bf16
    operands, float32 sums over all rows in a fixed order) and db = the
    column sum of its per-sequence partials, in one launch. P (R, M) and Q
    (R, K) contiguous bf16, 16-byte aligned, M and K multiples of 32; part
    (N, M) float32."""
    if prods[0].P.device.type == "cpu":
        return weight_grads_plain(prods)
    if len(prods) > MAX_PRODUCTS:
        raise ValueError("at most %d products per launch" % MAX_PRODUCTS)
    if any(t.device.type != "cuda" for pr in prods for t in (pr.P, pr.Q, pr.part)):
        raise ValueError("the kernel takes CUDA tensors, got %s" % prods[0].P.device)
    tile0, bias0, blocks = wgrad_plan([(pr.P.shape[1], pr.Q.shape[1]) for pr in prods])
    args = _WgradArgs(count=len(prods), blocks=blocks)
    out = {}
    for i, pr in enumerate(prods):
        (r, m), k = pr.P.shape, pr.Q.shape[1]
        if (pr.P.dtype != torch.bfloat16 or pr.Q.dtype != torch.bfloat16
                or pr.Q.shape[0] != r or m % 32 or k % 32
                or pr.part.dtype != torch.float32 or pr.part.shape[1] != m
                or not (pr.P.is_contiguous() and pr.Q.is_contiguous()
                        and pr.part.is_contiguous())):
            raise ValueError("product %s: P (R, M), Q (R, K) contiguous bf16 with "
                             "M and K multiples of 32, float32 partials (N, M)" % pr.w)
        if pr.P.data_ptr() % 16 or pr.Q.data_ptr() % 16:
            raise ValueError("product %s: P and Q must be 16-byte aligned (a TMA "
                             "requirement)" % pr.w)
        out[pr.w] = torch.empty((m, k), dtype=torch.float32, device=pr.P.device)
        out[pr.b] = torch.empty((m,), dtype=torch.float32, device=pr.P.device)
        args.prod[i] = _ProductArgs(P=_p(pr.P), Q=_p(pr.Q), C=_p(out[pr.w]),
                                    part=_p(pr.part), db=_p(out[pr.b]), R=r, M=m,
                                    K=k, N=pr.part.shape[0], tile0=tile0[i],
                                    bias0=bias0[i])
    lib = _lib()
    _build.check(lib, lib.navc_train_wgrad(ctypes.byref(args), _stream(prods[0].P)),
                 "train_wgrad")
    _build.LAUNCHES.count("train_wgrad")
    return out


def train_ffn_bwd(r2, dy, kp, w, seed, *, p=0.5, compute_dtype=torch.bfloat16):
    """(dr2, {wi, bi, wo2, bo2}): K12a, then the reduction."""
    dr2, prods = ffn_bwd_operands(r2, dy, kp, w, seed, p=p,
                                  compute_dtype=compute_dtype)
    return dr2, weight_grads(prods)


def train_attn_bwd(x, enc, dr2, kp, w, seed, *, n_head, causal=False, p=0.5,
                   p_input=0.0, compute_dtype=torch.bfloat16):
    """(dx, denc, the 16 attention gradients): K12b, then the reduction."""
    dx, denc, prods = attn_bwd_operands(
        x, enc, dr2, kp, w, seed, n_head=n_head, causal=causal, p=p,
        p_input=p_input, compute_dtype=compute_dtype)
    return dx, denc, weight_grads(prods)


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


class _Opts(NamedTuple):
    n_head: int
    causal: bool
    p: float
    p_input: float
    cdt: torch.dtype
    out_dtype: torch.dtype


class _FusedTrainLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, enc, kp, seed, opts, *weights):
        w = kernel_weights(dict(zip(WEIGHT_KEYS, weights)), opts.cdt)
        x32 = x.detach().to(torch.float32).contiguous()
        e32 = enc.detach().to(torch.float32).contiguous()
        out, r2 = train_fwd(x32, e32, kp, w, seed, n_head=opts.n_head,
                            causal=opts.causal, p=opts.p, p_input=opts.p_input,
                            compute_dtype=opts.cdt, out_dtype=opts.out_dtype)
        ctx.save_for_backward(x32, e32, kp, r2, *[w[k] for k in WEIGHT_KEYS])
        ctx.seed, ctx.opts = seed, opts
        ctx.dtypes = (x.dtype, enc.dtype, [t.dtype for t in weights])
        return out

    @staticmethod
    def backward(ctx, dy):
        x, enc, kp, r2, *wl = ctx.saved_tensors
        w = dict(zip(WEIGHT_KEYS, wl))
        o, seed = ctx.opts, ctx.seed
        dr2, grads = train_ffn_bwd(r2, dy.to(torch.float32).contiguous(), kp, w,
                                   seed, p=o.p, compute_dtype=o.cdt)
        dx, denc, attn = train_attn_bwd(x, enc, dr2, kp, w, seed, n_head=o.n_head,
                                        causal=o.causal, p=o.p, p_input=o.p_input,
                                        compute_dtype=o.cdt)
        grads.update(attn)
        xdt, edt, wdts = ctx.dtypes
        return (dx.to(xdt), denc.to(edt), None, None, None,
                *[grads[k].to(dt) for k, dt in zip(WEIGHT_KEYS, wdts)])


def layer_train_weights(layer) -> Dict[str, torch.Tensor]:
    """The live parameters of a ``models.layers.BertLayer`` by WEIGHT_KEYS
    (nn.Linear's (out, in) matrices): gradients of the fused layer reach
    them."""
    out = {}
    for sfx, block in (("s", layer.attention), ("c", layer.attend_to_enc_output)):
        for name, lin in (("q", block.self.query), ("k", block.self.key),
                          ("v", block.self.value), ("o", block.output.dense)):
            out["w%s_%s" % (name, sfx)] = lin.weight
            out["b%s_%s" % (name, sfx)] = lin.bias
    out["wi"], out["bi"] = layer.intermediate.dense.weight, layer.intermediate.dense.bias
    out["wo2"], out["bo2"] = layer.output.dense.weight, layer.output.dense.bias
    return out


def fused_bert_layer_train(x, enc, kp_mask, weights: Dict[str, torch.Tensor],
                           seed, *, n_head: int = 8, causal: bool = False,
                           p_hidden: float = 0.5, p_input: float = 0.0,
                           compute_dtype=torch.bfloat16,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Training-mode BertLayer with the hand-written backward.

    x: (N, L, H) post-embedding states; enc: (N, Le, H) encoder output;
    kp_mask: (N, L) bool, True at PAD; weights: WEIGHT_KEYS -> tensors in
    nn.Linear's layout (``layer_train_weights``); seed: the dropout
    stream's seed, which the caller varies per step and pass: an int or a
    (1,) int32 tensor (on the card, on x's device: the kernels read it
    there, forward and backward, and the host never does). ``causal=True``
    gives the ARFormer variant. Returns (N, L, H) in ``out_dtype``;
    gradients flow to x, enc and every weight."""
    opts = _Opts(int(n_head), bool(causal), float(p_hidden), float(p_input),
                 compute_dtype, out_dtype)
    kp = kp_mask if kp_mask.dtype == torch.bool else kp_mask > 0.5
    return _FusedTrainLayer.apply(x, enc, kp.contiguous(), seed, opts,
                                  *[weights[k] for k in WEIGHT_KEYS])
