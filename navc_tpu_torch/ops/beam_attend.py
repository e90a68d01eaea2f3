"""The AR beam step's attention kernels: the fused cached self-attention step
(K6) and the beam cross-attention (K7).

Port of navc_tpu/ops/beam_attend.py. ``beam_attend_step`` does in one
call what the beam step otherwise does in three passes over the K/V
caches: the ancestry permute by the PREVIOUS step's selection, the write of
the new position, and the causal cached attention (float32 softmax,
additive key mask). On the card it is one launch of a position-split
kernel: a block per instance and run of positions stages, permutes,
appends and attends its run (``attend_runs`` plans the run length); with
more than one run the runs' partial softmaxes are merged, by each
instance's last block when the blocks take more than one wave, else by a
second launch. ``cross_attend`` is the mask-free attention of each beam
row over its instance's encoder positions: on the card a block per
instance and group of heads (``cross_groups`` plans the group and the
block's thread layout) stages that instance's K/V slice once and attends its
k rows from the stage.

Each wrapper launches its CUDA kernel (csrc/beam_attend.cu) for CUDA
tensors and raises if the build or the launch fails; only for CPU tensors
does it run the plain version beside it: float32 PyTorch on the stored cache
values, with no bf16 rounding of the softmax weights (the JAX kernels keep
them in float32, unlike the XLA ``attend`` of decoding/beam.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build
from .beam_permute import ancestor_rows

MAX_BEAM = 32      # rows of one instance a K6 block owns
MAX_HEAD_DIM = 128  # head width the kernels take, at most
RUN_MAX = 32        # K6 positions a block owns, at most
STAGE_BYTES = 64 * 1024   # K6's planned stage a block: four blocks an SM
STAGE_MAX = 192 * 1024    # the most a K6 or K7 block stages (csrc/beam_attend.cu)
NTHREADS = 256            # threads of a K6 or K7 block, at most (csrc/beam_attend.cu)
_SIGNATURES = {
    "navc_beam_attend_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "navc_cross_attend": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def beam_attend_eligible(b: int, h: int) -> bool:
    """The structural terms of navc_tpu's ``beam_attend_eligible``
    (beam_attend.py:116-122; its VMEM term is a TPU limit and is dropped),
    kept so that both packages choose the same attention route."""
    return b % 16 == 0 and h % 128 == 0


def kernel_shape_ok(k: int, h: int, n_head: int, itemsize: int) -> bool:
    """Shapes the K6/K7 kernels take: k <= MAX_BEAM rows per instance, head
    width <= MAX_HEAD_DIM, 16-byte cache positions."""
    return (1 <= k <= MAX_BEAM and h % n_head == 0
            and h // n_head <= MAX_HEAD_DIM and (h * itemsize) % 16 == 0)


def stage_bytes(k: int, h: int, n_head: int, itemsize: int, run: int) -> int:
    """Shared memory of a K6 block: both caches' k rows over ``run``
    positions, each position row padded by 16 bytes, then each (row,
    head)'s max and sum and its ``run`` scores (float32)."""
    return 2 * k * run * (h * itemsize + 16) + k * n_head * (8 + 4 * run)


def attend_runs(b: int, k: int, tpos: int, h: int, n_head: int, itemsize: int,
                sms: int) -> Tuple[int, int]:
    """K6's run length: (run, runs), the positions of one instance's k rows
    that a block stages and attends, and the blocks per instance.
    Enough runs that the b * runs blocks give each of ``sms`` SMs two; no
    run longer than STAGE_BYTES of stage hold (one position at least) or
    than RUN_MAX; runs of near-equal length, together covering [0, tpos]
    once. Raises ValueError if one position exceeds STAGE_MAX."""
    per_pos = stage_bytes(k, h, n_head, itemsize, 1)
    if per_pos > STAGE_MAX:
        raise ValueError("beam_attend_step: one position of the k rows takes %d bytes "
                         "of stage, more than %d" % (per_pos, STAGE_MAX))
    p = tpos + 1
    cap = max(1, min(RUN_MAX, STAGE_BYTES // per_pos))
    runs = min(p, max(-(-2 * sms // b), -(-p // cap)))
    run = -(-p // runs)
    return run, -(-p // run)


def cross_stage_bytes(k: int, te: int, h: int, n_head: int, itemsize: int,
                      g: int) -> int:
    """Shared memory of a K7 block owning ``g`` heads: the Te positions of
    its K and V slices (g * dh elements, each position padded by 16 bytes),
    its k query rows' g * dh float32 columns (padded by 16 bytes), each
    head's Te x kp exponentials (kp = k rounded up to 4) and 4 floats more,
    each (row, head)'s sum (float32)."""
    gw, kp = g * (h // n_head), -(-k // 4) * 4
    return (2 * te * (gw * itemsize + 16) + k * (gw + 4) * 4 + g * (te * kp + 4) * 4
            + k * g * 4)


def cross_group_ok(g: int, k: int, te: int, h: int, n_head: int,
                   itemsize: int) -> bool:
    """Whether K7 takes heads in groups of ``g``: g divides the heads, a
    group's slice of a position is a whole number of 16-byte vectors (the
    stage's copies), and its stage fits STAGE_MAX."""
    return (g >= 1 and n_head % g == 0
            and g * (h // n_head) * itemsize % 16 == 0
            and cross_stage_bytes(k, te, h, n_head, itemsize, g) <= STAGE_MAX)


def cross_groups(b: int, k: int, te: int, h: int, n_head: int, itemsize: int,
                 sms: int) -> Tuple[int, bool]:
    """K7's plan: (g, reuse). g, the heads a block owns, of b * (n_head / g)
    blocks: the largest g the kernel takes (``cross_group_ok``) whose grid
    still gives each of ``sms`` SMs a block (fewer, larger blocks: less
    fixed cost a head), else the smallest g it takes (the most blocks).
    ``reuse``, the block's thread layout: a thread per (head, position)
    scores all k rows and a thread per column pair sums them, reading each
    staged element once; taken where its column pairs fill a block (g * dh
    >= 2 * NTHREADS) or the grid gives each SM more than four blocks (the
    card's throughput, not a block's latency, sets the time). Else a group
    of lanes per (row, head) and a thread per (row, column): more threads,
    a shorter chain a block. Raises ValueError if the kernel takes no g (a
    stage of even one head above STAGE_MAX)."""
    ok = [g for g in range(1, n_head + 1) if cross_group_ok(g, k, te, h, n_head, itemsize)]
    if not ok:
        raise ValueError("cross_attend: no head group of %d heads, Te %d, k %d fits "
                         "%d bytes of stage" % (n_head, te, k, STAGE_MAX))
    filling = [g for g in ok if b * (n_head // g) >= sms]
    g = max(filling) if filling else min(ok)
    return g, g * (h // n_head) >= 2 * NTHREADS or b * (n_head // g) > 4 * sms


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _softmax_attend(q, keys, values, n_head, mask=None):
    """softmax(q . K * (1/sqrt(dh)) + mask) V per head in float32.
    q (N, H); keys, values (N, P, H); mask (N, P) additive or None."""
    n, p, h = keys.shape
    dh = h // n_head
    scores = torch.einsum("nhd,nphd->nhp", q.view(n, n_head, dh),
                          keys.view(n, p, n_head, dh)) * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = scores + mask[:, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    return torch.einsum("nhp,nphd->nhd", probs,
                        values.view(n, p, n_head, dh)).reshape(n, h)


def beam_attend_step_plain(kc, vc, q, kt, vt, prev_k, amask, tpos: int,
                           n_head: int):
    """Plain version of ``beam_attend_step`` (in place, as the kernel)."""
    n = kc.shape[0]
    h = q.shape[1]
    src = ancestor_rows(prev_k)
    kc.copy_(kc.index_select(0, src))
    vc.copy_(vc.index_select(0, src))
    k3, v3 = kc.view(n, -1, h), vc.view(n, -1, h)
    k3[:, tpos] = kt.to(kc.dtype)
    v3[:, tpos] = vt.to(vc.dtype)
    att = _softmax_attend(q.float(), k3[:, :tpos + 1].float(),
                          v3[:, :tpos + 1].float(), n_head,
                          amask[:, :tpos + 1].float())
    return kc, vc, att


def cross_attend_plain(q, ke, ve, n_head: int):
    """Plain version of ``cross_attend``."""
    k = q.shape[0] // ke.shape[0]
    return _softmax_attend(q.float(),
                           torch.repeat_interleave(ke.float(), k, dim=0),
                           torch.repeat_interleave(ve.float(), k, dim=0),
                           n_head)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(tensors, f32_names, what):
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError("the kernel takes CUDA tensors, got %s" % dev)
    for name, t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous and on %s"
                             % (what, name, dev))
        if name in f32_names and t.dtype != torch.float32:
            raise TypeError("%s: %s must be float32, got %s"
                            % (what, name, t.dtype))


def beam_attend_step(kc: torch.Tensor, vc: torch.Tensor, q: torch.Tensor,
                     kt: torch.Tensor, vt: torch.Tensor, prev_k: torch.Tensor,
                     amask: torch.Tensor, tpos: int, n_head: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: one fused cached-attention beam step.

    kc, vc: (N, L*H) caches, N = b*k, bf16 or float32, updated IN PLACE and
    returned; q, kt, vt: (N, H) float32 values for position ``tpos``;
    prev_k: (b, k) int32 ancestor slots of the previous selection; amask:
    (N, L) float32 additive key mask. Returns (kc, vc, att (N, H) float32).
    Cache positions past ``tpos`` are unspecified afterwards.
    """
    if kc.device.type == "cpu":
        return beam_attend_step_plain(kc, vc, q, kt, vt, prev_k, amask, tpos,
                                      n_head)
    _check([("kc", kc), ("vc", vc), ("q", q), ("kt", kt), ("vt", vt),
            ("prev_k", prev_k), ("amask", amask)],
           ("q", "kt", "vt", "amask"), "beam_attend_step")
    n, h = q.shape
    b, k = prev_k.shape
    l = amask.shape[1]
    if (kc.dtype not in (torch.bfloat16, torch.float32) or vc.dtype != kc.dtype
            or prev_k.dtype != torch.int32 or b * k != n
            or tuple(kc.shape) != (n, l * h) or vc.shape != kc.shape
            or tuple(kt.shape) != (n, h) or tuple(vt.shape) != (n, h)
            or tuple(amask.shape) != (n, l) or not 0 <= tpos < l
            or not kernel_shape_ok(k, h, n_head, kc.element_size())):
        raise ValueError("beam_attend_step: shapes or types the kernel does "
                         "not take")
    att = torch.empty((n, h), dtype=torch.float32, device=q.device)
    if n == 0:
        return kc, vc, att
    run, runs = attend_runs(b, k, tpos, h, n_head, kc.element_size(),
                            _sm_count(q.device.index or 0))
    part = None
    if runs > 1:
        # the runs' partials: weighted V sums (N, runs, H) and (max, sum of
        # exponentials) per (row, run, head); then a counter per instance,
        # zero, of its runs done (where its last block merges them)
        cells = runs * n * (h + 2 * n_head)
        part = torch.empty(cells + b, dtype=torch.float32, device=q.device)
        part[cells:].zero_()
    lib = _build.load("beam_attend", _SIGNATURES)
    code = lib.navc_beam_attend_step(
        _ptr(kc), _ptr(vc), _ptr(q), _ptr(kt), _ptr(vt), _ptr(prev_k),
        _ptr(amask), _ptr(att), None if part is None else _ptr(part), n, k, l, h,
        n_head, int(tpos), 1.0 / math.sqrt(h // n_head),
        int(kc.dtype == torch.float32), run, _stream(q))
    _build.check(lib, code, "beam_attend_step")
    _build.LAUNCHES.count("beam_attend_step")
    return kc, vc, att


def cross_attend(q: torch.Tensor, ke: torch.Tensor, ve: torch.Tensor,
                 n_head: int) -> torch.Tensor:
    """K7: softmax(q K^T / sqrt(dh)) V per head, without a mask.

    q: (N, H) float32, N = b*k beam rows; ke, ve: (b, Te, H) per-instance
    encoder keys and values, bf16 or float32 (row r reads instance r // k).
    Returns (N, H) float32.
    """
    if q.device.type == "cpu":
        return cross_attend_plain(q, ke, ve, n_head)
    _check([("q", q), ("ke", ke), ("ve", ve)], ("q",), "cross_attend")
    n, h = q.shape
    b, te = ke.shape[:2]
    if (ke.dtype not in (torch.bfloat16, torch.float32) or ve.dtype != ke.dtype
            or ke.dim() != 3 or ke.shape != ve.shape or ke.shape[2] != h
            or b == 0 or n % b or te == 0
            or not kernel_shape_ok(n // b, h, n_head, ke.element_size())):
        raise ValueError("cross_attend: shapes or types the kernel does not take")
    if any(t.data_ptr() % 16 for t in (q, ke, ve)):
        raise ValueError("cross_attend: q, ke, ve must be 16-byte aligned (cp.async)")
    k = n // b
    groups, reuse = cross_groups(b, k, te, h, n_head, ke.element_size(),
                                 _sm_count(q.device.index or 0))
    att = torch.empty((n, h), dtype=torch.float32, device=q.device)
    lib = _build.load("beam_attend", _SIGNATURES)
    code = lib.navc_cross_attend(
        _ptr(q), _ptr(ke), _ptr(ve), _ptr(att), n, k, te, h, n_head,
        1.0 / math.sqrt(h // n_head), int(ke.dtype == torch.float32), groups, int(reuse),
        _stream(q))
    _build.check(lib, code, "cross_attend")
    _build.LAUNCHES.count("cross_attend")
    return att
