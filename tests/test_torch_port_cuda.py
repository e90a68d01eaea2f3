"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
no NVIDIA card is present. chip_smoke.py checks the kernels at the NACF and
ARB main paths' shapes; these tests cover the other shapes the kernels
accept — ragged row tiles, a vocab edge inside a tile, canvases and encoder
lengths below 32, one query tile, H = 128 and 256, beam sizes 1 to 8,
batches that are no multiple of 16, K6 at the B=1024 decode's 5120 rows,
with an identity ancestry and with runs of positions that do not divide
tpos, K7 at 5120 rows, in each head group, at Te 1 and 13 and beam 1 and
32, K1u with a float32 output — plus the wrappers' refusals and launch
counts, and that K1, K6, K7 and K1u give the same bits in two calls (K1u
K11's at p = 0); K1 and K2 walking only the live rows of canvases at
extents 4 to 32 with interior PAD (their plan, their zero rows, each
canvas's rows whatever the others' extents); and the decodes' CUDA
graphs (``test_graphs_*``: replayed tokens bit for bit the eager route's,
refilled static inputs, cloned outputs, launches per replay, ``refresh``
after a weight change, old graphs in reference cycles outliving a
capture, a failed capture raising;
``test_cond_graphs_*``: a body under an IF node skipped and counted, the
replayed l2r and ef bit for bit and launch for launch the eager route's
at 16 and 64 videos, no sync in a replayed l2r decode, ef's flags read one
block late, ef's stall, the full-prefix beam through K1 once per step);
NAB's and ARB2's requests through a replaying StreamingCaptioner, its
request marks and in-flight count under a profile; and the
compiled training step (``test_train_graphs_*``: the replayed NACF, ARB2
and NAB steps bit for bit the eager ones, fresh masks per replay, the lr tensor
followed, the card's capturable optimizer replayed against torch's CPU
optimizer with a float lr, graphs dropped after an optimizer reload, a
batch already on the card, the eval-loss step, no sync in an eager step),
K11/K12a/K12b with a device seed, navc_tpu's route switches
(``test_switch_*``: each kernel's launches on and off its route, the
switched decodes and steps replayed bit for bit), SelfMask's beam through
K5-K7, ``cfg.remat`` bit for bit remat off on both training routes, data
and tensor parallelism (``test_parallel_*``: two ranks on the card over
gloo against one process, gradient by gradient; one rank on NCCL, its
step captured and replayed; ``jit=True`` on a gloo group refused) and the
ResNet feature extractor against the CPU; and the MLAMoE language model
(K5's streamed walk at D 2048 and V 163,840, K13, the grouped experts
against a loop, the captured decode at Kimi-VL-A3B's published widths
against the plain reference).
Run them on a machine with a card:

    python3 -m pytest tests/test_torch_port_cuda.py -q --noconftest

(``--noconftest``: the shared conftest imports JAX, which this file does
not need.) Tolerances are chip_smoke.py's: hidden states 5e-2 absolute (a
float32 sum-order flip of one bf16 rounding propagates through the layer),
probabilities 1e-4 relative, ids equal where the top-2 logit margin is
above 1e-3; top-k log-probs and attention outputs 1e-4 absolute (float32
sums in another order, an online softmax against a one-pass one); the cache
permute and cache writes exactly; the weight-gradient reduction and the
vocab cross-entropy backward (K10) as the training kernels below, exactly
on integer operands and bit for bit between two calls.
"""

import copy
import ctypes
import math
import pickle

import numpy as np
import pytest
import torch

from navc_tpu_torch.ops import _build, beam_attend
from navc_tpu_torch.ops.beam_attend import (beam_attend_step,
                                            beam_attend_step_plain,
                                            cross_attend, cross_attend_plain,
                                            cross_group_ok, cross_groups)
from navc_tpu_torch.ops.beam_permute import (permute_beam_caches,
                                             permute_beam_caches_plain)
from navc_tpu_torch.ops.fused_layer import (LayerWeights, fused_layer,
                                            fused_layer_plain, fused_layer_qsub,
                                            fused_layer_qsub_plain)
from navc_tpu_torch.ops.vocab_fused import (project_argmax,
                                            project_argmax_plain,
                                            project_gather_prob,
                                            project_gather_prob_plain,
                                            project_topk, project_topk_plain)

HID_TOL = 5e-2
ATT_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _weights(h, inter, g, dev):
    def mat(o, i):
        return (torch.rand(o, i, generator=g) * 2 - 1).div(math.sqrt(i)).to(
            dev, torch.bfloat16)

    def vec(o):
        return (torch.rand(o, generator=g) * 0.2 - 0.1).to(dev)

    fields = {}
    for name in ("q", "k", "v", "o"):
        for sfx in ("s", "c"):
            fields["w%s_%s" % (name, sfx)] = mat(h, h)
            fields["b%s_%s" % (name, sfx)] = vec(h)
    fields.update(wi=mat(inter, h), bi=vec(inter), wo2=mat(h, inter), bo2=vec(h))
    return LayerWeights(**fields)


def _layer_inputs(n, l, le, h, g, dev):
    raw = torch.randn(n, l, h, generator=g).to(dev, torch.bfloat16)
    static = torch.randn(n, l, h, generator=g).to(dev, torch.bfloat16)
    lengths = torch.randint(1, l + 1, (n,), generator=g)
    lengths[0] = l
    kp = (torch.arange(l)[None] >= lengths[:, None]).to(dev)
    ke = torch.randn(n, le, h, generator=g).to(dev, torch.bfloat16)
    ve = torch.randn(n, le, h, generator=g).to(dev, torch.bfloat16)
    lns = (1 + 0.1 * torch.randn(h, generator=g)).to(dev)
    lnb = (0.1 * torch.randn(h, generator=g)).to(dev)
    return raw, static, kp, ke, ve, lns, lnb


LAYER_SHAPES = [  # n, L, Le, H, heads, FFN
    (3, 32, 16, 512, 8, 2048),
    (5, 10, 8, 128, 2, 256),
    (4, 17, 20, 256, 16, 272),
    (70, 16, 32, 128, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
def test_fused_layer_matches_plain(cuda, shape, causal):
    n, l, le, h, heads, inter = shape
    g = _gen(sum(shape))
    w = _weights(h, inter, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(n, l, le, h, g, cuda)
    args = (raw, static, kp, ke, ve, w, lns, lnb)
    before = _build.LAUNCHES["fused_layer"]
    out = fused_layer(*args, n_head=heads, causal=causal)
    assert _build.LAUNCHES["fused_layer"] == before + 1
    ref = fused_layer_plain(*args, n_head=heads, causal=causal)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= HID_TOL
    assert torch.all(out[kp] == 0)
    out16 = fused_layer(*args, n_head=heads, causal=causal, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("k", [5, 16, 24])
def test_fused_layer_qsub_matches_plain_and_dense_rows(cuda, shape, k):
    n, l, le, h, heads, inter = shape
    k = min(k, l)
    g = _gen(sum(shape) + k)
    w = _weights(h, inter, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(n, l, le, h, g, cuda)
    mask_row = torch.randn(h, generator=g).to(cuda, torch.bfloat16)
    qidx = torch.full((n, k), -1, dtype=torch.int32)
    for i in range(n):
        real = int((~kp[i]).sum())
        pos = torch.randperm(real, generator=g)[:min(k, real)].sort().values
        qidx[i, :len(pos)] = pos.to(torch.int32)
    qidx = qidx.to(cuda)
    used = qidx >= 0
    sel = torch.zeros(n, l, dtype=torch.bool, device=cuda)
    rows_of = torch.arange(n, device=cuda)[:, None].expand(n, k)
    sel[rows_of[used], qidx[used].long()] = True
    raw = torch.where(sel[..., None], mask_row, raw)
    args = (raw, static, kp, ke, ve, w, lns, lnb)
    before = _build.LAUNCHES["fused_layer_qsub"]
    out = fused_layer_qsub(qidx, mask_row, *args, n_head=heads)
    assert _build.LAUNCHES["fused_layer_qsub"] == before + 1
    ref = fused_layer_qsub_plain(qidx, mask_row, *args, n_head=heads)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= HID_TOL
    assert torch.all(out[~used] == 0)
    dense = fused_layer(*args, n_head=heads)
    rows = torch.gather(dense, 1, qidx.clamp(min=0).long()[..., None].expand(-1, -1, h))
    assert (out - rows)[used].abs().max().item() <= HID_TOL


# K2 on its serving walk (csrc/fused_layer.cu): N * K query rows flattened
# (37 * 16 and 5 * 16 rows leave a ragged last row tile), K 8 to 32 with
# unused slots, one canvas all PAD (its slots all unused), raw at the query
# positions left as it is (the kernel must read the <mask> row there), f32
# and bf16 outputs. N = 384 with K = 24 is the decode's first sparse step
# (128 x 128 tiles), K = 8 its last (64 x 128).
QSUB_CASES = [  # n, L, Le, H, heads, FFN, K, out dtype
    (384, 32, 16, 512, 8, 2048, 24, torch.bfloat16),
    (384, 32, 16, 512, 8, 2048, 8, torch.float32),
    (37, 30, 16, 512, 8, 2048, 16, torch.float32),
    (9, 32, 8, 128, 2, 256, 32, torch.bfloat16),
    (5, 13, 20, 256, 16, 272, 16, torch.bfloat16),
]


def _query_slots(kp, k, g):
    """qidx (N, K) int32: up to K distinct non-PAD positions of each canvas
    in order, at least one slot of each canvas unused, -1 after them."""
    n = kp.shape[0]
    qidx = torch.full((n, k), -1, dtype=torch.int32)
    for i in range(n):
        real = int((~kp[i]).sum())
        pos = torch.randperm(real, generator=g)[:min(k - 1, real)].sort().values
        qidx[i, :len(pos)] = pos.to(torch.int32)
    return qidx.to(kp.device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QSUB_CASES, ids=lambda c: "x".join(map(str, c[:7])) + (
    "-bf16" if c[7] == torch.bfloat16 else "-f32"))
def test_fused_layer_qsub_walk_matches_plain_and_dense_rows(cuda, case):
    n, l, le, h, heads, inter, k, dtype = case
    g = _gen(sum(case[:7]))
    w = _weights(h, inter, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(n, l, le, h, g, cuda)
    kp[-1] = True  # a canvas all PAD
    mask_row = torch.randn(h, generator=g).to(cuda, torch.bfloat16)
    qidx = _query_slots(kp, k, g)
    used = qidx >= 0
    args = (raw, static, kp, ke, ve, w, lns, lnb)
    before = _build.LAUNCHES["fused_layer_qsub"]
    out = fused_layer_qsub(qidx, mask_row, *args, n_head=heads, out_dtype=dtype)
    assert _build.LAUNCHES["fused_layer_qsub"] == before + 1
    again = fused_layer_qsub(qidx, mask_row, *args, n_head=heads, out_dtype=dtype)
    out32 = fused_layer_qsub(qidx, mask_row, *args, n_head=heads)
    ref = fused_layer_qsub_plain(qidx, mask_row, *args, n_head=heads)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (n, k, h)
    assert torch.equal(out, again) and torch.equal(out, out32.to(dtype))
    assert (out32 - ref).abs().max().item() <= HID_TOL
    assert torch.all(out32[~used] == 0)
    # with the <mask> row at the query positions, K2's rows are K1's there
    rows_of = torch.arange(n, device=cuda)[:, None].expand(n, k)
    sel = torch.zeros(n, l, dtype=torch.bool, device=cuda)
    sel[rows_of[used], qidx[used].long()] = True
    args = (torch.where(sel[..., None], mask_row, raw),) + args[1:]
    out32 = fused_layer_qsub(qidx, mask_row, *args, n_head=heads)
    dense = fused_layer(*args, n_head=heads)
    rows = torch.gather(dense, 1, qidx.clamp(min=0).long()[..., None].expand(-1, -1, h))
    assert (out32 - rows)[used].abs().max().item() <= HID_TOL


# K1 on the serving walk (csrc/fused_layer.cu navc_fused_layer): its N * L
# canvas rows flattened with no sequence padding (384 * 32 rows is the
# decode's dense call, 128 x 128 tiles; 37 * 24, 9 * 29 and 5 * 13 leave a
# ragged last row tile), L 13, 24, 29 (no multiple of 16) and 32, one
# sequence, H 256 and 512, f32 and bf16 outputs, NAR and causal. PAD rows
# come out exactly zero (their multiplier), and two calls give the same
# bits (no atomics).
DENSE_CASES = [  # n, L, Le, H, heads, FFN, out dtype
    (384, 32, 16, 512, 8, 2048, torch.bfloat16),
    (384, 32, 16, 512, 8, 2048, torch.float32),
    (37, 24, 16, 512, 8, 2048, torch.float32),
    (9, 29, 8, 256, 4, 1024, torch.bfloat16),
    (1, 32, 16, 512, 8, 2048, torch.float32),
    (1, 29, 20, 256, 16, 272, torch.bfloat16),
    (5, 13, 20, 256, 16, 272, torch.float32),
]


def _dense_id(c):
    return "x".join(map(str, c[:6])) + ("-bf16" if c[6] == torch.bfloat16 else "-f32")


def _check_dense_walk(cuda, case, causal, bias_scale=1.0):
    n, l, le, h, heads, inter, dtype = case
    g = _gen(sum(case[:6]) + causal)
    w = _weights(h, inter, g, cuda)
    for f in w.__dataclass_fields__:
        if f.startswith("b"):
            getattr(w, f).mul_(bias_scale)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(n, l, le, h, g, cuda)
    args = (raw, static, kp, ke, ve, w, lns, lnb)
    before = _build.LAUNCHES["fused_layer"]
    out = fused_layer(*args, n_head=heads, causal=causal, out_dtype=dtype)
    assert _build.LAUNCHES["fused_layer"] == before + 1
    again = fused_layer(*args, n_head=heads, causal=causal, out_dtype=dtype)
    ref = fused_layer_plain(*args, n_head=heads, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (n, l, h)
    assert torch.equal(out, again)
    assert torch.all(out[kp] == 0)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES, ids=_dense_id)
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
def test_fused_layer_walk_matches_plain(cuda, case, causal):
    out, ref = _check_dense_walk(cuda, case, causal)
    assert (out.float() - ref).abs().max().item() <= HID_TOL


# K1 and K2 with more than 2^31 elements in their FFN activations: live
# query rows x FFN 2048 pass 2^31 from row 1,048,576 on (the walk computes
# the live rows only, compacted; an 8192-video decode whose canvases are
# all long has 1,572,864 of them). N = 32,900 canvases of 32: all but the
# last 64 every position live (K2: 32 used slots), those 64 of random
# length, their rows from 1,050,752 on. Their rows against the plain
# version run on those 64 canvases alone.
WIDE_N, WIDE_TAIL = 32900, 64


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "qsub"])
def test_fused_layer_walk_rows_past_int32_offsets(cuda, form):
    n, l, le, h, heads, inter = WIDE_N, 32, 16, 512, 8, 2048
    g = _gen(31)
    w = _weights(h, inter, g, cuda)
    cg = torch.Generator(device=cuda).manual_seed(31)
    raw, static = (torch.randn(n, l, h, generator=cg, device=cuda).to(torch.bfloat16)
                   for _ in range(2))
    ke, ve = (torch.randn(n, le, h, generator=cg, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    real = torch.full((n,), l, device=cuda)
    real[-WIDE_TAIL:] = torch.randint(1, l + 1, (WIDE_TAIL,), generator=cg, device=cuda)
    kp = torch.arange(l, device=cuda)[None] >= real[:, None]
    lns = (1 + 0.1 * torch.randn(h, generator=g)).to(cuda)
    lnb = (0.1 * torch.randn(h, generator=g)).to(cuda)
    tail = slice(n - WIDE_TAIL, n)
    args = (raw, static, kp, ke, ve, w, lns, lnb)
    part = (raw[tail], static[tail], kp[tail], ke[tail], ve[tail], w, lns, lnb)
    assert (n - WIDE_TAIL) * l * inter >= 2 ** 31
    if form == "dense":
        got = fused_layer(*args, n_head=heads, out_dtype=torch.bfloat16)[tail]
        want = fused_layer_plain(*part, n_head=heads)
    else:
        k = 32
        slots = torch.arange(k, device=cuda, dtype=torch.int32)[None]
        qidx = torch.where(slots < real[:, None], slots, -1).to(torch.int32).contiguous()
        mask_row = torch.randn(h, generator=g).to(cuda, torch.bfloat16)
        got = fused_layer_qsub(qidx, mask_row, *args, n_head=heads,
                               out_dtype=torch.bfloat16)[tail]
        want = fused_layer_qsub_plain(qidx[tail], mask_row, *part, n_head=heads)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= HID_TOL


# The walk over live rows only (csrc/fused_layer.cu's plan): canvases of 32
# whose extents are 4, 15, 16, 17, 29 and 32, half of them with interior PAD
# below the extent, K2 with one used slot or every slot of 24 used. Live rows
# within HID_TOL of the plain version, rows past the extent (slots past the
# query extent) exactly zero, the card's plan the one walk_plan gives, the
# running count of walked rows, and each canvas's rows bit for bit the same
# whatever the extents of the canvases before it (its rows then sit at other
# offsets of the compacted walk).
WALK_EXTENTS = (4, 15, 16, 17, 29, 32)


def _walk_batch(n, g, dev, h=512):
    l, le, heads, inter = 32, 16, 8, 2048
    w = _weights(h, inter, g, dev)
    raw, static, _, ke, ve, lns, lnb = _layer_inputs(n, l, le, h, g, dev)
    kp = torch.zeros(n, l, dtype=torch.bool)
    for i in range(n):
        e = WALK_EXTENTS[i % len(WALK_EXTENTS)]
        kp[i, e:] = True
        if i % 2 and e > 4:
            kp[i, 1] = kp[i, e - 2] = True  # interior PAD
    return w, [raw, static, kp.to(dev), ke, ve, w, lns, lnb], heads


def _walk_slots(kp, k, g):
    """qidx (N, K): one used slot in every third canvas, every slot used
    where the canvas has live positions enough, else as many as it has; in
    every third, the second slot unused (no decode makes one: its row is
    computed and zeroed by its multiplier)."""
    n = kp.shape[0]
    qidx = torch.full((n, k), -1, dtype=torch.int32)
    for i in range(n):
        real = (~kp[i]).nonzero()[:, 0].cpu()
        take = 1 if i % 3 == 0 else min(k, len(real))
        pos = real[torch.randperm(len(real), generator=g)[:take]].sort().values
        qidx[i, :take] = pos.to(torch.int32)
        if i % 3 == 1 and take > 2:
            qidx[i, 1] = -1  # an unused slot inside the query extent
    return qidx.to(kp.device)


def _walk_call(form, args, heads, qidx, mask_row):
    from navc_tpu_torch.ops import fused_layer as FL

    kept = {}
    scratch = FL._scratch

    def keep(*a, **k):
        kept.update(scratch(*a, **k))
        return kept

    FL._scratch = keep
    try:
        if form == "qsub":
            out = fused_layer_qsub(qidx, mask_row, *args, n_head=heads)
        else:
            out = fused_layer(*args, n_head=heads, causal=form == "causal")
    finally:
        FL._scratch = scratch
    return out, kept["plan"]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["nar", "causal", "qsub"])
def test_fused_layer_walk_computes_only_live_rows(cuda, form):
    from navc_tpu_torch.ops.fused_layer import walk_plan, walk_rows

    n = 48
    g = _gen(2025 + len(form))
    w, args, heads = _walk_batch(n, g, cuda)
    kp = args[2]
    mask_row = torch.randn(512, generator=g).to(cuda, torch.bfloat16)
    qidx = _walk_slots(kp, 24, g) if form == "qsub" else None
    rows = walk_rows(cuda)
    rows.zero_()
    out, plan = _walk_call(form, args, heads, qidx, mask_row)
    if qidx is None:
        ref = fused_layer_plain(*args, n_head=heads, causal=form == "causal")
    else:
        ref = fused_layer_qsub_plain(qidx, mask_row, *args, n_head=heads)
    torch.cuda.synchronize()
    coff, qoff, rmap = walk_plan(kp, qidx)
    nq = int(qoff[-1])
    if qidx is None:
        assert torch.equal(plan[:n + 1], coff) and torch.equal(plan[2 * (n + 1):][:nq], rmap)
        assert rows.tolist() == [int(coff[-1]), n * 32]
    else:
        assert torch.equal(plan[:n + 1], coff) and torch.equal(plan[n + 1:2 * (n + 1)], qoff)
        assert torch.equal(plan[2 * (n + 1):][:nq], rmap)
        assert rows.tolist() == [int(coff[-1]) + nq, n * 32 + n * 24]
    assert (out - ref).abs().max().item() <= HID_TOL
    for i in range(n):
        e = int(qoff[i + 1] - qoff[i])
        assert torch.all(out[i, e:] == 0), (form, i, e)
    if qidx is None:
        assert torch.all(out[kp] == 0)
    else:
        assert torch.all(out[qidx < 0] == 0)
    # the last 12 canvases' rows whatever the extents of the 36 before them:
    # give those every position live (K2: every slot used), and the same again
    changed = list(args)
    changed[2] = kp.clone()
    changed[2][:36] = False
    qchanged = None
    if qidx is not None:
        qchanged = qidx.clone()
        qchanged[:36] = torch.arange(24, dtype=torch.int32, device=cuda)
    again, _ = _walk_call(form, changed, heads, qchanged, mask_row)
    torch.cuda.synchronize()
    assert torch.equal(again[36:], out[36:])
    rows.zero_()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [DENSE_CASES[1], DENSE_CASES[3]], ids=_dense_id)
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
def test_fused_layer_walk_matches_plain_with_large_biases(cuda, case, causal):
    """Every bias U(-1, 1), ten times the test's usual scale: a bias added
    to the wrong column group of the [Q K V] product, or left out, moves
    every downstream element past the rms tolerance. The values grow with
    the biases, so the tolerances are the training kernels' (relative to
    the largest |value| and to the rms)."""
    out, ref = _check_dense_walk(cuda, case, causal, bias_scale=10.0)
    _close(out, ref, TRAIN_TOL, "out", rms_tol=TRAIN_RMS_TOL)


VOCAB_SHAPES = [  # rows, d, V
    (1, 512, 10048), (70, 64, 50), (200, 16, 1001), (129, 512, 4099),
    # the decode's sparse row counts (k_bound 8, 16, 24 of 384 rows)
    (3072, 512, 10048), (6144, 512, 10048), (9216, 512, 10048),
    # D = 768 (two ring stages) and D = 64 with ragged row tiles and the
    # vocab edge inside a tile of the last split
    (300, 768, 4099), (1000, 64, 10001)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VOCAB_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_vocab_kernels_match_plain(cuda, shape, with_bias):
    r, d, v = shape
    g = _gen(r * d + v + with_bias)
    hid = torch.randn(r, d, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(v, d, generator=g) / math.sqrt(d)).to(cuda, torch.bfloat16)
    bias = (torch.randn(v, generator=g) * 0.5).to(cuda) if with_bias else None
    before = dict(_build.LAUNCHES)
    ids, maxp = project_argmax(hid, w, bias)
    ids_p, maxp_p = project_argmax_plain(hid, w, bias)
    scores = hid.float() @ w.float().t() + (0 if bias is None else bias)
    top2 = scores.topk(min(2, v), dim=-1).values
    clear = (top2[:, 0] - top2[:, -1]) > 1e-3
    assert torch.equal(ids[clear], ids_p[clear])
    assert ((maxp - maxp_p).abs() / maxp_p).max().item() <= 1e-4
    targets = torch.randint(0, v, (r,), generator=g).to(cuda, torch.int32)
    prob = project_gather_prob(hid, w, targets, bias)
    prob_p = project_gather_prob_plain(hid, w, targets, bias)
    assert ((prob - prob_p).abs() / prob_p).max().item() <= 1e-4
    assert _build.LAUNCHES["project_argmax"] == before["project_argmax"] + 1
    assert _build.LAUNCHES["project_gather_prob"] == before["project_gather_prob"] + 1


@pytest.mark.cuda
def test_vocab_argmax_ties_go_to_the_lowest_id(cuda):
    hid = torch.ones(3, 16, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(200, 16, dtype=torch.bfloat16, device=cuda)
    w[[70, 9, 130]] = 1.0  # ties across tiles and threads
    ids, maxp = project_argmax(hid, w)
    assert ids.tolist() == [9, 9, 9]



@pytest.mark.cuda
def test_vocab_argmax_ties_inside_one_thread_go_to_the_lowest_id(cuda):
    """Columns 1, 9, 17 and 121 of a 128-column tile fall to one thread of
    the kernel's epilogue (columns 8j + 2q + e), 129 to the next tile."""
    hid = torch.ones(300, 16, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(1001, 16, dtype=torch.bfloat16, device=cuda)
    w[[121, 17, 129, 9, 1]] = 1.0
    ids, maxp = project_argmax(hid, w)
    assert ids.tolist() == [1] * 300
    prob = project_gather_prob(hid, w, ids)
    assert torch.allclose(prob, maxp, rtol=1e-6)


def _vocab_operands(r, d, v, g, dev, bias_scale=None):
    hid = torch.randn(r, d, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(v, d, generator=g) / math.sqrt(d)).to(dev, torch.bfloat16)
    bias = None
    if bias_scale is not None:
        bias = (torch.randn(v, generator=g) * bias_scale).to(dev)
    return hid, w, bias


@pytest.mark.cuda
def test_vocab_argmax_ties_across_splits_go_to_the_lowest_id(cuda):
    """Exact ties placed in two different vocab splits (and twice inside
    one tile): the lowest id wins, and K4's prob at it equals the max prob."""
    from navc_tpu_torch.ops.vocab_fused import argmax_splits, split_ranges

    r, d, v = 3072, 512, 10048
    hid, w, _ = _vocab_operands(r, d, v, _gen(8), cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ranges = split_ranges(v, *argmax_splits(r, v, sms))
    assert len(ranges) >= 3
    ties = [ranges[2][0] + 5, ranges[2][0] + 6, ranges[1][1] - 1]
    w[ties] = (hid[0].float() / hid[0].float().norm() * 40).to(torch.bfloat16)
    ids, maxp = project_argmax(hid[:1].expand(r, d).contiguous(), w)
    assert ids.tolist() == [ties[2]] * r
    prob = project_gather_prob(hid[:1].expand(r, d).contiguous(), w,
                               ids.contiguous())
    assert torch.allclose(prob, maxp, rtol=1e-6)


@pytest.mark.cuda
def test_gather_prob_targets_at_the_edge_and_out_of_range(cuda):
    r, d, v = 200, 64, 1001   # 8 vocab tiles, the last with 105 columns
    hid, w, bias = _vocab_operands(r, d, v, _gen(9), cuda, bias_scale=0.5)
    g = _gen(10)
    targets = torch.randint(896, v, (r,), generator=g).to(torch.int32)
    targets[:3] = torch.tensor([v, -1, v + 200], dtype=torch.int32)
    targets = targets.to(cuda)
    prob = project_gather_prob(hid, w, targets, bias)
    torch.cuda.synchronize()
    assert prob[:3].tolist() == [0.0, 0.0, 0.0]
    prob_p = project_gather_prob_plain(hid[3:], w, targets[3:], bias)
    assert ((prob[3:] - prob_p).abs() / prob_p).max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 512, 10048), (129, 64, 4099)],
                         ids=lambda s: "x".join(map(str, s)))
def test_vocab_kernels_match_plain_with_a_large_bias(cuda, shape):
    """A bias ten times the scores' scale decides the argmax."""
    r, d, v = shape
    hid, w, _ = _vocab_operands(r, d, v, _gen(r + v), cuda)
    scale = float((hid.float() @ w.float().t()).std())
    bias = (torch.randn(v, generator=_gen(11)) * 10 * scale).to(cuda)
    ids, maxp = project_argmax(hid, w, bias)
    ids_p, maxp_p = project_argmax_plain(hid, w, bias)
    scores = hid.float() @ w.float().t() + bias
    top2 = scores.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(ids[clear], ids_p[clear])
    assert ((maxp - maxp_p).abs() / maxp_p).max().item() <= 1e-4
    # even rows ask for the argmax, odd rows for a random id; probabilities
    # below 1e-30 (float32's normal range ends at 1.2e-38) are left out
    targets = torch.randint(0, v, (r,), generator=_gen(12)).to(cuda, torch.int32)
    targets[::2] = ids_p[::2]
    prob = project_gather_prob(hid, w, targets, bias)
    prob_p = project_gather_prob_plain(hid, w, targets, bias)
    ok = prob_p > 1e-30
    assert int(ok.sum()) > r // 2
    assert ((prob - prob_p).abs() / prob_p)[ok].max().item() <= 1e-4


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _gen(0)
    hid = torch.randn(4, 32, generator=g).to(cuda)
    w = torch.randn(10, 32, generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(TypeError):
        project_argmax(hid, w)                       # float32 h
    with pytest.raises(ValueError):
        project_argmax(hid.to(torch.bfloat16)[:, :24].contiguous(), w[:, :24].contiguous())
    flat = torch.randn(4 * 32 + 4, generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):   # TMA needs 16-byte alignment
        project_argmax(flat[4:].view(4, 32), w)
    with pytest.raises(ValueError, match="16-byte"):
        project_gather_prob(hid.to(torch.bfloat16), w,
                            torch.zeros(4, dtype=torch.int32, device=cuda),
                            torch.zeros(11, device=cuda)[1:])
    weights = _weights(128, 128, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(2, 40, 8, 128, g, cuda)
    with pytest.raises(ValueError):                  # canvas longer than 32
        fused_layer(raw, static, kp, ke, ve, weights, lns, lnb, n_head=2)
    with pytest.raises(ValueError):                  # non-contiguous operand
        fused_layer(raw[:, :16], static[:, :16].contiguous(),
                    kp[:, :16].contiguous(), ke, ve, weights, lns, lnb, n_head=2)


TOPK_SHAPES = [  # rows, d, V, k
    (320, 512, 10048, 5), (7, 64, 1001, 1), (130, 256, 4099, 8),
    (64, 512, 50, 3), (5120, 512, 10048, 5),
    # the 60-video request, one row, D = 768 (one ring stage per warpgroup),
    # V < 128 and ragged last tiles at every k
    (300, 512, 10048, 5), (1, 512, 10048, 8), (320, 768, 10048, 4),
    (300, 768, 4099, 7), (5120, 64, 50, 6), (1, 64, 1001, 2), (320, 64, 4099, 8)]


def _check_topk(hid, w, k, bias):
    before = _build.LAUNCHES["project_topk"]
    lp, ids = project_topk(hid, w, k, bias)
    assert _build.LAUNCHES["project_topk"] == before + 1
    lp_p, ids_p = project_topk_plain(hid, w, k, bias)
    torch.cuda.synchronize()
    scores = hid.float() @ w.float().t() + (0 if bias is None else bias)
    srt = scores.sort(dim=-1, descending=True).values[:, :k + 1]
    clear = (srt[:, :-1] - srt[:, 1:]) > 1e-3
    assert torch.equal(ids[clear], ids_p[clear])
    assert (lp - lp_p).abs().max().item() <= ATT_TOL
    assert bool((lp[:, 1:] <= lp[:, :-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TOPK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_project_topk_matches_plain(cuda, shape, with_bias):
    r, d, v, k = shape
    g = _gen(r + d + v + k + with_bias)
    hid = torch.randn(r, d, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(v, d, generator=g) / math.sqrt(d)).to(cuda, torch.bfloat16)
    bias = (torch.randn(v, generator=g) * 0.5).to(cuda) if with_bias else None
    _check_topk(hid, w, k, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_project_topk_matches_plain_at_every_k(cuda, k):
    """Each list length the kernel instantiates, at the beam step's shape."""
    hid, w, bias = _vocab_operands(320, 512, 10048, _gen(30 + k), cuda, bias_scale=0.1)
    _check_topk(hid, w, k, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(320, 512, 10048, 5), (300, 64, 4099, 8),
                                   (5120, 512, 10048, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_project_topk_matches_plain_with_a_large_bias(cuda, shape):
    """A bias ten times the scores' scale decides the ranking: a kernel that
    dropped it, or added it to the wrong column, fails."""
    r, d, v, k = shape
    hid, w, _ = _vocab_operands(r, d, v, _gen(r + v + k), cuda)
    scale = float((hid.float() @ w.float().t()).std())
    bias = (torch.randn(v, generator=_gen(13)) * 10 * scale).to(cuda)
    _check_topk(hid, w, k, bias)


@pytest.mark.cuda
def test_project_topk_ties_go_to_the_lowest_id(cuda):
    g = _gen(5)
    hid = torch.randint(-1, 2, (40, 32), generator=g).float()
    w = torch.randint(-1, 2, (3000, 32), generator=g).float()
    w[1500:2900] = w[:1400]  # exact duplicates across tiles and splits
    lp, ids = project_topk(hid.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16), 8)
    order = torch.sort(hid @ w.t(), dim=-1, descending=True, stable=True).indices[:, :8]
    assert torch.equal(ids.cpu(), order.to(torch.int32))


def _tied_topk(cuda, rows, v, cols, k):
    """Rows of ones against a W that is zero but at ``cols`` (ones): those
    columns tie at the top and every other column ties at zero below them;
    the kernel must list ids as a stable descending sort does."""
    hid = torch.ones(rows, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(v, 64, dtype=torch.bfloat16, device=cuda)
    w[cols] = 1.0
    lp, ids = project_topk(hid, w, k)
    want = torch.sort(hid[:1].float() @ w.float().t(), dim=-1, descending=True,
                      stable=True).indices[0, :k].to(torch.int32)
    torch.cuda.synchronize()
    assert ids.tolist() == [want.tolist()] * rows
    assert (lp - project_topk_plain(hid, w, k)[0]).abs().max().item() <= ATT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 8])
def test_project_topk_ties_inside_one_thread_and_across_lanes(cuda, k):
    """Columns 1, 9, 17 and 121 of the first 128-column tile fall to one
    thread of the epilogue (columns 8j + 2q + e), 2 and 3 to the next lane
    of the row, 129 to the next tile; below them the zeros tie too."""
    _tied_topk(cuda, 300, 1001, [121, 17, 129, 9, 1, 3, 2], k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 8])
def test_project_topk_ties_across_warpgroups_and_splits(cuda, k):
    """Ties in tiles that the block's two consumer warpgroups take (tiles 0
    and 1 of a split), in a later tile of the same warpgroup and in the
    next vocab split; the plan must give each split several tiles."""
    from navc_tpu_torch.ops.vocab_fused import (TOPK_MAX_TILES, argmax_splits,
                                                split_ranges)

    rows, v = 5120, 10048
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ranges = split_ranges(v, *argmax_splits(rows, v, sms, TOPK_MAX_TILES))
    assert len(ranges) >= 2 and ranges[0][1] >= 3 * 128
    cols = [ranges[1][0] + 7, 2 * 128 + 5, 128 + 6, 128 + 4, 6, ranges[1][0] + 2]
    _tied_topk(cuda, rows, v, cols, k)


@pytest.mark.cuda
def test_project_topk_vocab_past_16_bit_ids(cuda):
    """70000 words at 33792 rows, where a plan without the split cap would
    take one split of 547 tiles, past the lists' 16-bit ids: the wrapper
    runs, and every 61st row, ties placed across the 65536 boundary
    included, matches the plain version."""
    r, d, v, k = 33792, 64, 70000, 5
    hid, w, bias = _vocab_operands(r, d, v, _gen(70), cuda, bias_scale=0.1)
    tied = [0, 3, 65535, 65536, 69999]  # equal, and far above every other column
    w[tied] = w[0].clone()
    bias[tied] = 50.0
    lp, ids = project_topk(hid, w, k, bias)
    sel = torch.arange(0, r, 61, device=cuda)
    lp_p, ids_p = project_topk_plain(hid[sel], w, k, bias)
    torch.cuda.synchronize()
    assert torch.equal(ids[sel], ids_p)
    assert ids_p.tolist() == [tied] * len(sel)
    assert (lp[sel] - lp_p).abs().max().item() <= ATT_TOL


@pytest.mark.cuda
def test_vocab_argmax_long_split_with_large_logits(cuda):
    """One split of 469 tiles (60000 words at 33792 rows) and logits near
    50: the running sum-exp is rescaled once per tile and must not drift
    while the max holds; K3's max prob within 1e-4 of the plain version's."""
    r, d, v = 33792, 64, 60000
    hid, w, bias = _vocab_operands(r, d, v, _gen(71), cuda, bias_scale=0.1)
    tied = [0, 3, 30000, 50000, 59999]
    w[tied] = w[0].clone()
    bias[tied] = 50.0
    ids, maxp = project_argmax(hid, w, bias)
    sel = torch.arange(0, r, 61, device=cuda)
    ids_p, maxp_p = project_argmax_plain(hid[sel], w, bias)
    torch.cuda.synchronize()
    assert ids[sel].tolist() == ids_p.tolist() == [0] * len(sel)
    assert ((maxp[sel] - maxp_p).abs() / maxp_p).max().item() <= 1e-4


def _caches(n, l, h, dtype, g, dev):
    return tuple(torch.randn(n, l * h, generator=g).to(dev, dtype) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(64, 5), (7, 1), (12, 3), (16, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_permute_matches_plain(cuda, b, k, dtype):
    g = _gen(b * k)
    kc, vc = _caches(b * k, 30, 512, dtype, g, cuda)
    prev_k = torch.randint(0, k, (b, k), generator=g).to(cuda, torch.int32)
    before = _build.LAUNCHES["permute_beam_caches"]
    ok, ov = permute_beam_caches(kc, vc, prev_k)
    assert _build.LAUNCHES["permute_beam_caches"] == before + 1
    rk, rv = permute_beam_caches_plain(kc, vc, prev_k)
    torch.cuda.synchronize()
    assert torch.equal(ok, rk) and torch.equal(ov, rv)


def _step_inputs(b, k, l, h, tpos, g, dev):
    n = b * k
    q, kt, vt = (torch.randn(n, h, generator=g).to(dev) for _ in range(3))
    mask = torch.rand(n, l, generator=g) < 0.2
    mask[:, 0] = False
    mask[:, tpos] = False
    mask |= torch.arange(l)[None, :] > tpos
    amask = torch.where(mask, -1e7, 0.0).to(dev)
    prev_k = torch.randint(0, k, (b, k), generator=g).to(dev, torch.int32)
    return q, kt, vt, prev_k, amask


ATTEND_SHAPES = [  # b, k, L, H, heads
    (64, 5, 30, 512, 8), (16, 1, 20, 256, 4), (3, 3, 30, 512, 8),
    (16, 8, 20, 256, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ATTEND_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_beam_attend_step_matches_plain(cuda, shape, where, dtype):
    b, k, l, h, heads = shape
    tpos = {"first": 0, "middle": l // 2, "last": l - 1}[where]
    g = _gen(sum(shape) + tpos)
    kc, vc = _caches(b * k, l, h, dtype, g, cuda)
    q, kt, vt, prev_k, amask = _step_inputs(b, k, l, h, tpos, g, cuda)
    rk, rv = kc.clone(), vc.clone()
    before = _build.LAUNCHES["beam_attend_step"]
    ok, ov, att = beam_attend_step(kc, vc, q, kt, vt, prev_k, amask, tpos, heads)
    assert _build.LAUNCHES["beam_attend_step"] == before + 1
    assert ok.data_ptr() == kc.data_ptr()  # in place
    rk, rv, ratt = beam_attend_step_plain(rk, rv, q, kt, vt, prev_k, amask, tpos, heads)
    torch.cuda.synchronize()
    lim = (tpos + 1) * h
    assert torch.equal(ok[:, :lim], rk[:, :lim]) and torch.equal(ov[:, :lim], rv[:, :lim])
    assert (att - ratt).abs().max().item() <= ATT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_beam_attend_step_chained_matches_plain(cuda, dtype):
    """Every step of a 30-position decode through the in-place caches."""
    b, k, l, h, heads = 16, 5, 30, 512, 8
    g = _gen(11)
    kc = torch.zeros(b * k, l * h, dtype=dtype, device=cuda)
    vc = torch.zeros_like(kc)
    rk, rv = kc.clone(), vc.clone()
    for t in range(l - 1):
        q, kt, vt, prev_k, amask = _step_inputs(b, k, l, h, t, g, cuda)
        if t == 0:
            prev_k.zero_()
        kc, vc, att = beam_attend_step(kc, vc, q, kt, vt, prev_k, amask, t, heads)
        rk, rv, ratt = beam_attend_step_plain(rk, rv, q, kt, vt, prev_k, amask, t, heads)
        torch.cuda.synchronize()
        lim = (t + 1) * h
        assert torch.equal(kc[:, :lim], rk[:, :lim]) and torch.equal(vc[:, :lim], rv[:, :lim])
        assert (att - ratt).abs().max().item() <= ATT_TOL, t


def _check_step(cuda, b, k, l, h, heads, tpos, dtype, seed, identity=False):
    """One K6 call against the plain version on the same inputs; returns
    the kernel's (kc, vc, att) and the inputs' caches."""
    g = _gen(seed)
    kc, vc = _caches(b * k, l, h, dtype, g, cuda)
    q, kt, vt, prev_k, amask = _step_inputs(b, k, l, h, tpos, g, cuda)
    if identity:
        prev_k = torch.arange(k, dtype=torch.int32, device=cuda).repeat(b, 1)
    k0, v0 = kc.clone(), vc.clone()
    rk, rv = kc.clone(), vc.clone()
    before = _build.LAUNCHES["beam_attend_step"]
    ok, ov, att = beam_attend_step(kc, vc, q, kt, vt, prev_k, amask, tpos, heads)
    assert _build.LAUNCHES["beam_attend_step"] == before + 1
    rk, rv, ratt = beam_attend_step_plain(rk, rv, q, kt, vt, prev_k, amask, tpos, heads)
    torch.cuda.synchronize()
    lim = (tpos + 1) * h
    assert torch.equal(ok[:, :lim], rk[:, :lim]) and torch.equal(ov[:, :lim], rv[:, :lim])
    assert (att - ratt).abs().max().item() <= ATT_TOL
    again = beam_attend_step(k0.clone(), v0.clone(), q, kt, vt, prev_k, amask, tpos, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(x[:, :lim], y[:, :lim]) for x, y in zip(again[:2], (ok, ov)))
    assert torch.equal(again[2], att)  # a fixed merge order: the same bits
    return ok, ov, att, k0, v0


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_beam_attend_step_at_the_b1024_shape(cuda, where, dtype):
    """The B=1024 decode's 5120 rows (beam 5, H 512, 8 heads, L 30): many
    runs of a few positions, partials merged."""
    tpos = {"first": 0, "middle": 14, "last": 29}[where]
    _check_step(cuda, 1024, 5, 30, 512, 8, tpos, dtype, seed=tpos + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tpos", [(64, 13), (1024, 13), (64, 16), (60, 28)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_beam_attend_step_with_a_run_that_does_not_divide(cuda, b, tpos, dtype):
    """Runs whose length does not divide the tpos + 1 positions: the last
    run is short, and it holds the new row at tpos."""
    from navc_tpu_torch.ops.beam_attend import attend_runs

    run, runs = attend_runs(b, 5, tpos, 512, 8, torch.empty((), dtype=dtype).element_size(),
                            torch.cuda.get_device_properties(0).multi_processor_count)
    assert runs > 1 and (tpos + 1) % run != 0
    _check_step(cuda, b, 5, 30, 512, 8, tpos, dtype, seed=b + tpos)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tpos", [(64, 14), (1024, 29), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_beam_attend_step_with_an_identity_ancestry(cuda, b, tpos, dtype):
    """Every instance's beams kept their slots: the prefix stays as it was
    (no copy-back), the new row lands at tpos, and the attention reads the
    staged rows all the same."""
    ok, ov, _, k0, v0 = _check_step(cuda, b, 5, 30, 512, 8, tpos, dtype, seed=7 + tpos,
                                    identity=True)
    lim = tpos * 512
    assert torch.equal(ok[:, :lim], k0[:, :lim]) and torch.equal(ov[:, :lim], v0[:, :lim])


def _check_cross(cuda, b, k, te, h, heads, dtype):
    g = _gen(b + k + te + h)
    q = torch.randn(b * k, h, generator=g).to(cuda)
    ke = torch.randn(b, te, h, generator=g).to(cuda, dtype)
    ve = torch.randn(b, te, h, generator=g).to(cuda, dtype)
    before = _build.LAUNCHES["cross_attend"]
    att = cross_attend(q, ke, ve, heads)
    assert _build.LAUNCHES["cross_attend"] == before + 1
    ratt = cross_attend_plain(q, ke, ve, heads)
    torch.cuda.synchronize()
    assert (att - ratt).abs().max().item() <= ATT_TOL
    return q, ke, ve, att


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,te,h,heads", [
    (64, 5, 16, 512, 8), (7, 1, 8, 256, 4), (12, 3, 16, 256, 2), (16, 8, 16, 512, 16),
    (12, 3, 16, 120, 8), (1024, 3, 16, 120, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_matches_plain(cuda, b, k, te, h, heads, dtype):
    """The last two cases: heads 15 wide, whose slices are no whole 16-byte
    vectors (the scores' scalar loop) and whose column pairs straddle heads
    (the output's column-by-column loop), in a grid of one block an
    instance and of several an SM (the reuse layout)."""
    _check_cross(cuda, b, k, te, h, heads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_at_the_b1024_shape(cuda, dtype):
    """The B=1024 decode's 5120 rows: all eight heads a block (1024 blocks)."""
    _check_cross(cuda, 1024, 5, 16, 512, 8, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_with_each_head_group(cuda, groups, dtype):
    """Instances for which ``cross_groups`` plans each group on this card:
    the fewest whose grid gives every SM a block in groups of g (at g = 1,
    one instance short of that for all eight heads)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = max(1, (sms - 1) // 8) if groups == 1 else -(-sms * groups // 8)
    assert cross_groups(b, 5, 16, 512, 8, torch.empty((), dtype=dtype).element_size(),
                        sms)[0] == groups
    _check_cross(cuda, b, 5, 16, 512, 8, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,te,h,heads", [
    (64, 5, 16, 512, 8), (1024, 5, 13, 512, 8), (7, 1, 8, 256, 4), (4, 32, 16, 512, 16),
    (12, 3, 16, 120, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_in_each_group_and_layout_matches_plain(cuda, b, k, te, h, heads, dtype):
    """Every head group the kernel takes, in both thread layouts, through its
    C entry (the wrapper takes ``cross_groups``' plan): a group of 15-wide
    heads straddles column pairs, beam 32 fills MAX_BEAM."""
    g = _gen(b * k + te)
    q = torch.randn(b * k, h, generator=g).to(cuda)
    ke = torch.randn(b, te, h, generator=g).to(cuda, dtype)
    ve = torch.randn(b, te, h, generator=g).to(cuda, dtype)
    want = cross_attend_plain(q, ke, ve, heads)
    lib = _build.load("beam_attend", beam_attend._SIGNATURES)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    isz = ke.element_size()
    tried = 0
    for gg in range(1, heads + 1):
        for reuse in (0, 1) if cross_group_ok(gg, k, te, h, heads, isz) else ():
            att = torch.full_like(q, float("nan"))
            _build.check(lib, lib.navc_cross_attend(
                q.data_ptr(), ke.data_ptr(), ve.data_ptr(), att.data_ptr(), b * k, k, te, h,
                heads, 1.0 / math.sqrt(h // heads), int(dtype == torch.float32), gg, reuse,
                stream), "cross_attend")
            torch.cuda.synchronize()
            assert (att - want).abs().max().item() <= ATT_TOL, (gg, reuse)
            tried += 1
    assert tried >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,te", [(64, 5, 1), (64, 5, 13), (16, 1, 16), (4, 32, 16),
                                    (1024, 1, 13), (3, 32, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_at_edge_positions_and_beams(cuda, b, k, te, dtype):
    """One encoder position, a count that is no multiple of the warp's
    lanes, beam 1 and beam 32 (the most rows an instance may have)."""
    _check_cross(cuda, b, k, te, 512, 8, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_repeats_bitwise(cuda, b, dtype):
    q, ke, ve, att = _check_cross(cuda, b, 5, 16, 512, 8, dtype)
    assert torch.equal(cross_attend(q, ke, ve, 8), att)


@pytest.mark.cuda
def test_cross_attend_refuses_what_the_kernel_does_not_take(cuda):
    g = _gen(2)
    q = torch.randn(320, 512, generator=g).to(cuda)
    ke = torch.randn(64, 16, 512, generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError):                  # 3 does not divide 512
        cross_attend(q, ke, ke, 3)
    flat = torch.zeros(64 * 16 * 512 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):  # contiguous, 2 bytes off
        cross_attend(q, flat[1:].view(64, 16, 512), ke, 8)
    with pytest.raises(ValueError):                  # rows no multiple of the instances
        cross_attend(q[:319], ke, ke, 8)


@pytest.mark.cuda
def test_beam_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _gen(1)
    hid = torch.randn(4, 64, generator=g).to(cuda, torch.bfloat16)
    w = torch.randn(100, 64, generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        project_topk(hid, w, 9)                      # k above MAX_K
    kc, vc = _caches(10, 4, 128, torch.bfloat16, g, cuda)
    q, kt, vt, prev_k, amask = _step_inputs(5, 2, 4, 128, 1, g, cuda)
    with pytest.raises(ValueError):                  # tpos outside the cache
        beam_attend_step(kc, vc, q, kt, vt, prev_k, amask, 4, 2)
    with pytest.raises(ValueError):                  # int64 ancestry
        beam_attend_step(kc, vc, q, kt, vt, prev_k.long(), amask, 1, 2)
    with pytest.raises(ValueError):                  # non-contiguous cache
        permute_beam_caches(kc[:, :256], vc[:, :256], prev_k)


# --- the training layer: K11, K12a, K12b and the weight-gradient reduction --
# Tolerances, as chip_smoke.py's. The largest error is held to 2e-2 of the
# tensor's largest magnitude for the layer output, r2, dr2, dx, denc and the
# operand rows (the kernels and the plain version round the same values to
# bf16, but a float32 sum in another order moves a rounding by one bf16 ulp,
# 2^-8, which the next products spread), and to 1e-3 for the reduction
# against torch.matmul of the same bf16 operands (float32 sums in another
# order only). The root mean square of the error is held to 4e-3 and 1e-4 of
# the tensor's: a flipped rounding is rare, while a missing bias or a scale
# off by 1% moves every element. The largest rms ratio seen on the H100 is
# 1.6e-3, in the self-attention dK operand rows, where dS = (dP -
# rowsum(dP * P)) * P cancels and a flipped rounding upstream moves many
# roundings downstream; the reduction's is 1.7e-6.

TRAIN_TOL, WGRAD_TOL = 2e-2, 1e-3
TRAIN_RMS_TOL, WGRAD_RMS_TOL = 4e-3, 1e-4
TRAIN_CASES = [  # H, FFN, N, L, Le, causal, p
    (512, 2048, 64, 30, 16, False, 0.5),
    (512, 2048, 64, 29, 16, True, 0.5),
    (512, 2048, 7, 20, 16, True, 0.0),
    (256, 1024, 1, 8, 8, False, 0.0),
    (256, 1024, 7, 30, 32, True, 0.5),
    (256, 1024, 64, 20, 5, False, 0.5),
]


def _train_inputs(h, inter, n, l, le, g, dev, bias_scale=1.0):
    from navc_tpu_torch.ops import fused_layer_train as FT

    w = {k: v.to(torch.float32) * (bias_scale if k.startswith("b") else 1.0)
         for k, v in vars(_weights(h, inter, g, dev)).items()}
    lengths = torch.randint(1, l + 1, (n,), generator=g)
    lengths[0] = l
    kp = (torch.arange(l)[None] >= lengths[:, None]).to(dev)
    x = torch.randn(n, l, h, generator=g).to(dev)
    enc = torch.randn(n, le, h, generator=g).to(dev)
    return x, enc, kp, FT.kernel_weights(w, torch.bfloat16)


def _rms(t):
    return t.float().square().mean().sqrt().item()


def _close(got, want, tol, what, like=None, rms_tol=None):
    """max |got - want| <= tol * max |like| and, given rms_tol, rms(got -
    want) <= rms_tol * rms(like) (``like`` defaults to want)."""
    ref = want if like is None else like
    err = (got.float() - want.float()).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-6)
    assert err <= tol * scale, "%s: max err %.3e, scale %.3e" % (what, err, scale)
    if rms_tol is not None:
        err, scale = _rms(got.float() - want.float()), max(_rms(ref), 1e-6)
        assert err <= rms_tol * scale, "%s: rms err %.3e, rms %.3e" % (what, err, scale)


def _check_train_kernels(cuda, case, bias_scale=1.0, seed=2 ** 31 - 17):
    """``seed``: an int, or a (1,) int32 tensor on the card."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    h, inter, n, l, le, causal, p = case
    g = _gen(sum(case[:5]))
    x, enc, kp, w = _train_inputs(h, inter, n, l, le, g, cuda, bias_scale)
    kw = dict(n_head=8, causal=causal, p=p, p_input=p)
    counts = {k: _build.LAUNCHES[k] for k in ("train_fwd", "train_ffn_bwd",
                                               "train_attn_bwd", "train_wgrad")}
    tol = dict(tol=TRAIN_TOL, rms_tol=TRAIN_RMS_TOL)
    out, r2 = FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)
    out_p, r2_p = FT.train_fwd_plain(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    _close(out, out_p, what="out", **tol)
    _close(r2, r2_p, what="r2", **tol)
    assert torch.all(out[kp] == 0) and torch.all(r2[:, l:] == 0)

    dy = torch.randn(n, l, h, generator=g).to(cuda)
    dr2, prods = FT.ffn_bwd_operands(r2, dy, kp, w, seed, p=p)
    dr2_p, prods_p = FT.ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=p)
    _close(dr2, dr2_p, what="dr2", **tol)
    dx, denc, aprods = FT.attn_bwd_operands(x, enc, dr2, kp, w, seed, **kw)
    dx_p, denc_p, aprods_p = FT.attn_bwd_operands_plain(x, enc, dr2, kp, w, seed, **kw)
    _close(dx, dx_p, what="dx", **tol)
    _close(denc, denc_p, what="denc", **tol)
    parts = {pr.b: pr.part for pr in prods_p + aprods_p}
    for a, b in zip(prods + aprods, prods_p + aprods_p):
        _close(a.P, b.P, what=a.w + " P", **tol)
        _close(a.Q, b.Q, what=a.w + " Q", **tol)
        if a.b in ("bk_s", "bk_c"):
            # a key bias's gradient is zero in exact arithmetic (it shifts a
            # query's scores alike), so both sides are rounding noise: its
            # largest error is held to the query bias's scale
            _close(a.part, b.part, TRAIN_TOL, a.b + " partial sums",
                   like=parts[a.b.replace("bk_", "bq_")])
        else:
            _close(a.part, b.part, what=a.b + " partial sums", **tol)

    grads = FT.weight_grads(prods + aprods[:6])
    grads.update(FT.weight_grads(aprods[6:]))
    want = FT.weight_grads_plain(prods + aprods)
    torch.cuda.synchronize()
    for k in FT.WEIGHT_KEYS:
        _close(grads[k], want[k], WGRAD_TOL, k, rms_tol=WGRAD_RMS_TOL)
    assert {k: _build.LAUNCHES[k] - v for k, v in counts.items()} == {
        "train_fwd": 1, "train_ffn_bwd": 1, "train_attn_bwd": 1, "train_wgrad": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_train_kernels_match_plain(cuda, case):
    _check_train_kernels(cuda, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [TRAIN_CASES[1], TRAIN_CASES[5]],
                         ids=lambda c: "x".join(map(str, c)))
def test_train_kernels_match_plain_with_large_biases(cuda, case):
    """Every bias U(-1, 1), ten times the others' scale: a bias that a
    kernel left out, or added at the wrong site, moves every element of
    the tensors downstream of it well past the rms tolerance."""
    _check_train_kernels(cuda, case, bias_scale=10.0)


# The row walk of K12a/K12b (csrc/row_gemm.cuh) at its edges: N * Lp no
# multiple of 64 (N 1, 7, 33), Lp 16 and 32, FFN 1056 (a 64-column tile
# half past the end), H = 128 (head width 16), Le 5, 17 and 32, causal and
# NAR, p 0 and 0.5.
ROW_CASES = [  # H, FFN, N, L, Le, causal, p
    (512, 2048, 1, 30, 16, False, 0.5),
    (512, 1056, 7, 16, 17, True, 0.5),
    (128, 256, 7, 13, 5, False, 0.0),
    (256, 1056, 9, 32, 32, True, 0.5),
    (512, 2048, 33, 7, 17, False, 0.5),
    (128, 1056, 1, 5, 32, True, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_train_bwd_row_walk_matches_plain(cuda, case):
    _check_train_kernels(cuda, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [ROW_CASES[1], ROW_CASES[2]],
                         ids=lambda c: "x".join(map(str, c)))
def test_train_bwd_row_walk_matches_plain_with_large_biases(cuda, case):
    _check_train_kernels(cuda, case, bias_scale=10.0)


# K11 on the row walk: the tiles rg_plan picks for the H-wide products, 64 x
# 64 at N * Lp = 2048 rows (B = 64), 64 x 128 at 3200 (N = 100), 128 x 128
# at 65536 (B = 2048); NAR and causal, p 0 and 0.5 with p_input 0, 0.3 or
# 0.5, a ragged row count (33 * 16), FFN 1056 and 288, H 128 and 256.
FWD_CASES = [  # H, FFN, N, L, Le, causal, p, p_input
    (512, 2048, 64, 30, 16, False, 0.5, 0.3),
    (512, 2048, 100, 30, 16, False, 0.5, 0.0),
    (512, 2048, 100, 29, 16, True, 0.0, 0.5),
    (512, 2048, 2048, 30, 16, False, 0.5, 0.5),
    (256, 1056, 33, 7, 17, True, 0.5, 0.3),
    (128, 288, 5, 32, 32, False, 0.0, 0.0),
]


def _check_train_fwd(cuda, case, bias_scale=1.0):
    """K11 against its plain version with the last sequence all PAD: out and
    r2 within the training tolerances, zero at PAD rows and past L, bit for
    bit the same in two calls, one launch a call."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    h, inter, n, l, le, causal, p, p_input = case
    g = _gen(sum(case[:5]))
    x, enc, kp, w = _train_inputs(h, inter, n, l, le, g, cuda, bias_scale)
    kp[-1] = True
    kw = dict(n_head=8, causal=causal, p=p, p_input=p_input)
    before = _build.LAUNCHES["train_fwd"]
    out, r2 = FT.train_fwd(x, enc, kp, w, 31337, out_dtype=torch.bfloat16, **kw)
    assert _build.LAUNCHES["train_fwd"] == before + 1
    out2, r22 = FT.train_fwd(x, enc, kp, w, 31337, out_dtype=torch.bfloat16, **kw)
    out_p, r2_p = FT.train_fwd_plain(x, enc, kp, w, 31337, out_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    _close(out, out_p, TRAIN_TOL, "out", rms_tol=TRAIN_RMS_TOL)
    _close(r2, r2_p, TRAIN_TOL, "r2", rms_tol=TRAIN_RMS_TOL)
    assert torch.all(out[kp] == 0) and torch.all(r2[:, l:] == 0) and torch.all(r2[-1] == 0)
    assert torch.equal(out, out2) and torch.equal(r2, r22)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_train_fwd_row_walk_matches_plain(cuda, case):
    _check_train_fwd(cuda, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FWD_CASES[1], FWD_CASES[4]],
                         ids=lambda c: "x".join(map(str, c)))
def test_train_fwd_row_walk_matches_plain_with_large_biases(cuda, case):
    """Every bias ten times the others' scale (see the backward's)."""
    _check_train_fwd(cuda, case, bias_scale=10.0)


@pytest.mark.cuda
def test_train_bwd_at_the_b2048_shape(cuda):
    """The training step's B = 2048 NACF pass: 65536 operand rows, 1024 row
    tiles."""
    _check_train_kernels(cuda, (512, 2048, 2048, 30, 16, False, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [ROW_CASES[1], TRAIN_CASES[0]],
                         ids=lambda c: "x".join(map(str, c)))
def test_train_bwd_repeats_bitwise(cuda, case):
    """Every sum of K12a/K12b runs in a fixed order (no atomics): two calls
    on the same inputs give the same bits in every output."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    h, inter, n, l, le, causal, p = case
    x, enc, kp, w = _train_inputs(h, inter, n, l, le, _gen(5), cuda)
    dy = torch.randn(n, l, h, generator=_gen(6)).to(cuda)
    kw = dict(n_head=8, causal=causal, p=p, p_input=p)
    _, r2 = FT.train_fwd(x, enc, kp, w, 7, **kw)

    def run():
        dr2, fp = FT.ffn_bwd_operands(r2, dy, kp, w, 7, p=p)
        dx, denc, ap = FT.attn_bwd_operands(x, enc, dr2, kp, w, 7, **kw)
        return [dr2, dx, denc] + [t for pr in fp + ap for t in (pr.P, pr.Q, pr.part)]

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_train_layer_autograd_on_the_card(cuda):
    """The autograd Function on CUDA tensors: gradients of x, enc and the
    float32 parameters against the plain versions on the same inputs."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    g = _gen(11)
    x, enc, kp, w16 = _train_inputs(256, 1024, 9, 17, 16, g, cuda)
    params = {k: v.float().clone().requires_grad_() for k, v in w16.items()}
    xs = x.clone().requires_grad_()
    es = enc.clone().requires_grad_()
    out = FT.fused_bert_layer_train(xs, es, kp, params, 99, n_head=8, p_hidden=0.5,
                                    p_input=0.5, out_dtype=torch.bfloat16)
    dy = torch.randn(out.shape, generator=g).to(cuda, torch.bfloat16)
    got = torch.autograd.grad(out, [xs, es] + [params[k] for k in FT.WEIGHT_KEYS], dy)
    w = FT.kernel_weights(params, torch.bfloat16)
    _, r2 = FT.train_fwd_plain(x, enc, kp, w, 99, n_head=8, p=0.5, p_input=0.5)
    dr2, gf = FT.train_ffn_bwd_plain(r2, dy.float(), kp, w, 99, p=0.5)
    dx, denc, ga = FT.train_attn_bwd_plain(x, enc, dr2, kp, w, 99, n_head=8, p=0.5,
                                           p_input=0.5)
    gf.update(ga)
    _close(got[0], dx, TRAIN_TOL, "dx", rms_tol=TRAIN_RMS_TOL)
    _close(got[1], denc, TRAIN_TOL, "denc", rms_tol=TRAIN_RMS_TOL)
    for k, v in zip(FT.WEIGHT_KEYS, got[2:]):
        if k in ("bk_s", "bk_c"):  # key biases: see _check_train_kernels
            _close(v, gf[k], TRAIN_TOL, k, like=gf[k.replace("bk_", "bq_")])
        else:
            _close(v, gf[k], TRAIN_TOL, k, rms_tol=TRAIN_RMS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 - 1, -5])
def test_train_dropout_bits_on_the_card_equal_the_plain_bits(cuda, seed):
    """With zero matrices the layer exposes its masks: x = 1 and bo2 = 1
    give out = 2 * m_final * (2 * m_down + 1); bo_s = 1 and bo_c = 4 give
    r2 = 2 * m_self + 8 * m_cross; p = 0 and p_input = 0.5 give out = 2 *
    m_input. Each mask must be the lattice's."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    n, l, le, h, inter = 19, 13, 8, 128, 256
    th = 1 << 23

    def weights(**bias):
        w = {k: torch.zeros((h, h) if k in FT.MATS else (h,), device=cuda)
             for k in FT.WEIGHT_KEYS}
        w.update(wi=torch.zeros(inter, h, device=cuda), bi=torch.zeros(inter, device=cuda),
                 wo2=torch.zeros(h, inter, device=cuda))
        for k, v in bias.items():
            w[k] = torch.full((h,), float(v), device=cuda)
        return FT.kernel_weights(w, torch.bfloat16)

    def mask(site):
        return (FT.lattice_bits(seed, site, n, l, h) >= th).float().to(cuda)

    x1, kp = torch.ones(n, l, h, device=cuda), torch.zeros(n, l, dtype=torch.bool,
                                                            device=cuda)
    enc = torch.zeros(n, le, h, device=cuda)
    out, _ = FT.train_fwd(x1, enc, kp, weights(bo2=1), seed, n_head=2, p=0.5)
    want = 2 * mask(FT.SITE_FFN_FINAL) * (2 * mask(FT.SITE_FFN_DOWN) + 1)
    assert torch.equal(out, want)
    _, r2 = FT.train_fwd(torch.zeros_like(x1), enc, kp, weights(bo_s=1, bo_c=4), seed,
                         n_head=2, p=0.5)
    want = 2 * mask(FT.SITE_SELF_OUT) + 8 * mask(FT.SITE_CROSS_OUT)
    assert torch.equal(r2[:, :l].float(), want)
    out, _ = FT.train_fwd(x1, enc, kp, weights(), seed, n_head=2, p=0.0, p_input=0.5)
    assert torch.equal(out, 2 * mask(FT.SITE_INPUT))


@pytest.mark.cuda
def test_train_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from navc_tpu_torch.ops import fused_layer_train as FT

    g = _gen(3)
    x, enc, kp, w = _train_inputs(256, 1024, 2, 10, 8, g, cuda)
    with pytest.raises(ValueError, match="bfloat16 only"):
        FT.train_fwd(x, enc, kp, w, 0, n_head=8, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        FT.train_fwd(x.to(torch.bfloat16), enc, kp, w, 0, n_head=8)
    with pytest.raises(ValueError, match="lengths|length"):
        FT.train_fwd(torch.zeros(2, 33, 256, device=cuda), enc,
                     torch.zeros(2, 33, dtype=torch.bool, device=cuda), w, 0, n_head=8)


WGRAD_CASES = [  # products of one launch: (R, M, K) each
    [(16, 32, 32)],
    [(2048, 2048, 512), (2048, 512, 2048)],          # the FFN call at B = 64
    [(2048, 512, 512)] * 6 + [(1024, 512, 512)] * 2,  # the attention call
    [(1000, 96, 160), (1000, 2048, 32), (1000, 32, 2048)],  # rows not a multiple of 64
    [(777, 224, 1056)],
]


def _wgrad_products(case, g, dev, ints=False):
    from navc_tpu_torch.ops import fused_layer_train as FT

    def rows(r, c):
        if ints:  # small integers: every product and sum is exact in float32
            return torch.randint(-2, 3, (r, c), generator=g).to(dev, torch.bfloat16)
        return torch.randn(r, c, generator=g).to(dev, torch.bfloat16)

    return [FT.Product("w%d" % i, "b%d" % i, rows(r, m), rows(r, k),
                       torch.randn(7, m, generator=g).to(dev))
            for i, (r, m, k) in enumerate(case)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGRAD_CASES,
                         ids=lambda c: "+".join("x".join(map(str, p)) for p in c[:2]))
def test_weight_grads_match_plain_and_repeat_bitwise(cuda, case):
    from navc_tpu_torch.ops import fused_layer_train as FT

    prods = _wgrad_products(case, _gen(len(case) + case[0][0]), cuda)
    before = _build.LAUNCHES["train_wgrad"]
    got = FT.weight_grads(prods)
    again = FT.weight_grads(prods)
    assert _build.LAUNCHES["train_wgrad"] == before + 2
    want = FT.weight_grads_plain(prods)
    torch.cuda.synchronize()
    for k, v in want.items():
        _close(got[k], v, WGRAD_TOL, k, rms_tol=WGRAD_RMS_TOL)
        assert torch.equal(got[k], again[k]), k  # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("case", [WGRAD_CASES[0], WGRAD_CASES[3], WGRAD_CASES[4]],
                         ids=["16x32x32", "1000-rows", "777x224x1056"])
def test_weight_grads_are_exact_on_small_integers(cuda, case):
    """Integer operands make every sum exact in any order: the kernel's
    tiles, edges and operand layout must give the plain version's bits."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    prods = _wgrad_products(case, _gen(3), cuda, ints=True)
    got = FT.weight_grads(prods)
    want = FT.weight_grads_plain(prods)
    torch.cuda.synchronize()
    for pr in prods:
        assert torch.equal(got[pr.w], want[pr.w]), pr.w


@pytest.mark.cuda
def test_weight_grads_refuse_what_the_kernel_does_not_take(cuda):
    from navc_tpu_torch.ops import fused_layer_train as FT

    (pr,) = _wgrad_products([(64, 64, 64)], _gen(4), cuda)
    flat = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        FT.weight_grads([pr._replace(P=flat[4:].view(64, 64))])
    with pytest.raises(ValueError, match="multiples of 32"):
        FT.weight_grads([pr._replace(P=pr.P[:, :48].contiguous(), part=pr.part[:, :48])])
    with pytest.raises(ValueError, match="at most"):
        FT.weight_grads([pr] * 9)


CE_TOL, CE_RMS_TOL = 1e-4, 2e-5  # g, z: float32 sums in another order
CE_CASES = [  # N, D, V, bias
    (1920, 512, 10048, True),
    (1920, 512, 10048, False),
    (37, 64, 157, False),
    (200, 128, 1000, True),
    (65, 512, 130, True),
    (1, 512, 10048, True),      # one row: the dh launch's widest vocab split
    (61440, 512, 10048, True),  # the B = 2048 pass: the dW launch's row split
] + [  # N not a multiple of 64, every D and V the kernels' tiles meet
    (333, d, v, (d + v) % 2 == 0) for d in (64, 128, 256, 512) for v in (130, 1001, 10048)]


def _ce_inputs(n, d, v, with_bias, g, dev, bias_scale=0.1):
    h = torch.randn(n, d, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(v, d, generator=g) / math.sqrt(d)).to(dev, torch.bfloat16)
    bias = (torch.randn(v, generator=g) * bias_scale).to(dev) if with_bias else None
    lab = torch.randint(0, v, (n,), generator=g, dtype=torch.int32).to(dev)
    dg = (torch.randn(n, generator=g) * (torch.rand(n, generator=g) > 0.3)).to(dev)
    return h, w, bias, lab, dg


def _margin_ok_ce(h, w, bias):
    s = h.float() @ w.float().t() + (0 if bias is None else bias)
    top2 = s.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > 1e-3


def _check_ce(cuda, case, bias_scale=0.1):
    from navc_tpu_torch.ops import vocab_ce as VC

    n, d, v, with_bias = case
    h, w, bias, lab, dg = _ce_inputs(n, d, v, with_bias, _gen(n + d + v), cuda, bias_scale)
    counts = {k: _build.LAUNCHES[k] for k in ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")}
    g, pred, z = VC.vocab_ce_fwd(h, w, bias, lab)
    g_p, pred_p, z_p = VC.vocab_ce_fwd_plain(h, w, bias, lab)
    torch.cuda.synchronize()
    _close(g, g_p, CE_TOL, "g", rms_tol=CE_RMS_TOL)
    _close(z, z_p, CE_TOL, "z", rms_tol=CE_RMS_TOL)
    ok = _margin_ok_ce(h, w, bias)
    assert torch.equal(pred[ok], pred_p[ok])
    dh, dw, db = VC.vocab_ce_bwd(h, w, bias, lab, z, dg, dh_dtype=torch.bfloat16)
    dh_p, dw_p, db_p = VC.vocab_ce_bwd_plain(h, w, bias, lab, z_p, dg)
    torch.cuda.synchronize()
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    tol = dict(tol=TRAIN_TOL, rms_tol=TRAIN_RMS_TOL)
    _close(dh, dh_p, what="dh", **tol)
    _close(dw, dw_p, what="dW", **tol)
    assert (db is None) == (bias is None)
    if db is not None:
        _close(db, db_p, what="db", **tol)
    assert torch.all(dh[dg == 0] == 0)
    assert {k: _build.LAUNCHES[k] - c for k, c in counts.items()} == {
        "ce_fwd": 1, "ce_bwd_dh": 1, "ce_bwd_dw": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_vocab_ce_kernels_match_plain(cuda, case):
    _check_ce(cuda, case)


@pytest.mark.cuda
def test_vocab_ce_kernels_match_plain_with_a_large_bias(cuda):
    """A bias ten times the scores' scale: a kernel that dropped it, in the
    forward or in either backward recompute, fails every check."""
    _check_ce(cuda, (300, 256, 1000, True), bias_scale=10.0)


@pytest.mark.cuda
def test_vocab_ce_masked_rows_and_ties(cuda):
    from navc_tpu_torch.ops import vocab_ce as VC

    h, w, bias, lab, _ = _ce_inputs(100, 128, 300, True, _gen(5), cuda)
    z = VC.vocab_ce_fwd(h, w, bias, lab)[2]
    dh, dw, db = VC.vocab_ce_bwd(h, w, bias, lab, z, torch.zeros(100, device=cuda))
    torch.cuda.synchronize()
    assert not dh.any() and not dw.any() and not db.any()
    ht = torch.ones(3, 64, dtype=torch.bfloat16, device=cuda)
    wt = torch.zeros(200, 64, dtype=torch.bfloat16, device=cuda)
    wt[[70, 9, 130]] = 1.0
    _, pred, _ = VC.vocab_ce_fwd(ht, wt, None, torch.zeros(3, dtype=torch.int32, device=cuda))
    assert pred.tolist() == [9, 9, 9]


@pytest.mark.cuda
def test_vocab_ce_fwd_ties_inside_one_thread_and_across_splits(cuda):
    """K9 keeps K3's tie rules on its walk: columns 1, 9, 17 and 121 of a
    128-column tile fall to one thread of the epilogue, 129 to the next
    tile; at 3072 rows equal maxima in two vocab splits and twice inside a
    tile. The lowest id wins, and the label log-prob at it is the max's."""
    from navc_tpu_torch.ops import vocab_ce as VC
    from navc_tpu_torch.ops.vocab_fused import argmax_splits, split_ranges

    h = torch.ones(300, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(1001, 64, dtype=torch.bfloat16, device=cuda)
    w[[121, 17, 129, 9, 1]] = 1.0
    lab = torch.full((300,), 9, dtype=torch.int32, device=cuda)
    g, pred, z = VC.vocab_ce_fwd(h, w, None, lab)
    assert pred.tolist() == [1] * 300
    g_p, _, z_p = VC.vocab_ce_fwd_plain(h, w, None, lab)
    torch.cuda.synchronize()
    _close(g, g_p, CE_TOL, "g")
    _close(z, z_p, CE_TOL, "z")

    r, d, v = 3072, 512, 10048
    g_ = _gen(8)
    hid = torch.randn(1, d, generator=g_).expand(r, d).contiguous().to(cuda, torch.bfloat16)
    w = (torch.randn(v, d, generator=g_) / math.sqrt(d)).to(cuda, torch.bfloat16)
    ranges = split_ranges(v, *argmax_splits(r, v, torch.cuda.get_device_properties(
        cuda).multi_processor_count))
    assert len(ranges) >= 3
    ties = [ranges[2][0] + 5, ranges[2][0] + 6, ranges[1][1] - 1]
    w[ties] = (hid[0].float() / hid[0].float().norm() * 40).to(torch.bfloat16)
    lab = torch.tensor(ties * (r // 3), dtype=torch.int32, device=cuda)
    g, pred, z = VC.vocab_ce_fwd(hid, w, None, lab)
    assert pred.tolist() == [ties[2]] * r
    g_p, _, z_p = VC.vocab_ce_fwd_plain(hid, w, None, lab)
    torch.cuda.synchronize()
    _close(g, g_p, CE_TOL, "g (ties)", rms_tol=CE_RMS_TOL)
    _close(z, z_p, CE_TOL, "z (ties)", rms_tol=CE_RMS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 512])
def test_vocab_ce_label_at_the_last_column_of_a_ragged_tile(cuda, d):
    """Labels V - 1 (the last column of a ragged last vocab tile in every
    launch's tiling) and 0 (PAD) against the plain versions; the columns
    past V, which TMA fills with zeros, must not enter the sum-exp or ds."""
    r, v = 150, 1001
    h, w, bias, _, dg = _ce_inputs(r, d, v, True, _gen(d + 6), cuda, bias_scale=2.0)
    lab = torch.full((r,), v - 1, dtype=torch.int32, device=cuda)
    lab[::3] = 0
    _check_ce_on(cuda, h, w, bias, lab, dg)


def _check_ce_on(cuda, h, w, bias, lab, dg):
    from navc_tpu_torch.ops import vocab_ce as VC

    g, pred, z = VC.vocab_ce_fwd(h, w, bias, lab)
    g_p, pred_p, z_p = VC.vocab_ce_fwd_plain(h, w, bias, lab)
    dh, dw, db = VC.vocab_ce_bwd(h, w, bias, lab, z, dg)
    dh_p, dw_p, db_p = VC.vocab_ce_bwd_plain(h, w, bias, lab, z_p, dg)
    torch.cuda.synchronize()
    _close(g, g_p, CE_TOL, "g", rms_tol=CE_RMS_TOL)
    _close(z, z_p, CE_TOL, "z", rms_tol=CE_RMS_TOL)
    ok = _margin_ok_ce(h, w, bias)
    assert torch.equal(pred[ok], pred_p[ok])
    for name, a, b in (("dh", dh, dh_p), ("dW", dw, dw_p), ("db", db, db_p)):
        if b is not None:
            _close(a, b, TRAIN_TOL, name, rms_tol=TRAIN_RMS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,live", [(1920, 1), (61440, 70), (333, 333), (200, 65), (333, 0)],
                         ids=lambda x: str(x))
def test_vocab_ce_bwd_with_few_or_all_rows_live(cuda, n, live):
    """K10 runs the rows with dg != 0 only: one live row (every other dh
    block exits), 70 of 61440 (most of the dW launch's row splits empty:
    they must add zeros), all rows, a live count one past a 64-row chunk,
    and none (zero gradients), each against the plain versions."""
    d, v = 256, 1001
    h, w, bias, lab, _ = _ce_inputs(n, d, v, True, _gen(n + live), cuda)
    g = _gen(live)
    dg = torch.zeros(n)
    dg[torch.randperm(n, generator=g)[:live]] = torch.rand(live, generator=g) + 0.5
    _check_ce_on(cuda, h, w, bias, lab, dg.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,live", [(1920, 512, 1184), (61440, 512, 37009), (1, 64, 1),
                                      (1, 64, 0), (333, 96, 333), (1500, 128, 64)],
                         ids=lambda x: str(x))
def test_vocab_ce_live_first_matches_plain(cuda, n, d, live):
    """K10's compaction kernel against its plain version: the order, the
    gathered labels, z and dg and the live count exactly; hl's rows up to
    the end of the last 64-row tile that holds a live row (the rows the
    launches read) bit for bit; the rest of meta[4] is not written."""
    from navc_tpu_torch.ops import vocab_ce as VC

    g = _gen(n + d + live)
    h = torch.randn(n, d, generator=g).to(cuda, torch.bfloat16)
    lab = torch.randint(0, 10048, (n,), generator=g, dtype=torch.int32).to(cuda)
    z = torch.randn(n, generator=g).to(cuda)
    dg = torch.zeros(n)
    dg[torch.randperm(n, generator=g)[:live]] = torch.randn(live, generator=g)
    dg = dg.to(cuda)
    hl, meta = VC.live_first(h, lab, z, dg)
    hl_p, meta_p = VC.live_first_plain(h, lab, z, dg)
    torch.cuda.synchronize()
    assert torch.equal(meta[:4], meta_p[:4]) and int(meta[4, 0]) == int(meta_p[4, 0])
    read = min(n, -(-int(meta_p[4, 0]) // VC.CE_TILE) * VC.CE_TILE)
    assert torch.equal(hl[:read], hl_p[:read])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1920, 512, 10048), (61440, 512, 10048), (1, 512, 10048),
                                  (333, 96, 1001)], ids=lambda c: "x".join(map(str, c)))
def test_vocab_ce_bwd_repeats_bitwise(cuda, case):
    """No atomics: two calls on the same operands give the same bits (at
    N = 1920 the dh vocab split and the dW row split both run)."""
    from navc_tpu_torch.ops import vocab_ce as VC

    n, d, v = case
    h, w, bias, lab, dg = _ce_inputs(n, d, v, True, _gen(n + 1), cuda)
    z = VC.vocab_ce_fwd(h, w, bias, lab)[2]
    one = VC.vocab_ce_bwd(h, w, bias, lab, z, dg)
    two = VC.vocab_ce_bwd(h, w, bias, lab, z, dg)
    torch.cuda.synchronize()
    for name, a, b in zip(("dh", "dW", "db"), one, two):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1920, 512, 10048), (333, 128, 1001), (70, 64, 130),
                                  (200, 320, 1001)], ids=lambda c: "x".join(map(str, c)))
def test_vocab_ce_bwd_is_exact_on_small_integers(cuda, case):
    """z = +inf makes ds = dg * onehot(label) exactly, and integer h, W and
    dg make every product and sum exact in float32: dh must be dg times the
    label's row of W and dW, db the sums over each label's rows, bit for
    bit. This holds the ds tile's swizzled layout (the label's column must
    meet its W row in the K-major product), and the MN-major operands of
    both products (W read as dh's B, ds and h as dW's A and B)."""
    from navc_tpu_torch.ops import vocab_ce as VC

    n, d, v = case
    g = _gen(n + d + 64)
    h = torch.randint(-2, 3, (n, d), generator=g).to(cuda, torch.bfloat16)
    w = torch.randint(-2, 3, (v, d), generator=g).to(cuda, torch.bfloat16)
    bias = torch.randn(v, generator=g).to(cuda)
    lab = torch.randint(0, v, (n,), generator=g, dtype=torch.int32).to(cuda)
    dg = torch.randint(-2, 3, (n,), generator=g).to(cuda, torch.float32)
    z = torch.full((n,), math.inf, device=cuda)
    dh, dw, db = VC.vocab_ce_bwd(h, w, bias, lab, z, dg)
    dh_p, dw_p, db_p = VC.vocab_ce_bwd_plain(h, w, bias, lab, z, dg)
    torch.cuda.synchronize()
    assert torch.equal(dh, dh_p)
    assert torch.equal(dw, dw_p)
    assert torch.equal(db, db_p)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_vocab_ce_autograd_on_the_card(cuda, tied):
    """The autograd Function on CUDA tensors (float32 parameters, bf16
    hidden states) against autograd of the plain forward on the same
    inputs; the Function rounds ds to bf16 where autograd does not."""
    from navc_tpu_torch.ops import vocab_ce as VC

    h, w, bias, lab, dg = _ce_inputs(130, 512, 2000, tied, _gen(8), cuda)
    hs = h.clone().requires_grad_()
    ws = w.float().clone().requires_grad_()
    bs = None if bias is None else bias.clone().requires_grad_()
    g, _ = VC.vocab_ce_train(hs.view(10, 13, 512), ws, bs, lab.view(10, 13))
    got = torch.autograd.grad((g.view(-1) * dg).sum(), [hs, ws] + ([bs] if tied else []))
    hr = h.float().requires_grad_()
    wr = w.float().requires_grad_()
    br = None if bias is None else bias.clone().requires_grad_()
    s = hr @ wr.t() + (0 if br is None else br)
    gr = torch.log_softmax(s, -1).gather(1, lab.long()[:, None])[:, 0]
    want = torch.autograd.grad((gr * dg).sum(), [hr, wr] + ([br] if tied else []))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, a, b in zip(("dh", "dW", "db"), got, want):
        _close(a, b, TRAIN_TOL, name, rms_tol=TRAIN_RMS_TOL)


@pytest.mark.cuda
def test_vocab_ce_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from navc_tpu_torch.ops import vocab_ce as VC

    h, w, bias, lab, dg = _ce_inputs(8, 64, 100, True, _gen(2), cuda)
    with pytest.raises(ValueError, match="bfloat16 only"):
        VC.vocab_ce_fwd(h, w, bias, lab, compute_dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        VC.vocab_ce_fwd(h.float(), w, bias, lab)
    with pytest.raises(ValueError, match="multiple of 32"):
        VC.vocab_ce_fwd(h[:, :48].contiguous(), w[:, :48].contiguous(), bias, lab)
    with pytest.raises(ValueError, match="int32"):
        VC.vocab_ce_fwd(h, w, bias, lab.long())
    with pytest.raises(ValueError, match="float32"):
        VC.vocab_ce_fwd(h, w, bias.double(), lab)
    z = VC.vocab_ce_fwd(h, w, bias, lab)[2]
    with pytest.raises(ValueError, match="z and dg"):
        VC.vocab_ce_bwd(h, w, bias, lab, z, dg[:4])
    flat = torch.zeros(8 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        VC.vocab_ce_fwd(flat[4:].view(8, 64), w, bias, lab)
    with pytest.raises(ValueError, match="16-byte"):
        VC.vocab_ce_bwd(flat[4:].view(8, 64), w, bias, lab, z, dg)


@pytest.mark.cuda
def test_vocab_ce_train_copies_a_misaligned_view(cuda):
    """The autograd Function hands the kernels aligned operands: a hidden
    state that is a view 2 elements into its storage is copied, not
    refused."""
    from navc_tpu_torch.ops import vocab_ce as VC

    h, w, bias, lab, dg = _ce_inputs(20, 64, 300, True, _gen(12), cuda)
    store = torch.zeros(20 * 64 + 2, dtype=torch.bfloat16, device=cuda)
    store[2:] = h.reshape(-1)
    hv = store[2:].view(20, 64)
    assert hv.data_ptr() % 16
    g, _ = VC.vocab_ce_train(hv, w.float(), bias, lab)
    want, _, _ = VC.vocab_ce_fwd_plain(h, w, bias, lab)
    torch.cuda.synchronize()
    _close(g, want, CE_TOL, "g", rms_tol=CE_RMS_TOL)


def _unfolded_inputs(shape, cuda):
    n, l, le, h, inter = shape
    g = _gen(sum(shape))
    w = _weights(h, inter, g, cuda)
    lengths = torch.randint(1, l + 1, (n,), generator=g)
    lengths[0] = l
    kp = (torch.arange(l)[None] >= lengths[:, None]).to(cuda)
    x = torch.randn(n, l, h, generator=g).to(cuda)
    enc = torch.randn(n, le, h, generator=g).to(cuda)
    return x, enc, kp, w


UNFOLDED_SHAPES = [(384, 32, 16, 512, 2048), (7, 13, 5, 256, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
@pytest.mark.parametrize("shape", UNFOLDED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_layer_unfolded_matches_plain(cuda, shape, causal):
    from navc_tpu_torch.ops.fused_layer import (fused_layer_unfolded,
                                                fused_layer_unfolded_plain)

    x, enc, kp, w = _unfolded_inputs(shape, cuda)
    before = _build.LAUNCHES["fused_layer_unfolded"]
    out = fused_layer_unfolded(x, enc, kp, w, n_head=8, causal=causal,
                               out_dtype=torch.bfloat16)
    want = fused_layer_unfolded_plain(x, enc, kp, w, 8, causal, torch.bfloat16)
    torch.cuda.synchronize()
    _close(out, want, TRAIN_TOL, "out", rms_tol=TRAIN_RMS_TOL)
    assert torch.all(out[kp] == 0)
    assert _build.LAUNCHES["fused_layer_unfolded"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
@pytest.mark.parametrize("shape", UNFOLDED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_layer_unfolded_f32_repeats_bitwise_and_is_k11_at_p0(cuda, shape, causal):
    """A float32 output; two calls give the same bits, and they are K11's
    (train_fwd at p = p_input = 0: the same launches)."""
    from navc_tpu_torch.ops import fused_layer_train as FT
    from navc_tpu_torch.ops.fused_layer import (_train_dict, fused_layer_unfolded,
                                                fused_layer_unfolded_plain)

    x, enc, kp, w = _unfolded_inputs(shape, cuda)
    out = fused_layer_unfolded(x, enc, kp, w, 8, causal, torch.float32)
    want = fused_layer_unfolded_plain(x, enc, kp, w, 8, causal, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    _close(out, want, TRAIN_TOL, "out", rms_tol=TRAIN_RMS_TOL)
    assert torch.all(out[kp] == 0)
    assert torch.equal(fused_layer_unfolded(x, enc, kp, w, 8, causal, torch.float32), out)
    k11, _ = FT.train_fwd(x, enc, kp, _train_dict(w), 12345, n_head=8, causal=causal, p=0.0,
                          p_input=0.0, out_dtype=torch.float32)
    assert torch.equal(k11, out)


# -- the inference entry points on the card ------------------------------------
# The NACF paradigms and collect mode at the serving width (MSRVTT, d 512,
# 8 heads, vocab 10048, bf16, random weights from seeds) through K1-K4,
# against the CPU plain path on the same 8 videos: tokens agree on >= 99% of
# positions, chip_smoke.py's gate.

SERVE = dict(dataset="MSRVTT", vocab_size=10048, use_pallas=True)


def _serving_models(device, method="NACF", **kw):
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model

    cfg = default_config(method, **SERVE).replace(**kw)
    tcfg = default_config("ARB", **SERVE)
    return (cfg, build_model(cfg, device=device, generator=_gen(0)),
            tcfg, build_model(tcfg, device=device, generator=_gen(1)))


def _decode(device, videos=8, collect=False, **kw):
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, tcfg, teacher = _serving_models(device, **kw)
    g = _gen(5)
    feats = [torch.randn(videos, cfg.n_frames, d, generator=g).to(device)
             for d in cfg.modality_dims]
    cat = torch.randint(0, cfg.num_category, (videos, 1), generator=g).to(device)
    with torch.no_grad():
        out = make_nar_generator(cfg, model, teacher, collect=collect)(
            model.encode(feats), cat, teacher.encode(feats))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(paradigm="l2r", use_ct=True, q=1, q_iterations=1),
                                dict(paradigm="l2r", use_ct=False, q=1, q_iterations=1),
                                dict(paradigm="ef", use_ct=False, q=1, q_iterations=1)],
                         ids=["l2r-ct", "l2r", "ef"])
def test_paradigms_on_the_card_agree_with_the_cpu_plain_path(cuda, kw):
    _build.reset_launches()
    got = _decode("cuda", **kw).cpu()
    for name in ("fused_layer", "project_argmax", "project_gather_prob"):
        assert _build.LAUNCHES[name] > 0, name
    assert _build.LAUNCHES["fused_layer_qsub"] == 0
    want = _decode("cpu", **kw)
    agree = float((got == want).float().mean())
    assert agree >= 0.99, "token agreement %.4f" % agree


@pytest.mark.cuda
def test_collect_on_the_card_agrees_with_the_cpu_plain_path(cuda):
    _build.reset_launches()
    best, (toks, probs) = _decode("cuda", collect=True)
    assert _build.LAUNCHES["fused_layer_qsub"] == 0 and _build.LAUNCHES["fused_layer"] > 0
    assert toks.shape == (8, 6, 30) and torch.equal(toks[:, -1], best)
    assert torch.isfinite(probs).all()
    wbest, (wtoks, _) = _decode("cpu", collect=True)
    agree = float((toks.cpu() == wtoks).float().mean())
    assert agree >= 0.99, "iteration token agreement %.4f" % agree


@pytest.mark.cuda
def test_caption_pipeline_and_translate_on_the_card(cuda, tmp_path, monkeypatch):
    from navc_tpu_torch import constants as C
    from navc_tpu_torch.api import CaptionPipeline
    from navc_tpu_torch.cli.translate import build_parser, translate
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
    from navc_tpu_torch.runtime.checkpoint import save_checkpoint
    from navc_tpu_torch.runtime.evaluate import Evaluator

    cfg, model, tcfg, teacher = _serving_models("cuda")
    corpus, refs = make_synthetic_corpus(cfg, n_videos=20, n_caps=2, vocab_size=10048)
    feats = make_synthetic_feats(cfg, n_videos=20, n_total_frames=12)
    cp = str(tmp_path / "corpus.pkl")
    with open(cp, "wb") as f:
        pickle.dump(corpus, f)
    paths = {}
    for name, c, m in (("nacf", cfg, model), ("arb", tcfg, teacher)):
        c = c.replace(info_corpus=cp, checkpoint_path=str(tmp_path / name))
        paths[name] = save_checkpoint({"model": m, "settings": c}, str(tmp_path), name + ".ckpt")
    pipe = CaptionPipeline.from_checkpoints(paths["nacf"], teacher=paths["arb"])
    batch = {"feats_%s" % ch: np.stack([feats["feats_%s" % ch]["video%d" % i][:cfg.n_frames]
                                        for i in range(8)]) for ch in "im"}
    cat = np.arange(8) % cfg.num_category
    ids = pipe.caption_ids(batch, cat)
    ev = Evaluator(cfg, model, tcfg, teacher)
    want = ev.decode_batch(dict(batch, category=cat.reshape(8, 1).astype(np.int32)))[0]
    np.testing.assert_array_equal(ids, want)
    assert all(C.MASK_WORD not in s.split() for s in pipe.caption(batch, cat))

    opt = build_parser().parse_args(["--model_path", paths["nacf"], "--teacher_path",
                                     paths["arb"], "-batch_size", "8", "-em", "test"])
    res = translate(opt, device="cuda", info_corpus=corpus, in_memory_feats=feats,
                    references=refs)
    assert np.isfinite(res["test"]["CIDEr"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        translate(build_parser().parse_args(["--model_path", paths["arb"]]), device="cuda",
                  info_corpus=corpus, in_memory_feats=feats, references=refs)



# -- the captured decodes (jit=True, runtime/graphs.py) ------------------------
# At the serving width, against the eager route (jit=False) on the same
# inputs: tokens and scores bit for bit the same (the same kernels on the
# same operands, in the same order); a second signature-equal call with other
# features returns its own eager tokens (the static inputs are refilled);
# outputs held across a later replay keep their values (they are clones);
# launches counted per replay.


def _request_on(cfg, videos, seed, device="cuda"):
    g = _gen(seed)
    feats = [torch.randn(videos, cfg.n_frames, d, generator=g).to(device)
             for d in cfg.modality_dims]
    return feats, torch.randint(0, cfg.num_category, (videos, 1), generator=g).to(device)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _flat(part)]
    return [out]


def _same(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["teacher", "dict_mapping", "collect"])
def test_graphs_nacf_replays_eager_tokens(cuda, case):
    from navc_tpu_torch import constants as C
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, tcfg, teacher = _serving_models("cuda")
    dm = None
    if case == "dict_mapping":
        perm = torch.randperm(cfg.vocab_size - C.NUM_SPECIAL_TOKENS, generator=_gen(3))
        dm = torch.cat([torch.arange(C.NUM_SPECIAL_TOKENS),
                        perm + C.NUM_SPECIAL_TOKENS]).to(cuda)
    kw = dict(collect=case == "collect")
    eager = make_nar_generator(cfg, model, teacher, jit=False, **kw)
    replay = make_nar_generator(cfg, model, teacher, jit=True, **kw)
    assert replay.graphed and not eager.graphed
    reqs = [_request_on(cfg, 16, seed) for seed in (11, 12)]
    with torch.no_grad():
        encs = [(model.encode(f), c, teacher.encode(f)) for f, c in reqs]
    want = []
    for enc, cat, tenc in encs:
        _build.reset_launches()
        want.append(eager(enc, cat, tenc, dm))
        per_decode = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert per_decode["fused_layer_qsub" if case != "collect" else "fused_layer"] > 0
    got = [replay(enc, cat, tenc, dm) for enc, cat, tenc in encs]  # capture, replay
    assert len(replay.graphs) == 1
    _build.reset_launches()
    got += [replay(*encs[0], dm), replay(*encs[1], dm), replay(*encs[0], dm)]
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        k: 3 * v for k, v in per_decode.items()}
    for out, ref in zip(got, want + want + want[:1]):
        assert _same(out, ref)
    assert not _same(want[0], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("videos", [64, 60], ids=["b64-K6", "b60-K8"])
def test_graphs_arb_replays_eager_tokens(cuda, videos):
    from navc_tpu_torch.decoding import make_ar_generator

    _, _, cfg, model = _serving_models("cuda")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    eager = make_ar_generator(cfg, model, jit=False)
    replay = make_ar_generator(cfg, model)
    reqs = [_request_on(cfg, videos, seed) for seed in (13, 14)]
    with torch.no_grad():
        encs = [(model.encode(f), c) for f, c in reqs]
    want = [eager(*e) for e in encs]
    got = [replay(*e) for e in encs]
    steps0 = replay.steps_run
    _build.reset_launches()
    got += [replay(*encs[1]), replay(*encs[0])]
    steps = replay.steps_run - steps0
    assert steps > 0 and len(replay.graphs) == 1
    k6 = videos % 16 == 0
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == dict(
        project_topk=steps, **(dict(beam_attend_step=steps, cross_attend=steps) if k6
                               else dict(permute_beam_caches=steps)))
    for out, ref in zip(got, want + want[::-1]):
        assert _same(out, ref)
    assert not _same(want[0], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("method", ["nacf", "arb", "nab", "arb2"])
def test_graphs_streaming_captioner_keeps_each_request(cuda, method, depth):
    """Six requests of different videos through a replaying
    StreamingCaptioner at depth 1-3, each read once ``depth`` newer ones are
    queued and each the eager decode's bit for bit once all are read: NACF
    and NAB (mask-predict, no CT pass) with the ARB teacher, ARB and ARB2 by
    beam search. Each request's tokens come back through a page-locked
    buffer that later requests take again from torch's pinned cache, so
    every result handed back owns its memory."""
    from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    # ARB is _serving_models' teacher
    cfg, model, tcfg, teacher = _serving_models("cuda", {"arb": "NACF"}.get(method,
                                                                            method.upper()))
    if method == "arb":
        cfg, model, teacher = tcfg, teacher, None
    elif method == "arb2":
        teacher = None
    cap = StreamingCaptioner(cfg, model, None if teacher is None else (tcfg, teacher),
                             depth=depth)
    eager = (make_ar_generator(cfg, model, jit=False) if teacher is None
             else make_nar_generator(cfg, model, teacher, jit=False))
    reqs = [_request_on(cfg, 16, seed, "cpu") for seed in range(15, 21)]
    want = []
    for feats, cat in reqs:
        f = [x.to(cuda) for x in feats]
        with torch.no_grad():
            args = (model.encode(f), cat.to(cuda)) + (
                () if teacher is None else (teacher.encode(f),))
        out = eager(*args)
        want.append((out[0] if teacher is None else out).cpu().numpy())
    assert len({w.tobytes() for w in want}) == len(want)
    done = []
    for i, (feats, cat) in enumerate(reqs):
        out = cap.submit([x.numpy() for x in feats], cat.numpy())[1]
        assert [t for t, _ in out] == ([i - depth] if i >= depth else [])
        done += out
    done += cap.flush()
    assert [t for t, _ in done] == list(range(len(reqs)))
    for (_, got), ref in zip(done, want):
        assert got.flags.owndata
        np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_request_marks_and_inflight_count_at_depth_2(cuda):
    """Under a profile a replaying NACF captioner at depth 2 counts one
    device gap a request after the first and one in-flight count a result.
    With the card held busy after each decode (``torch.cuda._sleep``), the
    captioner's own read, which waits for the event behind the request's
    own tokens' copy, finds the two newer requests still running at each
    read (2, 2, 2, then 1 and 0 in the flush: 7 over 5), and the card never
    waits for a request; a read that drains the card first
    (``torch.cuda.synchronize()``) finds none (0 over 5), and the card
    waits while the host stages each next request."""
    from torch.profiler import ProfilerActivity, profile

    from navc_tpu_torch.runtime import summary
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    cfg, model, tcfg, teacher = _serving_models("cuda")
    reqs = []
    for seed in range(20, 25):
        feats, cat = _request_on(cfg, 16, seed, "cpu")
        reqs.append(([f.numpy() for f in feats], cat.numpy()))
    runs = {}
    for name in ("own", "drain"):
        cap = StreamingCaptioner(cfg, model, (tcfg, teacher), depth=2)
        list(cap.map_stream(reqs[:1]))  # the graphs captured outside the profile
        generate, sync = cap.generate, cap._sync

        def busy_after(*args, **kwargs):
            hyp = generate(*args, **kwargs)
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
            return hyp

        def drain_read(hyp):
            torch.cuda.synchronize()
            return sync(hyp)

        cap.generate = busy_after
        if name == "drain":
            cap._sync = drain_read
        summary.clear_record()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            done = []
            for feats, cat in reqs:
                done += cap.submit(feats, cat)[1]
            done += cap.flush()
        torch.cuda.synchronize()
        assert [t for t, _ in done] == list(range(1, len(reqs) + 1))
        runs[name] = summary.record()["counters"]
    summary.clear_record()
    for c in runs.values():
        assert c["navc.request_gap_s"]["count"] == len(reqs) - 1
        assert c["navc.inflight_at_result"]["count"] == len(reqs)
    assert runs["own"]["navc.inflight_at_result"]["total"] == 7
    assert 0 <= runs["own"]["navc.request_gap_s"]["total"] < 1e-3
    assert runs["drain"]["navc.inflight_at_result"]["total"] == 0
    assert runs["drain"]["navc.request_gap_s"]["total"] > 0


@pytest.mark.cuda
def test_graphs_refresh_replays_new_weights(cuda):
    from navc_tpu_torch.runtime.evaluate import Evaluator

    cfg, model, tcfg, teacher = _serving_models("cuda")
    feats, cat = _request_on(cfg, 16, 18, "cpu")
    batch = {"feats_%s" % ch: f.numpy() for ch, f in zip(cfg.modality.lower(), feats)}
    batch["category"] = cat.numpy().astype(np.int32)
    ev = Evaluator(cfg, model, tcfg, teacher)
    ev.refresh()
    before = ev.decode_batch(batch)[0]
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.add_(torch.randn(p.shape, generator=_gen(100 + i)).to(cuda) * 0.5)
    ev.refresh()
    after = ev.decode_batch(batch)[0]
    fresh = Evaluator(cfg, model, tcfg, teacher)
    fresh.refresh()
    np.testing.assert_array_equal(after, fresh.decode_batch(batch)[0])
    assert not np.array_equal(after, before)


@pytest.mark.cuda
def test_graphs_capture_outlives_old_graphs_in_reference_cycles(cuda):
    """An old graph that only the cycle collector frees must not be freed
    inside a later capture (CUDA refuses to destroy a graph while a stream
    captures). The captured function collects itself, while capturing, as
    an allocation could make the collector do at any point."""
    import gc

    from navc_tpu_torch.runtime import graphs

    x = torch.ones(8, device=cuda)
    thresholds = gc.get_threshold()
    gc.set_threshold(10 ** 9)  # no collections but the ones made here and by the capture
    try:
        old = graphs.Jitted(lambda t: t * 2)
        old(x)
        old.cycle = old
        del old

        def fn(t):
            if torch.cuda.is_current_stream_capturing():
                gc.collect()
            return t + 1

        new = graphs.Jitted(fn)
        new(x)
        assert torch.equal(new(x), x + 1)
    finally:
        gc.set_threshold(*thresholds)


@pytest.mark.cuda
def test_graphs_failed_capture_raises(cuda):
    from navc_tpu_torch.runtime import graphs

    calls = []

    def fn(x):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("refused while capturing")
        return x * 2

    f = graphs.Jitted(fn)
    with pytest.raises(RuntimeError):
        f(torch.ones(4, device=cuda))
    assert calls == [False, True] and not f.graphs  # warm-up, capture: no eager retry


# -- the captured l2r and ef (IF nodes, graphs.when) and the full-prefix ARB --
# navc_tpu's compiled l2r (a scan of rounds under lax.cond) and ef (a
# while_loop) replayed against the eager route (jit=False, which reads its
# mask counts on the host) at the serving width: tokens bit for bit, the
# launches of a replay those of an eager decode (the rounds that ran), no
# sync inside a replayed l2r decode and one lagged flag read per ef block;
# the beam's full-prefix step (NAVC_NO_KVCACHE) through K1 once per step.

COND_CASES = {"l2r": dict(paradigm="l2r", use_ct=False, q=1, q_iterations=1),
              "l2r-ct": dict(paradigm="l2r", use_ct=True, q=1, q_iterations=1),
              "ef": dict(paradigm="ef", use_ct=False, q=1, q_iterations=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("pred", [False, True])
def test_cond_graphs_when_skips_its_body_and_counts_its_runs(cuda, pred):
    """A body under an IF node: skipped (its K1 launch included) where the
    predicate is false, its results where true, and its launches counted
    once per run, settled when LAUNCHES is read."""
    from navc_tpu_torch.runtime import graphs

    g = _gen(31)
    w = _weights(128, 256, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(4, 16, 8, 128, g, cuda)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    base = torch.zeros(4, 16, 128, device=cuda)

    def body(x):
        return (fused_layer(raw, static, kp, ke, ve, w, lns, lnb, n_head=2) + x,)

    graph = graphs.Graph(lambda: graphs.when(flag, body, (base,))[0],
                         torch.cuda.graph_pool_handle())
    assert len(graph.regions) == 1 and graph.launches == {}
    want = fused_layer(raw, static, kp, ke, ve, w, lns, lnb, n_head=2)
    for p in (pred, not pred, pred):
        flag.fill_(p)
        _build.reset_launches()
        out = graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want if p else base)
        assert _build.LAUNCHES["fused_layer"] == int(p)
    # outside a capture: the body runs and merges
    eager = graphs.when(flag, body, (base,))[0]
    assert torch.equal(eager, want if pred else base)


def _cond_encs(cfg, model, teacher, videos):
    reqs = [_request_on(cfg, videos, seed) for seed in (41, 42)]
    with torch.no_grad():
        return [(model.encode(f), c, teacher.encode(f)) for f, c in reqs]


def _nonzero_launches():
    return {k: v for k, v in _build.LAUNCHES.items() if v}


@pytest.mark.cuda
def test_cond_graphs_capture_whatever_stream_the_pool_hands_out(cuda):
    """PyTorch's pool hands its 32 streams out round robin, so a body
    capture on a stream taken from it begins, once in a while, on the very
    stream the graph captures on, and fails (CUDA error 401 at cond_begin).
    40 graphs with an IF node, the pool advanced by a stream between each:
    each captures and replays."""
    from navc_tpu_torch.runtime import graphs

    x = torch.ones(4, device=cuda)
    for _ in range(40):
        torch.cuda.Stream()
        f = graphs.Jitted(lambda t: graphs.when(t.sum() > 0, lambda u: (u + 1,), (t,))[0])
        assert torch.equal(f(x), x + 1) and torch.equal(f(x), x + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("videos", [16, 64])
@pytest.mark.parametrize("case", list(COND_CASES))
def test_cond_graphs_l2r_ef_replay_eager_tokens_and_launches(cuda, case, videos):
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, _, teacher = _serving_models("cuda", **COND_CASES[case])
    eager = make_nar_generator(cfg, model, teacher, jit=False)
    replay = make_nar_generator(cfg, model, teacher)
    assert replay.graphed and not eager.graphed
    encs = _cond_encs(cfg, model, teacher, videos)
    want, per_decode = [], []
    for e in encs:
        _build.reset_launches()
        want.append(eager(*e))
        per_decode.append(_nonzero_launches())
    got = [replay(*encs[0])]  # warm-up and capture
    for e in (encs[1], encs[0]):
        _build.reset_launches()
        got.append(replay(*e))
        assert _nonzero_launches() == per_decode[len(got) % 2], case
    for out, ref in zip(got, [want[0], want[1], want[0]]):
        assert torch.equal(out, ref), case
    assert not torch.equal(want[0], want[1])
    if case != "l2r-ct":  # random weights leave nothing masked after CT
        assert per_decode[0]["fused_layer"] > 3


@pytest.mark.cuda
def test_cond_graphs_l2r_replay_never_syncs(cuda):
    """Between the arguments' copy and the tokens' clone a replayed l2r
    decode reads nothing on the host: no sync in torch's debug mode, no
    event waited for."""
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, _, teacher = _serving_models("cuda", **COND_CASES["l2r"])
    gen = make_nar_generator(cfg, model, teacher)
    encs = _cond_encs(cfg, model, teacher, 16)
    want = gen(*encs[0])
    waits = []
    orig = torch.cuda.Event.synchronize
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda.Event.synchronize = lambda self: (waits.append(1), orig(self))[1]
        got = gen(*encs[0])
    finally:
        torch.cuda.Event.synchronize = orig
        torch.cuda.set_sync_debug_mode("default")
    assert waits == [] and torch.equal(got, want)


@pytest.mark.cuda
def test_cond_graphs_ef_reads_each_block_flag_one_block_late(cuda):
    """A replayed ef decode waits only for its blocks' done flags, once
    per block, each after the next block was queued."""
    from navc_tpu_torch.decoding import make_nar_generator
    from navc_tpu_torch.runtime import graphs

    cfg, model, _, teacher = _serving_models("cuda", **COND_CASES["ef"])
    gen = make_nar_generator(cfg, model, teacher)
    encs = _cond_encs(cfg, model, teacher, 16)
    want = gen(*encs[0])
    (captured,) = gen.graphs.values()
    log = []
    orig_sync, orig_replay = torch.cuda.Event.synchronize, graphs.Graph.replay

    def replay(self):
        log.append("block" if self in captured.blocks else "graph")
        return orig_replay(self)
    blocks0, reads0 = gen.blocks_run, gen.flag_reads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda.Event.synchronize = lambda self: (log.append("wait"), orig_sync(self))[1]
        graphs.Graph.replay = replay
        got = gen(*encs[0])
    finally:
        torch.cuda.Event.synchronize, graphs.Graph.replay = orig_sync, orig_replay
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    blocks, reads = gen.blocks_run - blocks0, gen.flag_reads - reads0
    assert log.count("block") == blocks and log.count("wait") == reads == blocks - 1
    assert blocks >= 3 and int(gen.rounds) > 4
    for i, at in enumerate(j for j, x in enumerate(log) if x == "wait"):
        assert log[:at].count("block") == i + 2  # flag i read after block i + 1 queued
    assert log[0] == log[-1] == "graph"  # the head and the tail


@pytest.mark.cuda
def test_cond_graphs_ef_stops_on_a_stall_like_eager(cuda):
    """A student whose projection puts <mask> first everywhere: every
    revealed slot comes back <mask>, so the batch's count stalls after one
    round and navc_tpu's loop condition stops there; the replay stops at
    the same round, within the first block."""
    from navc_tpu_torch import constants as C
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, _, teacher = _serving_models("cuda", tie_weights=True, **COND_CASES["ef"])
    with torch.no_grad():
        model.tgt_word_prj_bias[C.MASK] = 1e4
    eager = make_nar_generator(cfg, model, teacher, jit=False)
    replay = make_nar_generator(cfg, model, teacher)
    encs = _cond_encs(cfg, model, teacher, 16)
    want = [eager(*e) for e in encs]
    assert eager.rounds == 1 and (want[0] == C.MASK).any()
    got = [replay(*e) for e in encs + encs]
    for out, ref in zip(got, want + want):
        assert torch.equal(out, ref)
    assert int(replay.rounds) == 1 and replay.blocks_run == 4 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("videos", [16, 64])
def test_cond_graphs_full_prefix_beam_launches_k1_per_step(cuda, videos, monkeypatch):
    from navc_tpu_torch.decoding import make_ar_generator

    _, _, cfg, model = _serving_models("cuda")
    monkeypatch.setenv("NAVC_NO_KVCACHE", "1")
    eager = make_ar_generator(cfg, model, jit=False)
    replay = make_ar_generator(cfg, model)
    monkeypatch.delenv("NAVC_NO_KVCACHE")
    reqs = [_request_on(cfg, videos, seed) for seed in (43, 44)]
    with torch.no_grad():
        encs = [(model.encode(f), c) for f, c in reqs]
    want = []
    for e in encs:
        steps0 = eager.steps_run
        _build.reset_launches()
        want.append(eager(*e))
        assert _nonzero_launches() == {"fused_layer": eager.steps_run - steps0}
    got = [replay(*encs[0])]
    for e in (encs[1], encs[0]):
        steps0 = replay.steps_run
        _build.reset_launches()
        got.append(replay(*e))
        steps = replay.steps_run - steps0
        assert steps > 0 and _nonzero_launches() == {"fused_layer": steps}
    for out, ref in zip(got, [want[0], want[1], want[0]]):
        assert _same(out, ref)
    assert not _same(want[0], want[1])
    if videos == 16:  # the CPU plain path: the same route, K1's plain version
        from navc_tpu_torch.decoding.beam import prefix_hidden, prefix_static
        from navc_tpu_torch.decoding.operands import KernelOperands

        _, _, _, cpu_model = _serving_models("cpu")
        ops = KernelOperands.of(cpu_model)

        def k1_plain_decode(seqs, enc_tiled, cat_tiled, mode):
            static = prefix_static(ops, seqs.shape[0], seqs.shape[1], cat_tiled)
            return prefix_hidden(ops, seqs, static, *ops.cross_kv(enc_tiled, 1)), None
        monkeypatch.setattr(cpu_model, "decode", k1_plain_decode, raising=False)
        monkeypatch.setenv("NAVC_NO_KVCACHE", "1")
        cpu_gen = make_ar_generator(cfg, cpu_model)
        enc, cat = encs[0]
        cpu_hyp = cpu_gen({k: v.cpu() for k, v in enc.items()}, cat.cpu())[0]
        agree = float((cpu_hyp == want[0][0].cpu()).float().mean())
        assert agree >= 0.99, "token agreement %.4f" % agree


# -- the compiled training step (make_train_step(..., jit=True)) ---------------
# The NACF step at the serving width (MSRVTT, d=512, vocab 10048, bf16, the
# fused layer K11/K12 and the fused CE K9/K10) at B=64 with its dropout on
# (hidden and encoder 0.5), replayed as a CUDA graph, against the eager
# route (jit=False) from the same weights (the same init seed), batches and
# CPU generator state: metrics, every gradient, every parameter and
# BatchNorm statistic, and the optimizer's state bit for bit the same.

TRAIN_B = 64


def _train_batch(cfg, b, seed):
    """A synthetic NACF batch (chip_smoke.py's ``train_batch``)."""
    from navc_tpu_torch import constants as C

    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, cfg.max_len - 1, size=b)
    tokens = np.full((b, cfg.max_len), C.PAD, np.int32)
    labels = np.full((b, cfg.max_len), C.PAD, np.int32)
    for i in range(b):
        n = lengths[i]
        tokens[i, :n] = rng.randint(6, cfg.vocab_size, size=n)
        tokens[i, :n // 2] = C.MASK
        labels[i, :n // 2] = rng.randint(6, cfg.vocab_size, size=n // 2)
    lt = rng.rand(b, cfg.max_len).astype(np.float32)
    lt /= lt.sum(-1, keepdims=True)
    batch = {
        "tokens": tokens, "labels": labels,
        "tokens_1": np.full((b, cfg.max_len), C.VIS, np.int32),
        "labels_1": np.where(rng.rand(b, cfg.max_len) < 0.3, C.MASK, labels).astype(np.int32),
        "length_target": lt,
        "category": rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32),
        "valid_mask": np.ones(b, np.float32),
    }
    for ch in cfg.modality.lower():
        batch["feats_%s" % ch] = rng.randn(
            b, cfg.n_frames, getattr(cfg, "dim_%s" % ch)).astype(np.float32)
    return batch


def _trainer(jit, method="NACF", **kw):
    """(cfg, model, optimizer, step) of ``method``'s step at the serving
    width, weights from seed 0."""
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    cfg = default_config(method, batch_size=TRAIN_B, **SERVE).replace(**kw)
    model = build_model(cfg, device="cuda", generator=_gen(0), train=True)
    state = create_train_state(cfg, model)
    return cfg, model, state.optimizer, make_train_step(cfg, model, state.optimizer, jit=jit)


def _train_state(model, opt):
    """Every gradient, parameter and buffer, and the optimizer's state, as
    {name: tensor} copies."""
    out = {"grad " + k: p.grad.clone() for k, p in model.named_parameters()}
    out.update({k: t.clone() for k, t in model.state_dict().items()})
    for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        out.update({"opt %d %s" % (i, k): v.clone() for k, v in opt.state[p].items()})
    return out


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), "%s: %s differs" % (what, k)


def _replay_matches_eager(method):
    """6 steps of ``method`` (the first the warm-up and capture, then 5
    replays) under a warm-up lr schedule, the batches in turns: each step's
    metrics, gradients, parameters, BatchNorm statistics and optimizer state
    equal the eager step's bit for bit, and each replay launches what an
    eager step does: each decoder pass's K11 and K10 once."""
    from navc_tpu_torch.runtime.optim import LrSchedule, set_learning_rate

    sides = {jit: _trainer(jit, method, n_warmup_steps=3) for jit in (False, True)}
    cfg = sides[True][0]
    passes = 2 if cfg.visual_word_generation else 1
    assert cfg.hidden_dropout_prob > 0 and cfg.encoder_dropout > 0
    batches = [_train_batch(cfg, TRAIN_B, s) for s in range(3)]
    gens = {jit: _gen(7) for jit in sides}
    scheds = {jit: LrSchedule.from_config(c) for jit, (c, *_) in sides.items()}
    for i in range(6):
        got = {}
        for jit, (_, model, opt, step) in sides.items():
            set_learning_rate(opt, scheds[jit].step_lr())
            _build.reset_launches()
            metrics = step(batches[i % 3], gens[jit])
            got[jit] = ({k: v.clone() for k, v in metrics.items()},
                        {k: v for k, v in _build.LAUNCHES.items() if v},
                        _train_state(model, opt))
        _assert_same(got[True][0], got[False][0], "metrics, step %d" % i)
        assert got[True][1] == got[False][1], (i, got[True][1], got[False][1])
        assert got[True][1]["train_fwd"] == passes and got[True][1]["ce_bwd_dw"] == passes
        _assert_same(got[True][2], got[False][2], "state, step %d" % i)
    step = sides[True][3]
    assert step.jitted is not None and len(step.jitted.graphs) == 1
    assert sides[False][3].jitted is None


@pytest.mark.cuda
def test_train_graphs_replay_matches_eager(cuda):
    """The NACF step (its visual-word and main passes): ``_replay_matches_eager``."""
    _replay_matches_eager("NACF")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ARB2", "NAB"])
def test_train_graphs_method_replay_matches_eager(cuda, method):
    """ARB2's step at B=64 (two causal decoder passes in one graph, each with
    its own device seed and labels: K11, K12a, K12b, K9 and K10 twice) and
    NAB's (one NAR pass), replayed bit for bit the eager step
    (``_replay_matches_eager``)."""
    _replay_matches_eager(method)


@pytest.mark.cuda
def test_train_graphs_draw_fresh_masks_per_replay(cuda):
    """At lr 0 (the weights stay) on one batch: two replays give different
    losses; a replay from a CPU generator state gives the loss of an eager
    step made afresh (a new device generator) from that state, and the
    same loss when replayed again from it."""
    from navc_tpu_torch.runtime.optim import set_learning_rate
    from navc_tpu_torch.runtime.train_step import make_train_step

    cfg, model, opt, step = _trainer(True)
    _, emodel, eopt, _ = _trainer(False)
    for o in (opt, eopt):
        set_learning_rate(o, 0.0)
    batch = _train_batch(cfg, TRAIN_B, 1)
    gen = _gen(9)
    step(batch, gen)  # the warm-up and capture
    losses, states = [], []
    for _ in range(3):
        states.append(gen.get_state())
        losses.append(float(step(batch, gen)["total_loss"]))
    assert len(set(losses)) == 3, losses
    for state, loss in zip(states, losses):
        eager = make_train_step(cfg, emodel, eopt, jit=False)
        want = float(eager(batch, torch.Generator().set_state(state))["total_loss"])
        assert loss == want, (loss, want)
        again = float(step(batch, torch.Generator().set_state(state))["total_loss"])
        assert again == loss, (again, loss)


@pytest.mark.cuda
def test_train_graphs_follow_the_lr(cuda):
    """The replayed step reads the lr tensor that set_learning_rate fills:
    at lr 0 a replay leaves every parameter as it was; through a warm-up
    and a decay of the schedule the parameters equal the eager step's."""
    from navc_tpu_torch.runtime.optim import LrSchedule, set_learning_rate

    sides = {jit: _trainer(jit, n_warmup_steps=2, decay=0.5) for jit in (False, True)}
    cfg, model, opt, step = sides[True]
    lr_t = opt.param_groups[0]["lr"]
    assert torch.is_tensor(lr_t) and lr_t.device.type == "cuda" and lr_t.dtype == torch.float32
    batch = _train_batch(cfg, TRAIN_B, 2)
    step(batch, _gen(1))  # the warm-up and capture
    set_learning_rate(opt, 0.0)
    before = {k: p.clone() for k, p in model.named_parameters()}
    step(batch, _gen(2))
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
    # both sides from here on: the same weights (the eager side catches up)
    eager_model, eager_opt, eager_step = sides[False][1:]
    with torch.no_grad():
        for q, p in zip(eager_model.parameters(), model.parameters()):
            q.copy_(p)
        for q, p in zip(eager_model.buffers(), model.buffers()):
            q.copy_(p)
    eager_opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # (it would alias)
    scheds = {jit: LrSchedule.from_config(cfg) for jit in sides}
    gens = {jit: _gen(3) for jit in sides}
    for i in range(5):
        for jit, (_, m, o, s) in sides.items():
            set_learning_rate(o, scheds[jit].step_lr())
            s(batch, gens[jit])
            if i == 2:
                scheds[jit].epoch_update()
        _assert_same({k: p for k, p in model.named_parameters()},
                     {k: p for k, p in eager_model.named_parameters()}, "step %d" % i)
    assert opt.param_groups[0]["lr"] is lr_t and len(step.jitted.graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_train_graphs_card_optimizer_matches_the_cpu_float_lr_one(cuda, name):
    """make_optimizer's optimizer on the card (capturable, its lr a float32
    tensor there), its update captured in a CUDA graph after one eager step
    and replayed with the lr that set_learning_rate fills through
    LrSchedule's warm-up and decay, against torch's CPU optimizer with a
    float lr from the same parameters and gradients (clip by value, weight
    decay): the same step counts, and the moments and parameters within
    rtol 1e-6 and atol 1e-6 (a few float32 steps at the parameters'
    magnitude, up to 4: the two updates take their step size, bias
    corrections and eps in another order, so a sum rounds a step apart;
    the clipped gradients and the moments lie within 1), against
    parameter updates of more than 1e-3."""
    from navc_tpu_torch.config import Config
    from navc_tpu_torch.runtime import optim

    cfg = Config(optim=name, learning_rate=1e-2, minimum_learning_rate=1e-4, decay=0.5,
                 n_warmup_steps=3, weight_decay=5e-4, grad_clip=1.0)
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in ((64, 48), (48,), (7,))]
    grads = [[rng.randn(*a.shape).astype(np.float32) * 2 for a in init] for _ in range(8)]
    card = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(cuda)) for a in init]
    host = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = optim.make_optimizer(cfg, card)
    assert opt.param_groups[0]["capturable"] and opt.param_groups[0]["lr"].is_cuda
    ref = (torch.optim.Adam(host, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay) if name == "adam" else
           torch.optim.RMSprop(host, lr=cfg.learning_rate, alpha=0.99, eps=1e-8,
                               weight_decay=cfg.weight_decay))
    for p in card:
        p.grad = torch.zeros_like(p)
    sched = optim.LrSchedule.from_config(cfg)
    graph = None
    for i, gs in enumerate(grads):
        lr = sched.step_lr()
        optim.set_learning_rate(opt, lr)
        ref.param_groups[0]["lr"] = lr
        for p, q, g in zip(card, host, gs):
            p.grad.copy_(torch.from_numpy(g))
            q.grad = torch.from_numpy(g.copy())
        if graph is None:
            optim.step(cfg, opt)  # the eager first step makes the state
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                optim.step(cfg, opt)
        else:
            graph.replay()
        torch.nn.utils.clip_grad_value_(host, cfg.grad_clip)
        ref.step()
        if i == 4:
            sched.epoch_update()
    torch.cuda.synchronize()
    assert sched.learning_rate == cfg.learning_rate / 2
    for p, q, p0 in zip(card, host, init):
        got, want = opt.state[p], ref.state[q]
        assert set(got) == set(want) and len(got) >= 2
        for k in want:
            if k == "step":
                assert float(got[k]) == float(want[k]) == len(grads)
            else:
                np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=k)
        got, want = p.detach().cpu().numpy(), q.detach().numpy()
        assert np.abs(want - p0).max() > 1e-3  # the updates are far above the tolerance
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_train_graphs_dropped_after_an_optimizer_reload(cuda):
    """load_state_dict replaces the optimizer's state tensors, which a
    captured step reads by address: the step drops its graphs and captures
    anew, and a run that reloads an earlier state continues as the eager
    route's does (parameters and optimizer state bit for bit)."""
    sides = {jit: _trainer(jit) for jit in (False, True)}
    cfg = sides[True][0]
    batches = [_train_batch(cfg, TRAIN_B, s) for s in range(2)]
    gens = {jit: _gen(4) for jit in sides}
    saved = {}
    for i in range(5):
        if i == 3:
            for jit, (_, _, opt, step) in sides.items():
                opt.load_state_dict(saved[jit])
            assert not sides[True][3].jitted.graphs
            assert torch.is_tensor(sides[True][2].param_groups[0]["lr"])
        for jit, (_, _, _, step) in sides.items():
            step(batches[i % 2], gens[jit])
        if i == 0:
            saved = {jit: copy.deepcopy(opt.state_dict())
                     for jit, (_, _, opt, _) in sides.items()}
        _assert_same(_train_state(*sides[True][1:3]), _train_state(*sides[False][1:3]),
                     "step %d" % i)
    assert len(sides[True][3].jitted.graphs) == 1


@pytest.mark.cuda
def test_train_graphs_step_takes_a_batch_on_the_card(cuda):
    """A batch of tensors already on the card (copied there into the
    graph's inputs) gives the replayed step, over 3 steps, the metrics and
    state the same batch as numpy arrays gives."""
    sides = {on_card: _trainer(True) for on_card in (False, True)}
    cfg = sides[True][0]
    batches = [_train_batch(cfg, TRAIN_B, s) for s in range(2)]
    gens = {on_card: _gen(6) for on_card in sides}
    for i in range(3):
        got = {}
        for on_card, (_, model, opt, step) in sides.items():
            b = batches[i % 2]
            if on_card:
                b = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
            got[on_card] = ({k: v.clone() for k, v in step(b, gens[on_card]).items()},
                            _train_state(model, opt))
        _assert_same(got[True][0], got[False][0], "metrics, step %d" % i)
        _assert_same(got[True][1], got[False][1], "state, step %d" % i)
    assert len(sides[True][3].jitted.graphs) == 1


@pytest.mark.cuda
def test_train_graphs_eval_loss_step_replays_eager(cuda):
    from navc_tpu_torch.runtime.train_step import make_eval_loss_step

    cfg, model, _, _ = _trainer(True)
    eager, replay = (make_eval_loss_step(cfg, model, jit=jit) for jit in (False, True))
    batches = [_train_batch(cfg, TRAIN_B, s) for s in range(2)]
    got = [replay(b) for b in batches + batches]
    assert len(replay.jitted.graphs) == 1
    for g, b in zip(got, batches + batches):
        _assert_same(g, eager(b), "eval metrics")


@pytest.mark.cuda
def test_train_graphs_eager_step_never_syncs(cuda):
    """One eager step on the card (after the first, which makes the
    optimizer's state) under torch's sync debug mode "error": nothing in
    the step waits for the card, which a capture needs."""
    cfg, _, _, step = _trainer(False)
    batch = _train_batch(cfg, TRAIN_B, 0)
    gen = _gen(5)
    step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [TRAIN_CASES[0], TRAIN_CASES[1]],
                         ids=lambda c: "x".join(map(str, c)))
def test_train_kernels_take_a_device_seed(cuda, case):
    """K11, K12a and K12b with the seed a (1,) int32 on the card, navc_tpu's
    seed operand: within the tolerances of their plain versions (which read
    it), bit for bit what an int seed gives, and, captured in a graph, the
    masks of the value the seed holds at each replay."""
    from navc_tpu_torch.ops import fused_layer_train as FT

    seed = torch.tensor([2 ** 31 - 17], dtype=torch.int32, device=cuda)
    _check_train_kernels(cuda, case, seed=seed)
    h, inter, n, l, le, causal, p = case
    x, enc, kp, w = _train_inputs(h, inter, n, l, le, _gen(3), cuda)
    dy = torch.randn(n, l, h, generator=_gen(4)).to(cuda)
    kw = dict(n_head=8, causal=causal, p=p, p_input=p)

    def run(s):
        out, r2 = FT.train_fwd(x, enc, kp, w, s, **kw)
        dr2, fp = FT.ffn_bwd_operands(r2, dy, kp, w, s, p=p)
        dx, denc, ap = FT.attn_bwd_operands(x, enc, dr2, kp, w, s, **kw)
        return [out, r2, dr2, dx, denc] + [t for pr in fp + ap for t in (pr.P, pr.Q, pr.part)]

    want = {v: run(v) for v in (11, -3)}
    assert all(torch.equal(a, b) for a, b in zip(run(torch.full_like(seed, 11)), want[11]))
    seed.fill_(11)
    graph = torch.cuda.CUDAGraph()
    run(seed)  # the one-time host calls before the capture
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        outs = run(seed)
    for v in (-3, 11):
        seed.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want[v])), v



# ---------------------------------------------------------------------------
# navc_tpu's route switches, SelfMask and cfg.remat on the card
# ---------------------------------------------------------------------------

ROUTE_SWITCHES = ("NAVC_DENSE_REFINE", "NAVC_NO_ATTEND_KERNEL", "NAVC_NO_PERMUTE_KERNEL",
                  "NAVC_NO_TOPK_KERNEL", "NAVC_NO_FUSED_TRAIN", "NAVC_NO_FUSED_CE")


def _switches(monkeypatch, *on):
    for name in ROUTE_SWITCHES:
        if name in on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)


def _replayed_launches(run):
    """The launches of one replayed call of ``run`` (after its capture) and
    its output."""
    run()
    torch.cuda.synchronize()
    _build.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return {k: n for k, n in _build.LAUNCHES.items() if n}, out


@pytest.mark.cuda
@pytest.mark.parametrize("on", [(), ("NAVC_DENSE_REFINE",)], ids=["default", "dense_refine"])
def test_switch_dense_refine_launches(cuda, on, monkeypatch):
    """NACF mp + CT at 16 videos, replayed: NAVC_DENSE_REFINE takes K2's
    refinements onto K1 (K1 7, K2 0); tokens >= 0.99 the sparse route's."""
    from navc_tpu_torch.decoding import make_nar_generator

    cfg, model, tcfg, teacher = _serving_models("cuda")
    feats, cat = _request_on(cfg, 16, 3)
    with torch.no_grad():
        enc, tenc = model.encode(feats), teacher.encode(feats)
    _switches(monkeypatch)
    sparse = make_nar_generator(cfg, model, teacher)(enc, cat, tenc)
    _switches(monkeypatch, *on)
    gen = make_nar_generator(cfg, model, teacher)
    launches, hyp = _replayed_launches(lambda: gen(enc, cat, tenc))
    want = {"fused_layer": 7, "project_argmax": 6, "project_gather_prob": 1} if on else \
        {"fused_layer": 3, "fused_layer_qsub": 4, "project_argmax": 6, "project_gather_prob": 1}
    assert launches == want, launches
    agree = float((hyp == sparse).float().mean())
    assert agree >= 0.99, agree


@pytest.mark.cuda
@pytest.mark.parametrize("videos", [16, 20])
@pytest.mark.parametrize("on", [(), ("NAVC_NO_ATTEND_KERNEL",),
                                ("NAVC_NO_ATTEND_KERNEL", "NAVC_NO_PERMUTE_KERNEL"),
                                ("NAVC_NO_PERMUTE_KERNEL",), ("NAVC_NO_TOPK_KERNEL",),
                                ("NAVC_NO_ATTEND_KERNEL", "NAVC_NO_PERMUTE_KERNEL",
                                 "NAVC_NO_TOPK_KERNEL")],
                         ids=["default", "no_attend", "no_attend+permute", "no_permute",
                              "no_topk", "all"])
def test_switch_beam_launches(cuda, on, videos, monkeypatch):
    """ARB beam at full width, replayed: each kernel launches once a beam
    step on its route and never off it (K6 and K7 need 16 | videos); the
    replay gives the eager decode's tokens and scores bit for bit under the
    same switches. (Against the CPU these random-weight beams agree
    0.946-0.981 on these requests on the default route too: they turn on
    bf16 rounding points, ROADMAP Queue C; chip_smoke.py gates the CPU
    agreement on its requests.)"""
    from navc_tpu_torch.decoding import make_ar_generator
    from navc_tpu_torch.decoding.beam import Routes

    _switches(monkeypatch, *on)
    _, _, cfg, model = _serving_models("cuda")
    feats, cat = _request_on(cfg, videos, 4)
    with torch.no_grad():
        enc = model.encode(feats)
    eager = make_ar_generator(cfg, model, jit=False)(enc, cat)
    gen = make_ar_generator(cfg, model)
    steps0 = gen.steps_run
    launches, (hyp, scores) = _replayed_launches(lambda: gen(enc, cat))
    steps = (gen.steps_run - steps0) // 2
    attend = videos % 16 == 0 and "NAVC_NO_ATTEND_KERNEL" not in on
    want = Routes(topk="NAVC_NO_TOPK_KERNEL" not in on, cross=attend, attend=attend,
                  permute=not attend and "NAVC_NO_PERMUTE_KERNEL" not in on)
    assert gen.routes == want
    names = dict(topk="project_topk", cross="cross_attend", attend="beam_attend_step",
                 permute="permute_beam_caches")
    assert launches == {names[k]: steps for k, v in want.__dict__.items() if v}, launches
    assert _same((hyp, scores), eager)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [(), ("NAVC_NO_FUSED_TRAIN",), ("NAVC_NO_FUSED_CE",)],
                         ids=["default", "no_fused_train", "no_fused_ce"])
def test_switch_train_launches(cuda, on, monkeypatch):
    """The NACF step at B=64, replayed bit for bit the eager one: no K11 /
    K12 / reduction / K9 / K10 under NAVC_NO_FUSED_TRAIN, no K9 / K10 under
    NAVC_NO_FUSED_CE, each decoder pass's launches otherwise."""
    from navc_tpu_torch.runtime.train_step import TrainRoutes

    _switches(monkeypatch, *on)
    sides = {jit: _trainer(jit) for jit in (False, True)}
    cfg = sides[True][0]
    batches = [_train_batch(cfg, TRAIN_B, s) for s in range(2)]
    gens = {jit: _gen(3) for jit in sides}
    for i in range(3):
        got = {}
        for jit, (_, model, opt, step) in sides.items():
            _build.reset_launches()
            metrics = step(batches[i % 2], gens[jit])
            got[jit] = ({k: v.clone() for k, v in metrics.items()},
                        {k: v for k, v in _build.LAUNCHES.items() if v},
                        _train_state(model, opt))
        _assert_same(got[True][0], got[False][0], "metrics, step %d" % i)
        _assert_same(got[True][2], got[False][2], "state, step %d" % i)
        assert got[True][1] == got[False][1]
    routes = sides[True][3].routes
    assert routes == TrainRoutes(layer="NAVC_NO_FUSED_TRAIN" not in on, ce=not on)
    layer = {"train_fwd": 2, "train_ffn_bwd": 2, "train_attn_bwd": 2, "train_wgrad": 4}
    ce = {"ce_fwd": 2, "ce_bwd_dh": 2, "ce_bwd_dw": 2}
    assert got[True][1] == ({} if routes == TrainRoutes() else
                            dict(layer, **(ce if routes.ce else {})))


@pytest.mark.cuda
def test_selfmask_beam_replays_eager_through_k5_k7(cuda):
    """A SelfMask ARB model (parallel_mlm) decodes through the cached beam:
    K5, K6 and K7 once a step, replayed bit for bit the eager decode (the
    CPU agreement is chip_smoke.py's, on its requests)."""
    from navc_tpu_torch.decoding import make_ar_generator

    over = dict(decoding_type="SelfMask", parallel_mlm=True)
    _, _, cfg, model = _serving_models("cuda")
    cfg = cfg.replace(**over)
    feats, cat = _request_on(cfg, 16, 6)
    with torch.no_grad():
        enc = model.encode(feats)
    eager = make_ar_generator(cfg, model, jit=False)(enc, cat)[0]
    gen = make_ar_generator(cfg, model)
    steps0 = gen.steps_run
    launches, (hyp, _) = _replayed_launches(lambda: gen(enc, cat))
    steps = (gen.steps_run - steps0) // 2
    assert torch.equal(hyp, eager)
    assert launches == dict(project_topk=steps, beam_attend_step=steps, cross_attend=steps)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [(), ("NAVC_NO_FUSED_TRAIN",)], ids=["fused", "modules"])
def test_remat_is_bit_exact_on_the_card(cuda, on, monkeypatch):
    """The NACF step at B=64, dropout 0.5: remat on, eager and replayed,
    gives remat off's eager losses, gradients and state bit for bit over 3
    steps; on the fused route K11 and K9 launch twice a decoder pass."""
    _switches(monkeypatch, *on)
    runs = {}
    for remat in (False, True):
        for jit in (False, True):
            cfg, model, opt, step = _trainer(jit, remat=remat)
            gen = _gen(5)
            batches = [_train_batch(cfg, TRAIN_B, s) for s in range(2)]
            out = []
            for i in range(3):
                _build.reset_launches()
                metrics = step(batches[i % 2], gen)
                out.append(({k: v.clone() for k, v in metrics.items()},
                            {k: v for k, v in _build.LAUNCHES.items() if v},
                            _train_state(model, opt)))
            runs[remat, jit] = out
    ref = runs[False, False]
    for key, out in runs.items():
        for i, (got, want) in enumerate(zip(out, ref)):
            _assert_same(got[0], want[0], "%s metrics, step %d" % (key, i))
            _assert_same(got[2], want[2], "%s state, step %d" % (key, i))
    fused = not on
    for jit in (False, True):
        launches = runs[True, jit][-1][1]
        assert launches.get("train_fwd", 0) == (4 if fused else 0), launches
        assert launches.get("ce_fwd", 0) == (4 if fused else 0), launches
        off = runs[False, jit][-1][1]
        assert {k: n for k, n in launches.items() if k not in ("train_fwd", "ce_fwd")} == \
            {k: n for k, n in off.items() if k not in ("train_fwd", "ce_fwd")}


# ---------------------------------------------------------------------------
# data and tensor parallelism on the card (test_parallel_*): ranks are fresh
# processes of tests/torch_port_dist_worker.py; the feature extractor
# ---------------------------------------------------------------------------

PAR_B = 16
PAR_OVER = dict(SERVE, batch_size=PAR_B, hidden_dropout_prob=0.0, encoder_dropout=0.0)
PAR_GRAD_TOL = 5e-2  # norm-relative, per parameter (chip_smoke.py's p = 0 step gate), of
#                     at least 1e-3 of the largest parameter gradient's norm: an attention
#                     key bias has no gradient but rounding noise (softmax is shift-free)


def _par_batches(cfg, n=2):
    """NACF batches whose second half has features 3x the first's: each
    rank's BatchNorm statistics differ from the global batch's."""
    out = []
    for s in range(n):
        b = _train_batch(cfg, PAR_B, 40 + s)
        for ch in cfg.modality.lower():
            b["feats_%s" % ch][PAR_B // 2:] *= 3.0
        out.append(b)
    return out


def _par_single(cfg, batches):
    """The single-process eager step on the whole batches: (losses, each
    step's gradient as {flax path: array})."""
    import torch_port_dist_worker as worker

    from navc_tpu_torch.models import build_model

    model = build_model(cfg, device="cuda", generator=_gen(0), train=True)
    out = worker.single_steps(cfg, model, batches)
    return ([m["total_loss"] for m in out["metrics"]],
            [dict(worker.leaves(g)) for g in out["grads"]])


def _par_check_steps(outs, cfg, batches):
    """The 'dp' and 'tp' cases of the ranks' ``steps`` suite against the
    single-process step on the whole batches: the ranks' losses and weights
    bit for bit alike; each step's loss within 1e-2, its global gradient
    within PAR_GRAD_TOL parameter by parameter."""
    import torch_port_dist_worker as worker

    losses, grads = _par_single(cfg, batches)
    for name in ("dp", "tp"):
        r0, r1 = (o["steps"][name] for o in outs)
        assert r0["metrics"] == r1["metrics"] and r0["digests"] == r1["digests"], name
        assert len(r0["shards"]) == (5 if name == "tp" else 0)
        for i, (m, want) in enumerate(zip(r0["metrics"], losses)):
            assert abs(m["total_loss"] - want) <= 1e-2 * abs(want), (name, i, m, want)
            got = dict(worker.leaves(r0["grads"][i]))
            floor = 1e-3 * max(np.linalg.norm(ref) for ref in grads[i].values())
            for k, ref in grads[i].items():
                gap = np.linalg.norm(got[k] - ref)
                assert gap <= PAR_GRAD_TOL * max(np.linalg.norm(ref), floor), (name, i, k, gap)


def _par_cases(batches):
    return [dict(name=name, method="NACF", over=PAR_OVER, batches=batches, mesh=mesh)
            for name, mesh in (("dp", None), ("tp", {"data": 1, "model": 2}))]


@pytest.mark.cuda
def test_parallel_two_gloo_ranks_on_the_card_match_one_process(cuda, tmp_path):
    """Two ranks on the card over gloo (NCCL refuses two ranks on one
    device), eager, at serving width (bf16 kernels, dropout 0): data 2, and
    data 1 x model 2, each 2 steps of a 16-video NACF batch. The ranks'
    losses and weights bit for bit alike; each step's loss within 1e-2 of
    the single-process step's on the whole batch, and its global gradient
    (all-reduced; the TP slices' gathered) within PAR_GRAD_TOL of the
    single-process gradient, parameter by parameter (of the norm, or of
    1e-3 of the largest parameter gradient's norm): a gradient not summed
    over the ranks, BatchNorm statistics or loss denominators of one rank's
    rows, or a TP slice's gradient taken from the other rank's part, are
    off by far more."""
    import torch_port_dist_worker as worker

    from navc_tpu_torch.config import default_config

    cfg = default_config("NACF", **PAR_OVER)
    batches = _par_batches(cfg)
    wait = worker.start("steps", 2, dict(device="cuda", backend="gloo",
                                         steps=_par_cases(batches)),
                        str(tmp_path), timeout=600)
    _par_check_steps(wait(), cfg, batches)


@pytest.mark.cuda
def test_parallel_two_nccl_ranks_on_two_cards(cuda, tmp_path):
    """Two ranks on two cards over NCCL, at serving width: the 'dp' and
    'tp' steps as the gloo test holds them (each 'model' and 'data' line a
    communicator of its own); the step captured with its collectives
    (jit=True) on both ranks, bit for bit its eager run and alike on both,
    within 1e-2 of the single-process step on the whole batch, a replay
    launching the single-process replay's kernels and issuing no collective
    from the host; and train_network_all_multihost for one epoch (the step
    captured, the early-stop flag broadcast on the card): one train loss on
    both ranks, rank 0 alone validating and writing best.ckpt."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (NCCL refuses two ranks on one card)")
    import torch_port_dist_worker as worker

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats

    cfg = default_config("NACF", **PAR_OVER)
    batches = _par_batches(cfg, 3)
    loop_cfg = cfg.replace(epochs=1, teacher_path="", load_teacher_weights=False,
                           with_teacher=False)
    corpus, refs = make_synthetic_corpus(loop_cfg, n_videos=48, n_caps=2,
                                         vocab_size=cfg.vocab_size)
    feats = make_synthetic_feats(loop_cfg, n_videos=48, n_total_frames=cfg.n_total_frames)
    outs = worker.start("steps,nccl_step,loop", 2, dict(
        device="cuda", backend="nccl", steps=_par_cases(batches[:2]),
        nccl_step=dict(over=PAR_OVER, batches=batches),
        loop=dict(root=str(tmp_path), corpus=corpus, refs=refs, feats=feats,
                  loops=[("nccl", loop_cfg)])), str(tmp_path / "ranks"), timeout=600)()
    _par_check_steps(outs, cfg, batches[:2])
    r0, r1 = (o["nccl_step"] for o in outs)
    assert r0["backend"] == "nccl" and r0["graphs"] == 1
    assert r0["replayed"] == r0["eager"] == r1["replayed"] == r1["eager"]
    for a, b in zip(r0["replayed"], r0["single"]):
        assert abs(a - b) <= 1e-2 * abs(b), (a, b)
    assert r0["replayed launches"] == r0["single launches"]
    assert r0["replayed host collectives"] == 0 == r0["single host collectives"]
    assert r0["gloo jit"].startswith("ValueError: gloo collectives cannot be captured")
    l0, l1 = (o["loop"]["nccl"] for o in outs)
    assert l0["train_curve"] == l1["train_curve"] and np.isfinite(l0["train_curve"]).all()
    assert (l0["n_eval"], l1["n_eval"]) == (1, 0) and l1["saved"] == []
    assert str(tmp_path / "nccl" / "best.ckpt") in l0["saved"]


PAR_LOSS_TOL, PAR_BN_TOL = 1e-4, 1e-3  # chip_smoke.py's parallel phase: losses relative,
#                                       BatchNorm statistics of their largest magnitude
PAR_TIMED_B = 64  # the global batch the four-rank steps are timed at


def _par_timed_batch(cfg):
    """A global batch of PAR_TIMED_B videos as ``_par_batches`` makes them."""
    b = _train_batch(cfg, PAR_TIMED_B, 60)
    for ch in cfg.modality.lower():
        b["feats_%s" % ch][PAR_TIMED_B // 2:] *= 3.0
    return b


@pytest.mark.cuda
def test_parallel_four_nccl_ranks_data2_model2(cuda, tmp_path):
    """Four ranks on four cards over NCCL at serving width, data 2 x model
    2: two 'data' and two 'model' groups, each an NCCL communicator, both
    kinds in the captured step (the TP gather and the flat gradient's
    all-reduce in one replay). The steps of a 16-video NACF batch against
    the single-process step on the whole batch: losses within
    PAR_LOSS_TOL, each parameter's global gradient within PAR_GRAD_TOL,
    BatchNorm statistics within PAR_BN_TOL; the four ranks' losses and
    weights bit for bit alike, the TP slices alike within a 'data' group
    and not across a 'model' group. The step captured (jit=True): bit for
    bit its eager run on every rank, its weights alike on all four and its
    slices within each 'data' group, a replay launching the single-process
    replay's kernels and issuing no collective from the host.
    train_network_all_multihost on the 2 x 2 mesh for one epoch: one train
    curve on all ranks, rank 0 alone validating and writing best.ckpt, of
    full size. generate_sharded's NAB sweep on the 2 x 2 mesh: the tokens
    one process gives each 'data' coordinate's rows, bit for bit, and >=
    0.99 of the whole batch decoded at once. Then data 4 x model 1, the
    step alone. Printed: ms a step of a rank at global B = PAR_TIMED_B on
    both meshes beside one process's replayed step on the whole batch
    (median of 10 replays each, in turns, host clock)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (one NCCL rank a card)")
    import torch_port_dist_worker as worker

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.convert import export_flax_variables, load_flax_variables
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
    from navc_tpu_torch.decoding import make_nar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.parallel.mesh import Mesh, shard_batch
    from navc_tpu_torch.runtime.checkpoint import load_model_and_config

    mesh = {"data": 2, "model": 2}
    cfg = default_config("NACF", **PAR_OVER)
    batches, timed = _par_batches(cfg, 3), _par_timed_batch(cfg)
    loop_cfg = cfg.replace(epochs=1, teacher_path="", load_teacher_weights=False,
                           with_teacher=False, mesh_shape=mesh)
    corpus, refs = make_synthetic_corpus(loop_cfg, n_videos=48, n_caps=2,
                                         vocab_size=cfg.vocab_size)
    feats = make_synthetic_feats(loop_cfg, n_videos=48, n_total_frames=cfg.n_total_frames)
    ncfg = default_config("NAB", **SERVE)
    nab = build_model(ncfg, device="cpu", generator=_gen(2))
    rng = np.random.RandomState(11)
    sweep_feats = [rng.randn(PAR_B, ncfg.n_frames, d).astype(np.float32)
                   for d in ncfg.modality_dims]
    sweep_cat = rng.randint(0, ncfg.num_category, (PAR_B, 1)).astype(np.int32)
    # the references: the single-process step on the whole batches; the NAB
    # sweep of each 'data' coordinate's rows and of all of them at once
    single = worker.single_steps(cfg, build_model(cfg, device="cuda", generator=_gen(0),
                                                  train=True), batches[:2])
    variables = export_flax_variables(nab)
    nab = load_flax_variables(build_model(ncfg, device="cuda"), variables)
    cat = torch.from_numpy(sweep_cat).cuda()
    with torch.no_grad():
        enc = nab.encode([torch.from_numpy(f).cuda() for f in sweep_feats])
        gen = make_nar_generator(ncfg, nab)
        by_rows = torch.cat([gen(shard_batch(enc, Mesh(2, 1, i)),
                                 shard_batch({"c": cat}, Mesh(2, 1, i))["c"])
                             for i in range(2)]).cpu().numpy()
        whole = gen(enc, cat).cpu().numpy()
    del nab, gen, enc
    outs = worker.start("steps,nccl_step,sweep,loop", 4, dict(
        device="cuda", backend="nccl",
        steps=[dict(name="tp_2x2", method="NACF", over=PAR_OVER, batches=batches[:2],
                    mesh=mesh)],
        nccl_step=dict(over=PAR_OVER, batches=batches, mesh=mesh, timed=timed),
        sweep=[dict(name="nab", method="NAB", over=SERVE, mesh=mesh, variables=variables,
                    feats=sweep_feats, category=sweep_cat)],
        loop=dict(root=str(tmp_path), corpus=corpus, refs=refs, feats=feats,
                  loops=[("nccl_2x2", loop_cfg)])), str(tmp_path / "ranks"), timeout=900)()

    steps = [o["steps"]["tp_2x2"] for o in outs]
    for r in steps[1:]:
        assert r["metrics"] == steps[0]["metrics"] and r["digests"] == steps[0]["digests"]
    assert len(steps[0]["shards"]) == 5
    for j in range(2):  # ranks j and j + 2 hold the same slices, ranks 0 and 1 others
        assert steps[j]["shard_digests"] == steps[j + 2]["shard_digests"]
    assert steps[0]["shard_digests"] != steps[1]["shard_digests"]
    loss_gaps, grad, _, bn = worker.gaps(steps[0], single)
    loss = max(loss_gaps)
    assert loss <= PAR_LOSS_TOL and grad <= PAR_GRAD_TOL and bn <= PAR_BN_TOL, (loss, grad, bn)

    n = [o["nccl_step"] for o in outs]
    assert all(r["backend"] == "nccl" and r["mesh"] == (2, 2) and r["graphs"] == 1 for r in n)
    assert all(r["replayed"] == r["eager"] == n[0]["replayed"] for r in n)
    assert len({r["digest"] for r in n}) == 1
    assert n[0]["slice digest"] == n[2]["slice digest"] != n[1]["slice digest"] == \
        n[3]["slice digest"]
    for a, b in zip(n[0]["replayed"], n[0]["single"]):
        assert abs(a - b) <= PAR_LOSS_TOL * abs(b), (a, b)
    for r in n:
        assert r["replayed launches"] == r["single launches"]
        assert r["replayed host collectives"] == 0 == r["single host collectives"]

    loops = [o["loop"]["nccl_2x2"] for o in outs]
    assert all(lp["train_curve"] == loops[0]["train_curve"] for lp in loops)
    assert np.isfinite(loops[0]["train_curve"]).all()
    assert [lp["n_eval"] for lp in loops] == [1, 0, 0, 0]
    assert all(lp["saved"] == [] for lp in loops[1:])
    best = str(tmp_path / "nccl_2x2" / "best.ckpt")
    assert best in loops[0]["saved"]
    model, _, _ = load_model_and_config(best, device="cpu")
    assert model.tgt_word_prj.weight.shape == (cfg.vocab_size, cfg.dim_hidden)
    assert model.decoder.layers[0].intermediate.dense.weight.shape == \
        (cfg.intermediate_size, cfg.dim_hidden)

    for o in outs:
        tokens = o["sweep"]["nab"]["tokens"]
        np.testing.assert_array_equal(tokens, by_rows)
        assert (tokens == whole).mean() >= 0.99

    d4 = [o["nccl_step"] for o in worker.start("nccl_step", 4, dict(
        device="cuda", backend="nccl", nccl_step=dict(
            over=PAR_OVER, batches=batches, mesh={"data": 4, "model": 1}, timed=timed)),
        str(tmp_path / "data4"), timeout=600)()]
    assert all(r["backend"] == "nccl" and r["mesh"] == (4, 1) and r["graphs"] == 1 for r in d4)
    assert all(r["replayed"] == r["eager"] == d4[0]["replayed"] for r in d4)
    assert len({r["digest"] for r in d4}) == 1
    for a, b in zip(d4[0]["replayed"], d4[0]["single"]):
        assert abs(a - b) <= PAR_LOSS_TOL * abs(b), (a, b)
    for r in d4:
        assert r["replayed launches"] == r["single launches"]
        assert r["replayed host collectives"] == 0
    print("four NCCL ranks on %s: ms a step of a rank at global B=%d (median of 10 replays, "
          "host clock): data 2 x model 2 %s (%d rows a rank), one process replayed %s; data 4 "
          "x model 1 %s (%d rows a rank), one process replayed %s; loss gap %.3e, gradient "
          "gap %.3e, BatchNorm gap %.3e" % (
              torch.cuda.get_device_name(0), PAR_TIMED_B,
              ["%.3f" % r["median ms"]["replayed"] for r in n],
              n[0]["timed rows"]["replayed"], ["%.3f" % r["median ms"]["single"] for r in n],
              ["%.3f" % r["median ms"]["replayed"] for r in d4],
              d4[0]["timed rows"]["replayed"], ["%.3f" % r["median ms"]["single"] for r in d4],
              loss, grad, bn))


@pytest.mark.cuda
def test_parallel_one_nccl_rank_step_is_captured_and_replayed(cuda, tmp_path):
    """One rank on NCCL, serving width: the distributed step captured
    (jit=True; its all-reduces inside the graph) gives its eager run's
    losses bit for bit over 3 steps, within 1e-2 of the single-process
    step's; a replay launches what the single-process replay does and
    issues no collective from the host (an eager step issues them); and
    jit=True on a gloo group raises (gloo collectives cannot be captured)."""
    import torch_port_dist_worker as worker

    from navc_tpu_torch.config import default_config

    cfg = default_config("NACF", **PAR_OVER)
    batches = _par_batches(cfg, 3)
    (out,) = worker.start("nccl_step", 1, dict(
        device="cuda", backend="nccl", nccl_step=dict(over=PAR_OVER, batches=batches)),
        str(tmp_path), timeout=600)()
    got = out["nccl_step"]
    assert got["backend"] == "nccl" and got["graphs"] == 1
    assert got["replayed"] == got["eager"]
    for a, b in zip(got["replayed"], got["single"]):
        assert abs(a - b) <= 1e-2 * abs(b), (a, b)
    assert got["replayed launches"] == got["single launches"] and \
        got["replayed launches"].get("train_fwd") == 2
    assert got["replayed host collectives"] == 0 == got["single host collectives"]
    assert got["gloo jit"].startswith("ValueError: gloo collectives cannot be captured")


@pytest.mark.cuda
def test_resnet_on_the_card_matches_the_cpu(cuda):
    """models/resnet.py's ResNet-50 layout (random init) at 64 x 64 through
    make_backbone on the card (cuDNN, TF32 off) against the CPU forward of
    the same weights: within 1e-3 of the largest feature."""
    import copy

    from navc_tpu_torch.models.resnet import RESNET_STAGES, init_resnet, make_backbone

    torch.backends.cudnn.allow_tf32 = False
    cpu_model = init_resnet(_gen(0), RESNET_STAGES[50])
    frames = np.random.RandomState(0).rand(5, 64, 64, 3).astype(np.float32)
    got = make_backbone(copy.deepcopy(cpu_model), batch_size=2, device="cuda")(frames)
    want = make_backbone(cpu_model, device="cpu")(frames)
    assert got.shape == want.shape == (5, 2048)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


# -- the MLAMoE language model (models/mla_moe.py, decoding/lm_beam.py) ------

TOPK_STREAM_SHAPES = [  # rows, d, V, k: K5's streamed walk (D > 768)
    (2560, 2048, 163840, 5), (130, 1024, 4099, 8), (7, 2048, 1001, 1), (300, 832, 10048, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TOPK_STREAM_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_project_topk_streams_wide_rows(cuda, shape, with_bias):
    """K5 past D = 768, h streamed beside W: the language model's beam step
    (2560 x 2048 x 163,840, three or more 16-bit id splits) and ragged
    shapes, against the plain version: log-probs within ATT_TOL, ids equal
    at every place whose score is clear of both neighbours by 1e-3 (at
    2560 rows of 163,840 a near tie above a place, which float32 sums in
    another order may flip, is no rarity)."""
    r, d, v, k = shape
    hid, w, bias = _vocab_operands(r, d, v, _gen(r + d + v + k + with_bias), cuda,
                                   bias_scale=0.5 if with_bias else None)
    _check_topk_clear(hid, w, k, bias)


def _check_topk_clear(hid, w, k, bias):
    lp, ids = project_topk(hid, w, k, bias)
    lp_p, ids_p = project_topk_plain(hid, w, k, bias)
    scores = hid.float() @ w.float().t() + (0 if bias is None else bias)
    srt = scores.topk(k + 1, dim=-1).values
    gap = torch.cat([torch.full_like(srt[:, :1], math.inf), srt[:, :-1] - srt[:, 1:]], 1)
    clear = (gap[:, :-1] > 1e-3) & (gap[:, 1:] > 1e-3)
    assert clear.float().mean().item() > 0.9
    assert torch.equal(ids[clear], ids_p[clear])
    assert (lp - lp_p).abs().max().item() <= ATT_TOL
    assert bool((lp[:, 1:] <= lp[:, :-1]).all())


@pytest.mark.cuda
def test_project_topk_arb_shape_keeps_its_walk(cuda):
    """At the ARB cell's shape (5120 x 512 x 10048, k 5) K5 keeps its
    resident walk: the same bits in two calls, the plain version's ids where
    a score is clear of both neighbours."""
    hid, w, _ = _vocab_operands(5120, 512, 10048, _gen(77), cuda)
    a = project_topk(hid, w, 5)
    b = project_topk(hid, w, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _check_topk_clear(hid, w, 5, None)


def _lm_config(**extra):
    import json

    from benchmark import lm_program

    with open("benchmark/configs/kimi-vl-a3b-msrvtt.json") as f:
        config = json.load(f)
    config.update(extra)
    return config, lm_program


@pytest.mark.cuda
def test_mla_moe_grouped_experts_match_the_loop(cuda):
    """One MoE layer's routed experts at the published widths (64 experts of
    1408, top 6, 2560 tokens) through the grouped launches against a loop
    over the experts with the same bf16 rounding points: within 2e-2 of
    the output's scale (bf16 products summed in another order)."""
    import torch.nn.functional as F

    from navc_tpu_torch.models.mla_moe import Experts

    g = torch.Generator(device="cuda").manual_seed(5)
    ex = Experts(64, 2048, 1408, torch.bfloat16).to(cuda)
    with torch.no_grad():
        ex.gate_up.uniform_(-2048 ** -0.5, 2048 ** -0.5, generator=g)
        ex.down.uniform_(-1408 ** -0.5, 1408 ** -0.5, generator=g)
        x = torch.randn(2560, 2048, device=cuda, generator=g).to(torch.bfloat16)
        idx = torch.rand(2560, 64, device=cuda, generator=g).topk(6, -1).indices
        wt = torch.rand(2560, 6, device=cuda, generator=g)
        got, counts = ex(x, idx, wt)
        want = torch.zeros(2560, 2048, device=cuda)
        for e in range(64):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            gu = x[tok] @ ex.gate_up[e].t()
            act = F.silu(gu[:, :1408]) * gu[:, 1408:] * wt[tok, slot, None].to(torch.bfloat16)
            want.index_add_(0, tok, (act @ ex.down[e].t()).float())
    assert torch.equal(counts, torch.bincount(idx.reshape(-1), minlength=64).int())
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_mla_moe_captured_decode_at_published_widths(cuda):
    """The captured decode (prefill, 4-step blocks, K5's streamed walk) at
    Kimi-VL-A3B's published widths on 8 videos: each served token's
    log-probability against the plain reference's float32 teacher-forced
    forward within the cell's logprob_err limit, the captured decode's
    tokens bit for bit its first (eager) call's, every token among the
    reference's 5 best within the cell's rank tolerance, and the expert
    counter 6 x the routed tokens of each layer."""
    import json

    from benchmark import lm_check, lm_inputs
    from navc_tpu_torch.decoding import make_ar_generator

    config, lm_program = _lm_config()
    with open("benchmark/workloads/kimi-vl-a3b-msrvtt.beam-512.json") as f:
        check = json.load(f)["check"]
    cfg = lm_program.resolve(config)
    model = lm_program.build(cfg, "cuda")
    weights = lm_inputs.make_weights(config, 2**31 + 9, "cuda", out=model.state_dict())
    gen = make_ar_generator(cfg, model, jit=True)
    assert gen.topk_kernel
    g = torch.Generator(device="cuda").manual_seed(3)
    feats = [torch.randn(8, 8, 2048, device=cuda, generator=g) for _ in range(2)]
    first = gen(model.encode(feats))
    tokens, _, lps, counts = gen(model.encode(feats))
    assert torch.equal(first[0], tokens) and torch.equal(first[2], lps)
    steps = cfg.max_len - 1
    assert counts.sum(1).tolist() == [6 * 8 * (16 + 5 * steps)] * 26
    ref_lp, kth, _ = lm_check.reference_readings(
        config, weights, [f.cpu().numpy() for f in feats], np.arange(8), tokens.cpu().numpy(),
        "cuda")
    mask = lm_check.through_eos(tokens.cpu().numpy())
    err = np.abs(lps.cpu().numpy() - ref_lp)[mask].mean()
    assert err <= check["limits"]["logprob_err"], err
    assert ((ref_lp < kth - check["rank_tolerance"]) & mask).mean() \
        <= check["limits"]["beam_rank_violation"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["expert_dropped", "bias_ignored", "cache_slot_off_by_one"])
def test_mla_moe_faults_fail_the_cells_check(cuda, monkeypatch, fault):
    """Each fault of benchmark/lm_faults.py that the cell's check has to find
    (``CHECKED``), planted in the captured decode at Kimi-VL-A3B's
    published widths, in bfloat16, on 64 videos: the cell's own check (its
    limits, its rank tolerance) against the plain reference's float32
    teacher-forced forward reads above one of its limits. Prints what each
    check reads. (lm_faults' rotary ``position_off_by_one`` moves the
    log-probs by less than bf16 rounding does: the check cannot see it.)"""
    import json

    from benchmark import lm_check, lm_faults, lm_inputs
    from navc_tpu_torch.decoding import make_ar_generator

    assert fault in lm_faults.CHECKED
    lm_faults.FAULTS[fault](monkeypatch.setattr)
    config, lm_program = _lm_config()
    with open("benchmark/workloads/kimi-vl-a3b-msrvtt.beam-512.json") as f:
        check = json.load(f)["check"]
    cfg = lm_program.resolve(config)
    model = lm_program.build(cfg, "cuda")
    weights = lm_inputs.make_weights(config, 2**31 + 9, "cuda", out=model.state_dict())
    gen = make_ar_generator(cfg, model, jit=True)
    g = torch.Generator(device="cuda").manual_seed(13)
    feats = [torch.randn(64, 8, 2048, device=cuda, generator=g) for _ in range(2)]
    tokens, _, lps, _ = gen(model.encode(feats))
    tokens, lps = tokens.cpu().numpy(), lps.cpu().numpy()
    del gen
    ref_lp, kth, _ = lm_check.reference_readings(
        config, weights, [f.cpu().numpy() for f in feats], np.arange(64), tokens, "cuda")
    mask = lm_check.through_eos(tokens)
    got = {"logprob_err": float(np.abs(lps - ref_lp)[mask].mean()),
           "beam_rank_violation": float(((ref_lp < kth - check["rank_tolerance"])
                                         & mask).mean())}
    print("%s: %s (limits %s)" % (fault, json.dumps(got), json.dumps(check["limits"])))
    assert any(got[n] > check["limits"][n] for n in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15360, 1408, True), (2560, 2816, False), (7, 8, True),
                                   (8192, 11264, False)], ids=lambda s: "x".join(map(str, s)))
def test_swiglu_matches_plain(cuda, shape):
    """K13 at the language model's routed, shared and dense widths (and a
    ragged tiny one) against its plain version: the same float32 arithmetic
    (the kernel's exp is the fast one) rounded once, so within one bf16
    rounding."""
    from navc_tpu_torch.ops.swiglu import swiglu, swiglu_plain

    rows, inter, weighted = shape
    g = torch.Generator(device="cuda").manual_seed(rows + inter)
    gu = (torch.randn(rows, 2 * inter, device=cuda, generator=g) * 2).to(torch.bfloat16)
    w = torch.rand(rows, device=cuda, generator=g) * 2.5 if weighted else None
    before = _build.LAUNCHES["swiglu"]
    got = swiglu(gu, w)
    assert _build.LAUNCHES["swiglu"] == before + 1
    want = swiglu_plain(gu, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-5)
