"""Host-side plans of the port's serving kernels, checked without a card.

K6 (``beam_attend_step``) splits each instance's positions [0, tpos] into
runs, a block each, planned in Python by ``attend_runs``; K7
(``cross_attend``) takes a block per instance and group of heads, the group
planned by ``cross_groups``; K1 and K2 (the serving walk of ``fused_layer``
/ ``fused_layer_qsub``) take scratch sized by ``walk_scratch``, walk the
live rows their plan names (``walk_plan`` mirrors the card's) and refuse
operands by ``check_layer``; K11 and K1u (``train_fwd``,
``fused_layer_unfolded``) take the forward's scratch sized by
``fwd_scratch``. The kernels run
only on the card (tests/test_torch_port_cuda.py); what they are handed is
decided here, in plain Python that the CPU reaches.
"""

import math

import numpy as np
import pytest
import torch

from navc_tpu_torch.ops.beam_attend import (RUN_MAX, STAGE_BYTES, STAGE_MAX,
                                            attend_runs, cross_group_ok,
                                            cross_groups, cross_stage_bytes,
                                            stage_bytes)
from navc_tpu_torch.ops.fused_layer import (LayerWeights, check_layer,
                                            fused_layer_plain,
                                            fused_layer_qsub_plain, walk_plan,
                                            walk_scratch)
from navc_tpu_torch.ops import fused_layer as fused_layer_module
from navc_tpu_torch.ops.fused_layer_train import fwd_scratch

TPOS = (0, 1, 2, 14, 15, 28, 29, 31, 63)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 16, 60, 64, 1024, 4096])
def test_attend_run_plan_covers_each_position_once(b, itemsize):
    """Every position of [0, tpos] lies in exactly one run, no run is empty
    or longer than RUN_MAX (a lane each) or than its stage allows, and the
    b * runs blocks give every SM one where there are positions enough."""
    for k in (1, 5, 8, 32):
        for h, nh in ((128, 2), (128, 8), (512, 8), (512, 32), (1024, 16)):
            for sms in (8, 114, 132):
                for tpos in TPOS:
                    if stage_bytes(k, h, nh, itemsize, 1) > STAGE_MAX:  # refused
                        with pytest.raises(ValueError):
                            attend_runs(b, k, tpos, h, nh, itemsize, sms)
                        continue
                    run, runs = attend_runs(b, k, tpos, h, nh, itemsize, sms)
                    ranges = [(s * run, min((s + 1) * run, tpos + 1)) for s in range(runs)]
                    covered = [p for lo, hi in ranges for p in range(lo, hi)]
                    assert covered == list(range(tpos + 1)), (b, k, tpos, h, sms)
                    assert all(lo < hi for lo, hi in ranges)
                    assert 1 <= run <= RUN_MAX
                    assert stage_bytes(k, h, nh, itemsize, run) <= STAGE_MAX
                    if stage_bytes(k, h, nh, itemsize, 1) <= STAGE_BYTES:
                        assert stage_bytes(k, h, nh, itemsize, run) <= STAGE_BYTES
                    assert b * runs >= min(sms, b * (tpos + 1))


def test_attend_run_plan_at_the_serving_shapes():
    """The ARB decode's shapes (beam 5, H 512, 8 heads, bf16, 132 SMs): at
    64 videos and tpos 14 five runs of 3 (320 blocks, about two an SM); at
    B=1024 three runs of 5 (each 52 KB of stage: four blocks an SM), at
    tpos 13 the last of them 4 long (5 does not divide 14); a first step is
    one run."""
    assert attend_runs(64, 5, 14, 512, 8, 2, 132) == (3, 5)
    assert attend_runs(1024, 5, 14, 512, 8, 2, 132) == (5, 3)
    assert attend_runs(1024, 5, 13, 512, 8, 2, 132) == (5, 3)
    assert attend_runs(1024, 5, 0, 512, 8, 2, 132) == (1, 1)
    assert attend_runs(64, 5, 29, 512, 8, 2, 132) == (6, 5)
    assert stage_bytes(5, 512, 8, 2, 5) == 2 * 5 * 5 * 1040 + 5 * 8 * 28


def test_attend_run_plan_refuses_a_position_beyond_the_stage():
    with pytest.raises(ValueError, match="stage"):
        attend_runs(16, 32, 3, 4096, 64, 4, 132)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 3, 16, 60, 64, 1024, 4096])
def test_cross_group_plan_covers_each_head_once(b, itemsize):
    """K7's head group g divides the heads, so the nh / g blocks of an
    instance cover each head exactly once; a group's slice of a position is
    whole 16-byte vectors; its stage fits STAGE_MAX; and the grid gives
    every SM a block whenever one head a block would, at beam 1 to 32, 2 to
    16 heads, Te 1 to 32."""
    for k in (1, 5, 32):
        for h, nh in ((128, 2), (256, 4), (512, 8), (512, 16), (1024, 16)):
            dh = h // nh
            for te in (1, 13, 16, 32):
                for sms in (8, 132):
                    g, _ = cross_groups(b, k, te, h, nh, itemsize, sms)
                    case = (b, k, h, nh, te, sms)
                    assert nh % g == 0, case
                    assert g * dh * itemsize % 16 == 0, case
                    assert cross_stage_bytes(k, te, h, nh, itemsize, g) <= STAGE_MAX, case
                    if b * nh >= sms and cross_group_ok(1, k, te, h, nh, itemsize):
                        assert b * (nh // g) >= sms, case


@pytest.mark.parametrize("b,k,te,h,nh,itemsize,sms,plan", [
    (16, 5, 16, 512, 8, 2, 132, (1, False)),    # 128 blocks even at one head
    (33, 5, 16, 512, 8, 2, 132, (2, False)),
    (64, 5, 16, 512, 8, 2, 132, (2, False)),    # the 64-video request
    (66, 5, 16, 512, 8, 2, 132, (4, False)),
    (128, 5, 16, 512, 8, 2, 132, (4, False)),
    (132, 5, 16, 512, 8, 2, 132, (8, True)),    # 512 columns: 256 pairs fill a block
    (256, 5, 16, 512, 8, 2, 132, (8, True)),
    (1024, 5, 16, 512, 8, 2, 132, (8, True)),   # the B=1024 decode
    (1024, 1, 16, 512, 8, 4, 132, (8, True)),
    (64, 5, 16, 256, 4, 2, 132, (1, False)),
    (1024, 5, 16, 256, 4, 2, 132, (4, True)),   # 1024 blocks: more than four an SM
    (4096, 5, 16, 128, 2, 2, 132, (2, True)),
    (3, 5, 16, 512, 8, 2, 8, (2, False)),
    (60, 5, 16, 512, 8, 2, 8, (8, True)),
    (16, 32, 16, 512, 16, 2, 132, (1, False)),
])
def test_cross_group_plan_by_hand(b, k, te, h, nh, itemsize, sms, plan):
    """(g, reuse) worked out by hand: the largest group whose grid gives
    every SM a block (else one head), and the reuse layout where the
    group's column pairs fill a block or the grid gives each SM more than
    four blocks."""
    assert cross_groups(b, k, te, h, nh, itemsize, sms) == plan


def test_cross_group_plan_at_the_serving_shapes():
    """The ARB decode's shapes (beam 5, Te 16, H 512, 8 heads, bf16, 132
    SMs): at 64 videos two heads a block (256 blocks: four would leave SMs
    idle), at B=1024 all eight (1024 blocks of 47,984 bytes: 16 KB of K and
    of V, 10 KB of queries, the exponentials); a float32 K/V at B=1024 the same;
    beam 32 at 16 videos, 16 heads, one head a block (256 blocks)."""
    assert cross_groups(64, 5, 16, 512, 8, 2, 132) == (2, False)
    assert cross_groups(1024, 5, 16, 512, 8, 2, 132) == (8, True)
    assert cross_groups(1024, 5, 16, 512, 8, 4, 132) == (8, True)
    assert cross_groups(16, 32, 16, 512, 16, 2, 132) == (1, False)
    assert cross_stage_bytes(5, 16, 512, 8, 2, 8) == (2 * 16 * 1040 + 5 * 516 * 4
                                                      + 8 * (16 * 8 + 4) * 4 + 40 * 4)
    assert cross_stage_bytes(5, 16, 512, 8, 2, 8) == 47984


def test_cross_group_plan_refuses_what_the_kernel_does_not_take():
    """A group whose slice of a position is not whole 16-byte vectors (one
    head of 4 bf16), or no group at all within STAGE_MAX (Te 2000, H 1024,
    one head), is refused."""
    assert not cross_group_ok(1, 5, 16, 128, 32, 2)
    assert cross_group_ok(2, 5, 16, 128, 32, 2)
    assert not cross_group_ok(3, 5, 16, 512, 8, 2)  # does not divide the heads
    assert cross_groups(1024, 5, 16, 128, 32, 2, 132)[0] == 32
    with pytest.raises(ValueError, match="stage"):
        cross_groups(4, 5, 2000, 1024, 1, 2, 132)


@pytest.mark.parametrize("n,l,le,h,inter", [(384, 32, 16, 512, 2048), (2048, 30, 16, 512, 2048),
                                            (7, 13, 5, 256, 1024), (1, 8, 32, 128, 272)])
def test_fwd_scratch_sizes_and_alignment(n, l, le, h, inter):
    """The forward on the row walk (K11; K1u runs the same launches, so one
    planner sizes both) takes N * Lp decoder rows and N * Lep encoder rows,
    L and Le rounded up to 16; five tenants of the decoder rows, three of
    the encoder rows, the FFN activations, the float32 residual stream and
    r2. Every (rows, H) slice starts 16-byte aligned (TMA reads it)."""
    lp, lep = math.ceil(l / 16) * 16, math.ceil(le / 16) * 16
    bf = torch.bfloat16
    assert fwd_scratch(n, l, le, h, inter) == {
        "rows": ((5, n * lp, h), bf), "enc_rows": ((3, n * lep, h), bf),
        "g": ((n * lp, inter), bf), "res": ((n * lp, h), torch.float32),
        "r2": ((n, lp, h), bf)}
    if (n, l, le) == (384, 32, 16):  # K1u at K1's shape: 12288 rows, 6144 encoder rows
        total = sum(math.prod(s) * torch.empty((), dtype=dt).element_size()
                    for s, dt in fwd_scratch(n, l, le, h, inter).values())
        assert total == 12288 * (5 * 512 * 2 + 2048 * 2 + 512 * 4 + 512 * 2) + 6144 * 3 * 512 * 2
    if n * lp * h < 1 << 22:
        for name in ("rows", "enc_rows"):
            shape, dt = fwd_scratch(n, l, le, h, inter)[name]
            for t in torch.empty(shape, dtype=dt).unbind(0):
                assert t.data_ptr() % 16 == 0


def _layer_operands(n, l, le, h, heads, inter):
    bf = torch.bfloat16
    mats = {f: torch.zeros((h, h), dtype=bf) for f in LayerWeights.__dataclass_fields__
            if f.startswith("w")}
    mats.update(wi=torch.zeros((inter, h), dtype=bf), wo2=torch.zeros((h, inter), dtype=bf))
    vecs = {f: torch.zeros(h) for f in LayerWeights.__dataclass_fields__
            if f.startswith("b")}
    vecs["bi"] = torch.zeros(inter)
    w = LayerWeights(**mats, **vecs)
    return dict(raw=torch.zeros((n, l, h), dtype=bf), static=torch.zeros((n, l, h), dtype=bf),
                kp=torch.zeros((n, l), dtype=torch.bool),
                ke=torch.zeros((n, le, h), dtype=bf), ve=torch.zeros((n, le, h), dtype=bf),
                w=w, ln_scale=torch.ones(h), ln_bias=torch.zeros(h), n_head=heads,
                out_dtype=torch.bfloat16)


@pytest.mark.parametrize("n,l,h,inter", [(384, 32, 512, 2048), (384, 29, 512, 2048),
                                         (1, 24, 256, 1024), (7, 13, 128, 272)])
def test_walk_scratch_sizes_and_alignment(n, l, h, inter):
    """K1's query rows are its N * L canvas rows, flattened with no sequence
    padding; K2's canvas rows are padded to 16 a sequence, its query rows
    not. Every (rows, H) slice of the scratch starts 16-byte aligned (TMA
    reads it) and the whole fits the walk's row tiles."""
    k1 = walk_scratch(n, l, h, inter)
    rows = n * l
    assert k1 == {"rows": ((5, rows, h), torch.bfloat16), "g": ((rows, inter), torch.bfloat16),
                  "res": ((rows, h), torch.float32),
                  "plan": ((2 * (n + 1) + rows,), torch.int32)}
    k = min(24, l)
    k2 = walk_scratch(n, l, h, inter, k)
    assert k2["canvas"][0] == (3, n * math.ceil(l / 16) * 16, h)
    assert k2["query"][0] == (3, n * k, h) and k2["g"][0] == (n * k, inter)
    # the plan: the canvas and query offsets, N + 1 each, and a map slot per query row
    assert k2["plan"] == ((2 * (n + 1) + n * k,), torch.int32)
    if (n, l, h) == (384, 32, 512):  # the NACF decode: 12288 rows, 138 MB
        total = sum(math.prod(s) * torch.empty((), dtype=dt).element_size()
                    for s, dt in k1.values())
        assert rows == 12288 and total == (12288 * (5 * 512 * 2 + 2048 * 2 + 512 * 4)
                                           + 4 * (2 * 385 + 12288))
    for shape, dt in list(k1.values()) + list(k2.values()):
        if len(shape) == 3 and shape[1] * shape[2] < 1 << 22:
            for t in torch.empty(shape, dtype=dt).unbind(0):
                assert t.data_ptr() % 16 == 0


def test_check_layer_takes_the_walk_shapes_and_refuses_others():
    """check_layer accepts the shapes the walk takes (L up to 32, ragged L,
    one sequence, H 128 to 512) and refuses the others with ValueError,
    without a card."""
    for n, l, le, h, heads, inter in [(384, 32, 16, 512, 8, 2048), (1, 29, 16, 256, 4, 1024),
                                      (3, 24, 8, 128, 2, 272)]:
        check_layer(**_layer_operands(n, l, le, h, heads, inter))
    bad = {
        "canvas longer than 32": dict(l=33),
        "encoder longer than 32": dict(le=40),
        "H not a multiple of 128": dict(h=192, heads=4),
        "H above 512": dict(h=640, heads=5),
        "head width not a multiple of 16": dict(h=384, heads=16),
        "FFN not a multiple of 16": dict(inter=1000),
    }
    for what, change in bad.items():
        shape = dict(n=2, l=24, le=16, h=256, heads=4, inter=1024)
        shape.update(change)
        with pytest.raises(ValueError):
            check_layer(**_layer_operands(**shape))
            pytest.fail(what)
    ops = _layer_operands(2, 24, 16, 256, 4, 1024)
    flat = torch.zeros(256 * 256 + 1, dtype=torch.bfloat16)
    ops["w"].wq_s = flat[1:].view(256, 256)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte"):
        check_layer(**ops)
    ops = _layer_operands(2, 24, 16, 256, 4, 1024)
    ops["kp"] = ops["kp"].to(torch.uint8)
    with pytest.raises(ValueError, match="kp"):
        check_layer(**ops)


# The serving walk's plan (walk_plan, the card's first two launches): each
# canvas's extent 1 + its last non-PAD position, K2's query extent 1 + its
# last used slot, the exclusive offsets of both, and each live query row's
# output row n * Kq + i. Interior PAD is live; a canvas all PAD has none.
def _kp(rows):
    return torch.tensor([[c == "p" for c in r] for r in rows], dtype=torch.bool)


PLAN_CASES = {  # canvases ("." a token, "p" PAD), qidx rows or None, extents, query extents
    "prefix": (["..pp", "....", ".ppp"], None, [2, 4, 1], None),
    "interior PAD": (["p.p.", ".pp.", "pp.p"], None, [4, 4, 3], None),
    "all live": (["....", "...."], None, [4, 4], None),
    "a canvas all PAD": (["pppp", "..pp"], None, [0, 2], None),
    "one slot": (["...p", "..pp"], [[2, -1, -1], [-1, -1, -1]], [3, 2], [1, 0]),
    "every slot": (["....", "...p"], [[0, 1, 3], [0, 1, 2]], [4, 3], [3, 3]),
    "interior unused slot": (["....", "...."], [[1, -1, 3], [-1, -1, -1]], [4, 4], [3, 0]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_walk_plan_extents_offsets_and_map(case):
    canvases, slots, ext, qext = PLAN_CASES[case]
    kp = _kp(canvases)
    qidx = None if slots is None else torch.tensor(slots, dtype=torch.int32)
    coff, qoff, rows = walk_plan(kp, qidx)
    assert coff.tolist() == [0] + np.cumsum(ext).tolist()
    qext = ext if qext is None else qext
    assert qoff.tolist() == [0] + np.cumsum(qext).tolist()
    kq = kp.shape[1] if qidx is None else qidx.shape[1]
    assert rows.tolist() == [n * kq + i for n, e in enumerate(qext) for i in range(e)]
    assert coff.dtype == qoff.dtype == rows.dtype == torch.int32


@pytest.mark.parametrize("extent", [4, 15, 16, 17, 29, 32])
@pytest.mark.parametrize("k", [None, 1, 8, 24], ids=["k1", "k2-1", "k2-8", "k2-24"])
def test_walk_plan_at_each_extent(extent, k):
    """A batch of canvases of 32 whose extents are all `extent`, with
    interior PAD below it, one a plain prefix; K2 with one used slot, or
    every slot below the extent used, against a per-canvas count."""
    g = torch.Generator().manual_seed(extent * 100 + (k or 0))
    n, l = 6, 32
    kp = torch.rand(n, l, generator=g) < 0.3
    kp[:, extent:] = True
    kp[:, extent - 1] = False
    kp[0] = torch.arange(l) >= extent
    qidx = None
    if k is not None:
        qidx = torch.full((n, k), -1, dtype=torch.int32)
        for i in range(n):
            used = 1 if i % 2 else min(k, extent)
            qidx[i, :used] = torch.arange(used, dtype=torch.int32)
    coff, qoff, rows = walk_plan(kp, qidx)
    assert torch.equal(coff, torch.arange(n + 1, dtype=torch.int32) * extent)
    want = []
    for i in range(n):
        e = extent if qidx is None else int((qidx[i] >= 0).sum())
        assert int(qoff[i + 1] - qoff[i]) == e
        want += [i * (l if qidx is None else k) + j for j in range(e)]
    assert rows.tolist() == want


def _cpu_layer(n, l, le, h, heads, inter, seed):
    g = torch.Generator().manual_seed(seed)

    def mat(o, i):
        return ((torch.rand(o, i, generator=g) * 2 - 1) / math.sqrt(i)).to(torch.bfloat16)

    def vec(o):
        return torch.rand(o, generator=g) * 0.2 - 0.1

    fields = {}
    for name in ("q", "k", "v", "o"):
        for sfx in ("s", "c"):
            fields["w%s_%s" % (name, sfx)] = mat(h, h)
            fields["b%s_%s" % (name, sfx)] = vec(h)
    fields.update(wi=mat(inter, h), bi=vec(inter), wo2=mat(h, inter), bo2=vec(h))
    raw, static = (torch.randn(n, l, h, generator=g).to(torch.bfloat16) for _ in range(2))
    kp = torch.zeros(n, l, dtype=torch.bool)
    for i, e in enumerate((4, 15, 16, 17, 29, 32)[:n]):
        kp[i, e:] = True
        if e > 4:
            kp[i, 1] = kp[i, e - 3] = True  # interior PAD below the extent
    ke, ve = (torch.randn(n, le, h, generator=g).to(torch.bfloat16) for _ in range(2))
    lns, lnb = 1 + 0.1 * torch.randn(h, generator=g), 0.1 * torch.randn(h, generator=g)
    mask_row = torch.randn(h, generator=g).to(torch.bfloat16)
    return LayerWeights(**fields), raw, static, kp, ke, ve, lns, lnb, mask_row


def _fixed_order_mm(x, w):
    """``fused_layer._mm`` with each element's products summed in one order
    whatever the row count: the CPU's BLAS picks its blocking by the rows,
    so its bits depend on them, which the card's row walk does not."""
    return (fused_layer_module._bf(x)[..., None, :] * w.to(torch.float32)).sum(-1)


@pytest.mark.parametrize("form", ["nar", "causal", "qsub"])
def test_plain_restricted_to_the_extents_equals_the_dense_plain(form, monkeypatch):
    """The walk's premise, on the plain versions: each canvas run alone on
    its extent (K2: its live slots) gives bit for bit the rows the dense
    plain version gives over the whole batch, and every row past the extent
    (slot past the query extent) of the dense output is zero: a key past
    the extent is PAD, masked, and its exp is 0 in float32. The products
    are summed in a fixed order (``_fixed_order_mm``)."""
    monkeypatch.setattr(fused_layer_module, "_mm", _fixed_order_mm)
    n, l, le, h, heads, inter = 6, 32, 5, 128, 2, 256
    w, raw, static, kp, ke, ve, lns, lnb, mask_row = _cpu_layer(n, l, le, h, heads, inter, 7)
    if form == "qsub":
        g = torch.Generator().manual_seed(3)
        k = 24
        qidx = torch.full((n, k), -1, dtype=torch.int32)
        for i in range(n):
            real = (~kp[i]).nonzero()[:, 0]
            pick = real[torch.randperm(len(real), generator=g)[:1 if i == 2 else k]]
            qidx[i, :len(pick)] = pick.sort().values.to(torch.int32)
        dense = fused_layer_qsub_plain(qidx, mask_row, raw, static, kp, ke, ve, w, lns, lnb,
                                       heads)
    else:
        qidx = None
        dense = fused_layer_plain(raw, static, kp, ke, ve, w, lns, lnb, heads,
                                  causal=form == "causal")
    coff, qoff, _ = walk_plan(kp, qidx)
    for i in range(n):
        e, eq = int(coff[i + 1] - coff[i]), int(qoff[i + 1] - qoff[i])
        one = (raw[i:i + 1, :e], static[i:i + 1, :e], kp[i:i + 1, :e], ke[i:i + 1],
               ve[i:i + 1], w, lns, lnb, heads)
        if qidx is None:
            alone = fused_layer_plain(*one, causal=form == "causal")
        else:
            alone = fused_layer_qsub_plain(qidx[i:i + 1, :eq], mask_row, *one)
        assert torch.equal(alone[0], dense[i, :eq]), (form, i)
        assert torch.all(dense[i, eq:] == 0)
