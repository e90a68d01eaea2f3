"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips when
no NVIDIA card is present. chip_smoke.py checks the kernels at the NACF and
ARB main paths' shapes; these tests cover the other shapes the kernels
accept — ragged row tiles, a vocab edge inside a tile, canvases and encoder
lengths below 32, one query tile, H = 128 and 256, beam sizes 1 to 8,
batches that are no multiple of 16 — plus the wrappers' refusals and launch
counts. Run them on a machine with a card:

    python3 -m pytest tests/test_torch_port_cuda.py -q --noconftest

(``--noconftest``: the shared conftest imports JAX, which this file does
not need.) Tolerances are chip_smoke.py's: hidden states 5e-2 absolute (a
float32 sum-order flip of one bf16 rounding propagates through the layer),
probabilities 1e-4 relative, ids equal where the top-2 logit margin is
above 1e-3; top-k log-probs and attention outputs 1e-4 absolute (float32
sums in another order, an online softmax against a one-pass one); the cache
permute and cache writes exactly.
"""

import math

import pytest
import torch

from navc_tpu_torch.ops import _build
from navc_tpu_torch.ops.beam_attend import (beam_attend_step,
                                            beam_attend_step_plain,
                                            cross_attend, cross_attend_plain)
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


VOCAB_SHAPES = [  # rows, d, V
    (1, 512, 10048), (70, 64, 50), (200, 16, 1001), (129, 512, 4099)]


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
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _gen(0)
    hid = torch.randn(4, 32, generator=g).to(cuda)
    w = torch.randn(10, 32, generator=g).to(cuda, torch.bfloat16)
    with pytest.raises(TypeError):
        project_argmax(hid, w)                       # float32 h
    with pytest.raises(ValueError):
        project_argmax(hid.to(torch.bfloat16)[:, :24].contiguous(), w[:, :24].contiguous())
    weights = _weights(128, 128, g, cuda)
    raw, static, kp, ke, ve, lns, lnb = _layer_inputs(2, 40, 8, 128, g, cuda)
    with pytest.raises(ValueError):                  # canvas longer than 32
        fused_layer(raw, static, kp, ke, ve, weights, lns, lnb, n_head=2)
    with pytest.raises(ValueError):                  # non-contiguous operand
        fused_layer(raw[:, :16], static[:, :16].contiguous(),
                    kp[:, :16].contiguous(), ke, ve, weights, lns, lnb, n_head=2)


TOPK_SHAPES = [  # rows, d, V, k
    (320, 512, 10048, 5), (7, 64, 1001, 1), (130, 256, 4099, 8),
    (64, 512, 50, 3), (5120, 512, 10048, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TOPK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_project_topk_matches_plain(cuda, shape, with_bias):
    r, d, v, k = shape
    g = _gen(r + d + v + k + with_bias)
    hid = torch.randn(r, d, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(v, d, generator=g) / math.sqrt(d)).to(cuda, torch.bfloat16)
    bias = (torch.randn(v, generator=g) * 0.5).to(cuda) if with_bias else None
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


@pytest.mark.cuda
def test_project_topk_ties_go_to_the_lowest_id(cuda):
    g = _gen(5)
    hid = torch.randint(-1, 2, (40, 32), generator=g).float()
    w = torch.randint(-1, 2, (3000, 32), generator=g).float()
    w[1500:2900] = w[:1400]  # exact duplicates across tiles and splits
    lp, ids = project_topk(hid.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16), 8)
    order = torch.sort(hid @ w.t(), dim=-1, descending=True, stable=True).indices[:, :8]
    assert torch.equal(ids.cpu(), order.to(torch.int32))


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,te,h,heads", [
    (64, 5, 16, 512, 8), (7, 1, 8, 256, 4), (12, 3, 16, 256, 2), (16, 8, 16, 512, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_attend_matches_plain(cuda, b, k, te, h, heads, dtype):
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


def _check_train_kernels(cuda, case, bias_scale=1.0):
    from navc_tpu_torch.ops import fused_layer_train as FT

    h, inter, n, l, le, causal, p = case
    g = _gen(sum(case[:5]))
    x, enc, kp, w = _train_inputs(h, inter, n, l, le, g, cuda, bias_scale)
    kw = dict(n_head=8, causal=causal, p=p, p_input=p)
    seed = 2 ** 31 - 17
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


CE_TOL, CE_RMS_TOL = 1e-4, 2e-5  # g, z: float32 sums in another order
CE_CASES = [  # N, D, V, bias
    (1920, 512, 10048, True),
    (1920, 512, 10048, False),
    (37, 64, 157, False),
    (200, 128, 1000, True),
    (65, 512, 130, True),
]


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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
@pytest.mark.parametrize("shape", [(384, 32, 16, 512, 2048), (7, 13, 5, 256, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_layer_unfolded_matches_plain(cuda, shape, causal):
    from navc_tpu_torch.ops.fused_layer import (fused_layer_unfolded,
                                                fused_layer_unfolded_plain)

    n, l, le, h, inter = shape
    g = _gen(sum(shape))
    w = _weights(h, inter, g, cuda)
    lengths = torch.randint(1, l + 1, (n,), generator=g)
    lengths[0] = l
    kp = (torch.arange(l)[None] >= lengths[:, None]).to(cuda)
    x = torch.randn(n, l, h, generator=g).to(cuda)
    enc = torch.randn(n, le, h, generator=g).to(cuda)
    before = _build.LAUNCHES["fused_layer_unfolded"]
    out = fused_layer_unfolded(x, enc, kp, w, n_head=8, causal=causal,
                               out_dtype=torch.bfloat16)
    want = fused_layer_unfolded_plain(x, enc, kp, w, 8, causal, torch.bfloat16)
    torch.cuda.synchronize()
    _close(out, want, TRAIN_TOL, "out", rms_tol=TRAIN_RMS_TOL)
    assert torch.all(out[kp] == 0)
    assert _build.LAUNCHES["fused_layer_unfolded"] == before + 1
