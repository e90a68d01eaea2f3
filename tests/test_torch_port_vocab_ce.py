"""The port's fused projection + cross-entropy (K9/K10) against navc_tpu's.

On the CPU ``navc_tpu_torch.ops.vocab_ce.vocab_ce_train`` runs its plain
versions through its ``torch.autograd.Function``; navc_tpu's
``vocab_ce_train`` runs its Pallas kernels with ``interpret=True`` under
``jax.grad``, as tests/test_vocab_ce.py runs them. Same seeded numpy inputs
(W in navc_tpu's (D, V) layout, the port's (V, D) its transpose), the same
per-row cotangent of g with some rows zero (PAD labels, dropped rows).

Tolerances:
  * float32 compute: g, dh, dW, db atol = rtol = 1e-5; argmax ids equal;
  * bfloat16 compute (the JAX side in a subprocess with
    ``XLA_FLAGS=--xla_allow_excess_precision=false``, without which XLA's
    CPU backend keeps bf16 roundings in float32): g atol 1e-5, ids equal;
    dh, dW, db atol 4e-3 of each tensor's largest magnitude — a float32
    score summed in another order can round ds to the neighbouring bf16
    value (2^-8 relative), which then enters every sum it feeds.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.ops.vocab_ce import vocab_ce_train as jax_vocab_ce
from navc_tpu_torch.ops.vocab_ce import (vocab_ce_bwd_plain, vocab_ce_fwd_plain,
                                         vocab_ce_train)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 37, 32  # N ragged against every row tile
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_SCALED = 4e-3


def inputs(v, seed=0, with_bias=True, bf16_exact=False):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(D, v) * 0.3).astype(np.float32)
    if bf16_exact:
        h, w = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                for a in (h, w))
    bias = (rng.randn(v) * 0.1).astype(np.float32) if with_bias else None
    lab = rng.randint(0, v, N).astype(np.int32)
    cot = (rng.randn(N) * (rng.rand(N) > 0.3)).astype(np.float32)  # zero rows
    return h, w, bias, lab, cot


def jax_side(h, w, bias, lab, cot, compute):
    """(g, pred, dh, dW (D, V), db or None) of navc_tpu's kernels."""
    cdt = jnp.dtype(compute)

    def loss(h, w, b):
        g, _ = jax_vocab_ce(h, w, b, jnp.asarray(lab), compute_dtype=cdt, interpret=True)
        return (g * jnp.asarray(cot)).sum()

    args = [jnp.asarray(h), jnp.asarray(w)] + ([jnp.asarray(bias)] if bias is not None else [])
    fn = (lambda h, w, b: loss(h, w, b)) if bias is not None else (lambda h, w: loss(h, w, None))
    grads = jax.grad(fn, argnums=tuple(range(len(args))))(*args)
    g, pred = jax_vocab_ce(*args[:2], args[2] if bias is not None else None, jnp.asarray(lab),
                           compute_dtype=cdt, interpret=True)
    return (np.asarray(g), np.asarray(pred), np.asarray(grads[0]), np.asarray(grads[1]),
            np.asarray(grads[2]) if bias is not None else None)


def port_side(h, w, bias, lab, cot, compute):
    """(g, pred, dh, dW (D, V), db or None) of the port's Function."""
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w.T.copy(), requires_grad=True)
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    g, pred = vocab_ce_train(th, tw, tb, torch.from_numpy(lab), compute)
    (g * torch.from_numpy(cot)).sum().backward()
    return (g.detach().numpy(), pred.numpy(), th.grad.numpy(), tw.grad.numpy().T,
            None if tb is None else tb.grad.numpy())


NAMES = ("g", "pred", "dh", "dW", "db")


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("v", [157, 300, 40])
def test_plain_matches_navc_tpu_f32(v, with_bias):
    args = inputs(v, seed=v, with_bias=with_bias)
    want = jax_side(*args, "float32")
    got = port_side(*args, torch.float32)
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
        elif name == "pred":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_masked_rows_give_zero_gradients():
    """A zero cotangent everywhere gives exactly zero dh, dW and db; a zero
    row gives an exactly zero dh row."""
    h, w, bias, lab, cot = inputs(157, seed=3)
    for c in (np.zeros_like(cot), cot):
        _, _, dh, dw, db = port_side(h, w, bias, lab, c, torch.float32)
        assert np.all(dh[c == 0] == 0.0)
        if not c.any():
            assert not dw.any() and not db.any()


def test_ties_go_to_the_lowest_id():
    h = np.ones((3, D), np.float32)
    w = np.zeros((D, 20), np.float32)
    w[:, [4, 9, 15]] = 1.0  # three equal maxima
    lab = np.array([4, 9, 0], np.int32)
    _, pred_j = jax_vocab_ce(jnp.asarray(h), jnp.asarray(w), None, jnp.asarray(lab),
                             compute_dtype=jnp.float32, interpret=True)
    _, pred = vocab_ce_train(torch.from_numpy(h), torch.from_numpy(w.T.copy()), None,
                             torch.from_numpy(lab), torch.float32)
    assert pred.tolist() == [4, 4, 4] == np.asarray(pred_j).tolist()


def test_plain_bwd_is_autograd_of_plain_fwd():
    """``vocab_ce_bwd_plain`` in float32 equals autograd of the float32
    log-softmax the forward computes."""
    h, w, bias, lab, cot = inputs(157, seed=5)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w.T.copy(), requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    logp = torch.log_softmax(th @ tw.t() + tb, -1)
    (logp.gather(1, torch.from_numpy(lab).long()[:, None])[:, 0]
     * torch.from_numpy(cot)).sum().backward()
    _, _, z = vocab_ce_fwd_plain(th.detach(), tw.detach(), tb.detach(),
                                 torch.from_numpy(lab), torch.float32)
    dh, dw, db = vocab_ce_bwd_plain(th.detach(), tw.detach(), tb.detach(),
                                    torch.from_numpy(lab), z, torch.from_numpy(cot),
                                    torch.float32)
    for a, b in ((dh, th.grad), (dw, tw.grad), (db, tb.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


BF16_CASES = {"v157_bias": (157, True), "v300_nobias": (300, False)}


def write_jax_bf16_refs(path):
    """navc_tpu's bf16 values and gradients for BF16_CASES, saved to ``path``
    (.npz); run in a process of its own with
    XLA_FLAGS=--xla_allow_excess_precision=false."""
    out = {}
    for case, (v, with_bias) in BF16_CASES.items():
        ref = jax_side(*inputs(v, seed=11, with_bias=with_bias, bf16_exact=True), "bfloat16")
        out.update({"%s/%s" % (case, k): x for k, x in zip(NAMES, ref) if x is not None})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_bf16_refs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab_ce") / "ref.npz")
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import test_torch_port_vocab_ce as t\n"
            "t.write_jax_bf16_refs(sys.argv[1])\n" % os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_plain_matches_navc_tpu_bf16(case, jax_bf16_refs):
    v, with_bias = BF16_CASES[case]
    got = port_side(*inputs(v, seed=11, with_bias=with_bias, bf16_exact=True),
                    torch.bfloat16)
    for name, a in zip(NAMES, got):
        if a is None:
            continue
        ref = jax_bf16_refs["%s/%s" % (case, name)]
        if name == "pred":
            np.testing.assert_array_equal(a, ref)
        elif name == "g":
            np.testing.assert_allclose(a, ref, atol=1e-5, rtol=0)
        else:
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(a, ref, atol=BF16_SCALED * scale, rtol=0,
                                       err_msg=name)


# -- K10's split planners (ops/vocab_ce.py), checked on their outputs -------

PLAN_ROWS = (1, 37, 333, 1920, 61440)  # one row, ragged tiles, B=64 and B=2048 passes


def _runs(units, splits, per):
    """The [begin, end) units of each split, as the kernels cut them."""
    return [(j * per, min(units, (j + 1) * per)) for j in range(splits)]


def _check_partition(units, splits, per):
    runs = _runs(units, splits, per)
    assert runs[0][0] == 0 and runs[-1][1] == units
    assert all(b < e for b, e in runs)  # no split is empty
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


def _fill(blocks, sms=132):
    """The share of the SM slots of the call's waves that hold a block."""
    return blocks / (-(-blocks // sms) * sms)


@pytest.mark.parametrize("v", [130, 1001, 10048])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_dh_plan_covers_every_row_and_vocab_pair_once(rows, v):
    """ce_bwd_dh's grid is row tiles x vocab splits: the splits cut the
    vocab tiles into contiguous runs, none empty, so that every (row, vocab)
    pair falls to exactly one block."""
    from navc_tpu_torch.ops.vocab_ce import CE_TILE, CE_TILE_V, dh_plan

    splits, per = dh_plan(rows, v, 512, 132)
    tiles = -(-v // CE_TILE_V)
    _check_partition(tiles, splits, per)
    if rows * v <= 333 * 10048:
        hits = np.zeros((rows, v), np.int32)
        for i in range(-(-rows // CE_TILE)):
            for b, e in _runs(tiles, splits, per):
                hits[i * CE_TILE:(i + 1) * CE_TILE, b * CE_TILE_V:e * CE_TILE_V] += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("v", [130, 1001, 10048])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_dw_plan_covers_every_row_and_vocab_pair_once(rows, v):
    """ce_bwd_dw's grid is vocab tiles x row splits: the planned number of
    splits cuts the rows' 64-row chunks into runs of equal length, none
    empty when every row runs, so that every (row, vocab) pair falls to
    exactly one block. (The kernel's cut of fewer live rows is held on the
    card by the cuda cases with few and with all rows live.)"""
    from navc_tpu_torch.ops.vocab_ce import CE_TILE, dw_plan

    splits = dw_plan(rows, v, 512, 132)
    chunks = -(-rows // CE_TILE)
    assert isinstance(splits, int) and 1 <= splits <= chunks
    _check_partition(chunks, splits, -(-chunks // splits))


@pytest.mark.parametrize("rows", [1920, 61440])
def test_split_plans_fill_whole_waves(rows):
    """At the training step's shapes (D 512, V 10048) on 132 SMs: the dh
    launch's 30 row tiles at B=64 take a vocab split (4 x 30 = 120 blocks,
    one wave), its 960 at B=2048 none; the dW launch's 157 vocab tiles at
    B=2048 take 5 row splits (785 blocks in 6 waves of 792 slots), where
    one split would leave a second wave of 25 blocks. At B=64 the dW
    launch takes one split (157 blocks in 2 waves): a second split's partial
    dW (20.6 MB written, read and summed) costs more than the half-empty
    wave (chip_smoke.py times both; PERF.md)."""
    from navc_tpu_torch.ops.vocab_ce import CE_TILE, dh_plan, dw_plan

    v, d = 10048, 512
    splits, _ = dh_plan(rows, v, d, 132)
    assert _fill(-(-rows // CE_TILE) * splits) >= 0.9
    splits = dw_plan(rows, v, d, 132)
    if rows == 61440:
        assert _fill(-(-v // CE_TILE) * splits) >= 0.9
    else:
        assert splits == 1


def test_live_first_puts_the_rows_with_a_gradient_first_in_order():
    """K10 runs the rows whose dg is not 0, moved to the front in their
    order (the others after them, in theirs), with their labels, z and dg;
    ``meta`` maps each moved row back and holds their count."""
    from navc_tpu_torch.ops.vocab_ce import live_first

    rng = np.random.RandomState(4)
    h = torch.from_numpy(rng.randn(9, 4).astype(np.float32))
    lab = torch.arange(9, dtype=torch.int32) * 3
    z = torch.from_numpy(rng.randn(9).astype(np.float32))
    dg = torch.tensor([0.0, 1.5, 0.0, -2.0, 3.0, 0.0, 0.0, 0.5, 0.0])
    hl, meta = live_first(h, lab, z, dg)
    order = [1, 3, 4, 7, 0, 2, 5, 6, 8]
    assert meta.dtype == torch.int32 and tuple(meta.shape) == (5, 9)
    assert meta[0].tolist() == order and int(meta[4, 0]) == 4
    assert torch.equal(hl, h[order]) and torch.equal(meta[1], lab[order])
    assert torch.equal(meta[2].view(torch.float32), z[order])
    gl = meta[3].view(torch.float32)
    assert torch.equal(gl, dg[order])
    assert not gl[4:].any() and gl[:4].all()
