"""The port's kernel modules vs navc_tpu's Pallas kernels (interpret mode).

On the CPU each wrapper of navc_tpu_torch runs its plain version: float32
PyTorch with the CUDA kernel's bf16 rounding points. Here that plain version
meets the JAX Pallas kernel, run with ``interpret=True`` as
tests/test_fused_layer.py and tests/test_pallas_ops.py run it, on the same
seeded numpy inputs and the same weights. Tolerances:

  * hidden states: atol 2e-3 — both round matmul operands to bf16 at the
    same points, but a float32 sum taken in another order can land on the
    other side of a bf16 rounding boundary, and such a one-ulp flip (2^-8
    relative) propagates through the following products;
  * ids: equal wherever the top-2 logit margin is above 1e-3;
  * probabilities: rtol 1e-4;
  * K2 rows vs K1 rows at the same positions: atol 1e-6 (same arithmetic,
    row-independent).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.ops.fused_layer import (fused_nar_decoder_layer,
                                      fused_nar_decoder_layer_qsub,
                                      hoist_cross_kv as jax_hoist_cross_kv,
                                      layer_weights_from_params)
from navc_tpu.ops.vocab_fused import (fused_project_argmax,
                                      fused_project_gather_prob)
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops import _build
from navc_tpu_torch.ops.fused_layer import (fused_layer, fused_layer_qsub,
                                            hoist_cross_kv, layer_weights)
from navc_tpu_torch.ops.vocab_fused import (project_argmax,
                                            project_gather_prob)

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi", max_len=10, compute_dtype="float32")
HID_ATOL = 2e-3


def _bf16_np(rng, *shape, scale=1.0):
    """Random float32 values that bf16 represents exactly."""
    x = (rng.randn(*shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def layer():
    """One BertLayer's weights in both packages, plus its embedding LN."""
    jcfg = jax_default_config("NAB", dataset="MSVD", **TOY)
    variables = jax.tree_util.tree_map(
        np.asarray, init_params(jax_build_model(jcfg), jax.random.PRNGKey(4), jcfg))
    model = load_flax_variables(
        build_model(default_config("NAB", dataset="MSVD", **TOY), device="cpu"),
        variables)
    rng = np.random.RandomState(11)
    # non-trivial LN affine so the prologue's scale/bias are exercised
    lns = (1.0 + 0.1 * rng.randn(16)).astype(np.float32)
    lnb = (0.1 * rng.randn(16)).astype(np.float32)
    return dict(
        jw=layer_weights_from_params(variables["params"]["decoder"]["layer_0"]),
        tw=layer_weights(model.decoder.layers[0]), lns=lns, lnb=lnb)


def _canvas(rng, n, l, le, h=16):
    raw = _bf16_np(rng, n, l, h)
    static = _bf16_np(rng, n, l, h)
    lengths = rng.randint(3, l + 1, n)
    lengths[0] = l  # one full row, one row of every other length
    kp = np.arange(l)[None, :] >= lengths[:, None]
    enc = rng.randn(n, le, h).astype(np.float32)
    return raw, static, kp, enc


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [False, True], ids=["nar", "causal"])
def test_fused_layer_plain_matches_pallas(layer, causal):
    rng = np.random.RandomState(1)
    n, l, le = 5, 16, 8
    raw, static, kp, enc = _canvas(rng, n, l, le)
    ke, ve = jax_hoist_cross_kv(jnp.asarray(enc), layer["jw"])
    ref = fused_nar_decoder_layer(
        jnp.asarray(raw), None, jnp.asarray(kp), layer["jw"], n_head=2, tb=8,
        interpret=True, causal=causal, static=jnp.asarray(static),
        ln_scale=jnp.asarray(layer["lns"]), ln_bias=jnp.asarray(layer["lnb"]),
        ln_eps=1e-5, out_dtype=jnp.float32, enc_kv=(ke, ve))
    bf = torch.bfloat16
    out = fused_layer(
        _t(raw).to(bf), _t(static).to(bf), _t(kp), _t(ke.astype(jnp.float32)).to(bf),
        _t(ve.astype(jnp.float32)).to(bf), layer["tw"], _t(layer["lns"]),
        _t(layer["lnb"]), n_head=2, causal=causal, ln_eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=HID_ATOL)
    assert np.all(out.numpy()[kp] == 0.0)  # PAD rows: non-pad multiplier


def test_hoist_cross_kv_matches_jax(layer):
    rng = np.random.RandomState(2)
    enc = rng.randn(4, 8, 16).astype(np.float32)
    ke_j, ve_j = jax_hoist_cross_kv(jnp.asarray(enc), layer["jw"])
    ke, ve = hoist_cross_kv(_t(enc), layer["tw"])
    assert ke.dtype == ve.dtype == torch.bfloat16
    # same arithmetic; a float32 sum order flip may move one bf16 ulp
    for a, b in ((ke, ke_j), (ve, ve_j)):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)
        assert np.mean(a == b) > 0.98


def _query_selection(rng, kp, k):
    """A re-mask set per row and its JAX one-hot ``sel`` (N, K, L); the
    port's index tensor is derived from that same ``sel``."""
    n, l = kp.shape
    mask_ind = (rng.rand(n, l) < 0.4) & ~kp
    mask_ind[:, 0] = True
    ranks = np.cumsum(mask_ind, axis=1) - 1
    sel = (ranks[:, None, :] == np.arange(k)[None, :, None]) & mask_ind[:, None, :]
    qidx = np.where(sel.any(-1), sel.argmax(-1), -1).astype(np.int32)
    return mask_ind, sel, qidx


def test_fused_layer_qsub_plain_matches_pallas_and_dense_rows(layer):
    rng = np.random.RandomState(3)
    n, l, le, k = 6, 16, 8, 8
    raw, static, kp, enc = _canvas(rng, n, l, le)
    mask_row = _bf16_np(rng, 16)
    mask_ind, sel, qidx = _query_selection(rng, kp, k)
    raw = np.where(mask_ind[..., None], mask_row[None, None], raw)  # re-masked
    ke, ve = jax_hoist_cross_kv(jnp.asarray(enc), layer["jw"])
    ref = fused_nar_decoder_layer_qsub(
        jnp.asarray(sel), jnp.asarray(mask_row), jnp.asarray(raw),
        jnp.asarray(static), None, jnp.asarray(kp), layer["jw"],
        jnp.asarray(layer["lns"]), jnp.asarray(layer["lnb"]), n_head=2, tb=4,
        interpret=True, ln_eps=1e-5, out_dtype=jnp.float32, enc_kv=(ke, ve))
    bf = torch.bfloat16
    args = (_t(raw).to(bf), _t(static).to(bf), _t(kp),
            _t(ke.astype(jnp.float32)).to(bf), _t(ve.astype(jnp.float32)).to(bf),
            layer["tw"], _t(layer["lns"]), _t(layer["lnb"]))
    out = fused_layer_qsub(_t(qidx), _t(mask_row).to(bf), *args, n_head=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=HID_ATOL)
    unused = qidx < 0
    assert unused.any() and np.all(out.numpy()[unused] == 0.0)

    # K2's rows are K1's rows at the selected positions
    dense = fused_layer(*args, n_head=2).numpy()
    rows = np.take_along_axis(dense, np.maximum(qidx, 0)[..., None], axis=1)
    np.testing.assert_allclose(out.numpy()[~unused], rows[~unused], atol=1e-6)


def _margin_ok(h, w, bias):
    """Rows whose top-2 logit margin is above 1e-3 (ties may flip there)."""
    logits = h.astype(np.float64) @ w.astype(np.float64).T
    if bias is not None:
        logits = logits + bias
    top2 = np.sort(logits, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > 1e-3


@pytest.mark.parametrize("v,tv,with_bias", [
    (50, 10240, False), (50, 10240, True), (1001, 256, False), (1001, 256, True)],
    ids=["v50", "v50-bias", "v1001-ragged", "v1001-ragged-bias"])
def test_project_argmax_and_gather_plain_match_pallas(v, tv, with_bias):
    rng = np.random.RandomState(v + with_bias)
    r, d = 70, 32
    h = _bf16_np(rng, r, d)
    w = _bf16_np(rng, v, d, scale=0.3)
    bias = (rng.randn(v) * 0.5).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    ids_j, maxp_j = fused_project_argmax(jnp.asarray(h), jnp.asarray(w.T), jb,
                                         tn=32, tv=tv, interpret=True)
    bf = torch.bfloat16
    tb = None if bias is None else _t(bias)
    ids, maxp = project_argmax(_t(h).to(bf), _t(w).to(bf), tb)
    ok = _margin_ok(h, w, bias)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(ids.numpy()[ok], np.asarray(ids_j)[ok])
    np.testing.assert_allclose(maxp.numpy(), np.asarray(maxp_j), rtol=1e-4)

    targets = rng.randint(0, v, r).astype(np.int32)
    prob_j = fused_project_gather_prob(jnp.asarray(h), jnp.asarray(w.T),
                                       jnp.asarray(targets), jb, tn=32, tv=tv,
                                       interpret=True)
    prob = project_gather_prob(_t(h).to(bf), _t(w).to(bf), _t(targets), tb)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_j), rtol=1e-4,
                               atol=1e-30)


def test_project_argmax_ties_go_to_the_lowest_id():
    h = torch.ones(3, 16, dtype=torch.bfloat16)
    w = torch.zeros(40, 16, dtype=torch.bfloat16)
    w[[7, 9, 30]] = 1.0
    ids, maxp = project_argmax(h, w)
    assert ids.tolist() == [7, 7, 7]
    ids_j, _ = fused_project_argmax(jnp.ones((3, 16)), jnp.asarray(w.float().numpy().T),
                                    interpret=True)
    assert np.asarray(ids_j).tolist() == [7, 7, 7]


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused; the
    plain version runs for CPU tensors only, and the launch counts stay."""
    _build.reset_launches()
    h = torch.empty(4, 16, dtype=torch.bfloat16, device="meta")
    w = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        project_argmax(h, w)
    with pytest.raises(ValueError, match="CUDA"):
        project_gather_prob(h, w, torch.empty(4, dtype=torch.int32, device="meta"))
    project_argmax(torch.ones(2, 16, dtype=torch.bfloat16),
                   torch.ones(5, 16, dtype=torch.bfloat16))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_build_hash_follows_sources(tmp_path, monkeypatch):
    """The library name is keyed by the sources: a changed source builds
    anew (checked here without a compiler)."""
    a = _build.library_path("vocab_fused")
    assert a.startswith(_build.BUILD_DIR) and a.endswith(".so")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    headers = [os.path.basename(h) for h in glob.glob(os.path.join(_build.CSRC, "*.cuh"))]
    for name in ["vocab_fused.cu"] + headers:  # the hash covers every header
        (csrc / name).write_text(open(os.path.join(_build.CSRC, name)).read())
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert _build.library_path("vocab_fused") == a
    (csrc / "common.cuh").write_text("// changed\n")
    assert _build.library_path("vocab_fused") != a
