"""The port's ARB beam search, its kernels' plain versions and .ckpt loading
vs navc_tpu, on the CPU.

Same seeded numpy inputs, same flax weights (bridged by
navc_tpu_torch.convert):

  * K5-K8 plain versions against the Pallas kernels in interpret mode, at
    tests/test_pallas_ops.py's shapes: the permute and the cache writes
    exactly, attention rtol=atol=2e-5, top-k log-probs rtol=atol=1e-5 with
    ids equal wherever the top-2 margin is above 1e-3, and the lowest-id tie
    order exactly;
  * the plain route (use_pallas=False, float32): tokens IDENTICAL and
    scores within 1e-6 (relative or absolute: the two packages' matmuls sum
    in another order), over the beam knobs and the full-prefix route;
  * the port's cached step against its own full-prefix route;
  * the kernel route (use_pallas=True, bf16): the port's wrappers run their
    plain versions on CPU tensors, navc_tpu its kernels in interpret mode
    with the device-only gates opened in a process of its own; tokens must
    agree on at least 99% of positions (the observed value is in the
    message);
  * StreamingCaptioner serves ARB in submission order;
  * a navc_tpu .ckpt loads into the port without JAX and decodes to the
    same float32 tokens.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.decoding import make_ar_generator as jax_make_ar_generator
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.ops import beam_attend as jax_beam_attend
from navc_tpu.ops import beam_permute as jax_beam_permute
from navc_tpu.ops import vocab_fused as jax_vocab_fused
from navc_tpu.runtime.checkpoint import save_checkpoint
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.decoding import make_ar_generator
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops.beam_attend import beam_attend_step, cross_attend
from navc_tpu_torch.ops.beam_permute import permute_beam_caches
from navc_tpu_torch.ops.vocab_fused import project_topk
from navc_tpu_torch.runtime.checkpoint import load_model_and_config
from navc_tpu_torch.runtime.serving import StreamingCaptioner

TOY = dict(vocab_size=50, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10,
           modality="mi")
WIDE = dict(TOY, dim_hidden=128)  # h % 128 == 0: navc_tpu's K6 gate
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a, dtype=None):
    """numpy / jax array -> torch tensor (float32 through numpy, then
    ``dtype``), never sharing memory with the source."""
    arr = np.asarray(a)
    if arr.dtype == jnp.bfloat16:
        arr = arr.astype(np.float32)
    out = torch.from_numpy(np.array(arr))
    return out if dtype is None else out.to(dtype)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# K8, K6, K7, K5: plain versions vs interpret-mode Pallas
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,k", [(16, 5), (32, 3)])
def test_permute_matches_interpret_pallas(b, k, dtype):
    jdt, tdt = DTYPES[dtype]
    max_len, nh, dh = 6, 2, 64
    rng = np.random.RandomState(3)
    kc = jnp.asarray(rng.randn(b * k, max_len, nh, dh)).astype(jdt)
    vc = jnp.asarray(rng.randn(b * k, max_len, nh, dh)).astype(jdt)
    prev_k = rng.randint(0, k, (b, k)).astype(np.int32)
    rk, rv = jax_beam_permute.permute_beam_caches(kc, vc, jnp.asarray(prev_k),
                                                  k, interpret=True)
    ok, ov = permute_beam_caches(_t(kc, tdt), _t(vc, tdt), _t(prev_k))
    np.testing.assert_array_equal(_f32(ok.float()), _f32(rk))
    np.testing.assert_array_equal(_f32(ov.float()), _f32(rv))


def _attend_inputs(rng, b, k, l, h, tpos, jdt):
    n = b * k
    kc = jnp.asarray(rng.randn(n, l * h)).astype(jdt)
    vc = jnp.asarray(rng.randn(n, l * h)).astype(jdt)
    q, kt, vt = (rng.randn(n, h).astype(np.float32) for _ in range(3))
    mask = rng.rand(n, l) < 0.2
    mask[:, 0] = False
    mask[:, tpos] = False
    mask |= np.arange(l)[None, :] > tpos
    amask = np.where(mask, -1e7, 0.0).astype(np.float32)
    return kc, vc, q, kt, vt, amask


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tpos", [0, 3, 5])
@pytest.mark.parametrize("b,k", [(16, 5), (32, 3)])
def test_beam_attend_step_matches_interpret_pallas(b, k, tpos, dtype):
    jdt, tdt = DTYPES[dtype]
    l, nh = 6, 2
    h = 128
    rng = np.random.RandomState(4 + tpos)
    kc, vc, q, kt, vt, amask = _attend_inputs(rng, b, k, l, h, tpos, jdt)
    prev_k = rng.randint(0, k, (b, k)).astype(np.int32)
    rkc, rvc, ratt = jax_beam_attend.beam_attend_step(
        kc, vc, jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
        jnp.asarray(prev_k), jnp.asarray(amask), tpos, k=k, nh=nh, l=l,
        interpret=True)
    okc, ovc, att = beam_attend_step(
        _t(kc, tdt), _t(vc, tdt), _t(q), _t(kt), _t(vt), _t(prev_k),
        _t(amask), tpos, nh)
    lim = (tpos + 1) * h  # later positions are unspecified
    np.testing.assert_array_equal(_f32(okc.float())[:, :lim], _f32(rkc)[:, :lim])
    np.testing.assert_array_equal(_f32(ovc.float())[:, :lim], _f32(rvc)[:, :lim])
    np.testing.assert_allclose(att.numpy(), _f32(ratt), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_beam_attend_step_chained_matches_interpret_pallas(dtype):
    """Steps chained through the in-place caches, as the decode loop does."""
    jdt, tdt = DTYPES[dtype]
    b, k, l, nh, h = 16, 5, 8, 4, 128
    n = b * k
    rng = np.random.RandomState(11)
    jkc = jnp.zeros((n, l * h), jdt)
    jvc = jnp.zeros((n, l * h), jdt)
    tkc = torch.zeros((n, l * h), dtype=tdt)
    tvc = torch.zeros((n, l * h), dtype=tdt)
    for t in range(l - 2):
        q, kt, vt = (rng.randn(n, h).astype(np.float32) for _ in range(3))
        pk = (rng.randint(0, k, (b, k)) if t else np.zeros((b, k))).astype(np.int32)
        amask = np.broadcast_to(np.where(np.arange(l)[None, :] > t, -1e7, 0.0),
                                (n, l)).astype(np.float32)
        jkc, jvc, ratt = jax_beam_attend.beam_attend_step(
            jkc, jvc, jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
            jnp.asarray(pk), jnp.asarray(amask), t, k=k, nh=nh, l=l,
            interpret=True)
        tkc, tvc, att = beam_attend_step(tkc, tvc, _t(q), _t(kt), _t(vt),
                                         _t(pk), _t(amask), t, nh)
        lim = (t + 1) * h
        np.testing.assert_array_equal(_f32(tkc.float())[:, :lim], _f32(jkc)[:, :lim])
        np.testing.assert_array_equal(_f32(tvc.float())[:, :lim], _f32(jvc)[:, :lim])
        np.testing.assert_allclose(att.numpy(), _f32(ratt), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,k", [(16, 5), (32, 3)])
def test_cross_attend_matches_interpret_pallas(b, k, dtype):
    jdt, tdt = DTYPES[dtype]
    le, nh, h = 4, 2, 128
    n = b * k
    rng = np.random.RandomState(9)
    q = rng.randn(n, h).astype(np.float32)
    ke = jnp.asarray(rng.randn(b, le, h).astype(np.float32)).astype(jdt)
    ve = jnp.asarray(rng.randn(b, le, h).astype(np.float32)).astype(jdt)
    ref = jax_beam_attend.cross_attend(
        jnp.asarray(q), jnp.repeat(ke.reshape(b, le * h), k, axis=0),
        jnp.repeat(ve.reshape(b, le * h), k, axis=0), nh=nh, interpret=True)
    out = cross_attend(_t(q), _t(ke, tdt), _t(ve, tdt), nh)
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,v,k,with_bias", [
    (100, 1000, 5, True), (260, 2100, 3, True), (37, 700, 8, False),
    (16, 130, 1, False)])
def test_project_topk_matches_interpret_pallas(n, v, k, with_bias):
    rng = np.random.RandomState(7 + k)
    h = rng.randn(n, 64).astype(np.float32)
    w = (rng.randn(64, v) * 0.1).astype(np.float32)
    bias = (rng.randn(v) * 0.05).astype(np.float32) if with_bias else None
    rlp, rids = jax_vocab_fused.fused_project_topk(
        jnp.asarray(h), jnp.asarray(w), k,
        bias=None if bias is None else jnp.asarray(bias), tn=128, tv=512,
        interpret=True)
    lp, ids = project_topk(_t(h, torch.bfloat16), _t(w.T, torch.bfloat16), k,
                           None if bias is None else _t(bias))
    assert lp.dtype == torch.float32 and ids.dtype == torch.int32
    assert tuple(lp.shape) == tuple(ids.shape) == (n, k)
    scores = (_f32(jnp.asarray(h).astype(jnp.bfloat16))
              @ _f32(jnp.asarray(w).astype(jnp.bfloat16))
              + (0.0 if bias is None else bias))
    srt = -np.sort(-scores, axis=1)[:, :k + 1]
    # ids are compared where the gap to the next candidate is clear
    clear = np.diff(-srt, axis=1) > 1e-3
    ids, rids = ids.numpy(), np.asarray(rids)
    np.testing.assert_array_equal(ids[clear], rids[clear])
    np.testing.assert_allclose(lp.numpy(), _f32(rlp), rtol=1e-5, atol=1e-5)


def test_project_topk_tie_order_is_lowest_id_first():
    """Integer-valued operands make every logit exact in any sum order, so
    the ties are real; both packages list equal values by ascending id,
    across the JAX kernel's vocab tiles."""
    rng = np.random.RandomState(5)
    n, d, v, k = 24, 16, 1200, 8
    h = rng.randint(-1, 2, (n, d)).astype(np.float32)
    w = rng.randint(-1, 2, (d, v)).astype(np.float32)
    w[:, 700:] = w[:, :500]  # exact duplicates across tiles
    rlp, rids = jax_vocab_fused.fused_project_topk(
        jnp.asarray(h), jnp.asarray(w), k, tn=128, tv=512, interpret=True)
    lp, ids = project_topk(_t(h, torch.bfloat16), _t(w.T, torch.bfloat16), k)
    logits = h @ w
    order = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(ids.numpy(), order)
    np.testing.assert_allclose(lp.numpy(), _f32(rlp), rtol=1e-5, atol=1e-5)
    assert (np.diff(logits[np.arange(n)[:, None], order], axis=1) == 0).any()


# ---------------------------------------------------------------------------
# the decode: plain route, cached vs full prefix, kernel route, serving
# ---------------------------------------------------------------------------

_VARIABLES = {}


def _models(seed=1, **kw):
    over = dict(TOY, **kw)
    jcfg = jax_default_config("ARB", dataset="MSRVTT", **over)
    cfg = default_config("ARB", dataset="MSRVTT", **over)
    jmodel = jax_build_model(jcfg)
    # the weights depend on the widths, the layer count and the tying only
    key = (seed, cfg.dim_hidden, cfg.num_attention_heads,
           cfg.num_hidden_layers_decoder, cfg.tie_weights)
    if key not in _VARIABLES:
        _VARIABLES[key] = jax.tree_util.tree_map(
            np.asarray, init_params(jmodel, jax.random.PRNGKey(seed), jcfg))
    variables = _VARIABLES[key]
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    return jcfg, jmodel, variables, cfg, model


def _request(cfg, b, seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, cfg.n_frames, d).astype(np.float32)
             for d in cfg.modality_dims]
    return feats, rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32)


def _decode_both(models, feats, cat, jit=True):
    jcfg, jmodel, jvars, cfg, model = models
    enc_j = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
    ref_hyp, ref_sc = jax_make_ar_generator(jcfg, jmodel, jit=jit)(
        jvars, enc_j, jnp.asarray(cat))
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    hyp, sc = make_ar_generator(cfg, model)(enc, torch.from_numpy(cat))
    return hyp.numpy(), sc.numpy(), np.asarray(ref_hyp), np.asarray(ref_sc)


@pytest.mark.parametrize("kw", [
    {}, dict(beam_size=3, beam_alpha=1.35), dict(topk=2),
    dict(tie_weights=True), dict(num_hidden_layers_decoder=2)],
    ids=["default", "beam3-alpha1.35", "topk2", "tied", "two-layers-full-prefix"])
def test_plain_route_f32_tokens_identical(kw):
    models = _models(compute_dtype="float32", **kw)
    feats, cat = _request(models[3], 6, seed=3)
    hyp, sc, ref_hyp, ref_sc = _decode_both(models, feats, cat)
    assert hyp.dtype == np.int32 and hyp.shape == ref_hyp.shape
    np.testing.assert_array_equal(hyp, ref_hyp)
    np.testing.assert_allclose(sc, ref_sc, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cached_step_matches_full_prefix(compute_dtype, monkeypatch):
    """The KV-cached step gives the tokens of the full-prefix forward, as
    in navc_tpu (tests/test_decoding_parity.py)."""
    *_, cfg, model = _models(compute_dtype=compute_dtype, beam_size=3,
                             beam_alpha=1.15)
    feats, cat = _request(cfg, 3, seed=11)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    cat = torch.from_numpy(cat)
    hyp_c, sc_c = make_ar_generator(cfg, model)(enc, cat)
    import navc_tpu_torch.decoding.beam as beam
    monkeypatch.setattr(beam, "kv_cached_beam_eligible", lambda c: False)
    hyp_f, sc_f = make_ar_generator(cfg, model)(enc, cat)
    np.testing.assert_array_equal(hyp_c.numpy(), hyp_f.numpy())
    np.testing.assert_allclose(sc_c.numpy(), sc_f.numpy(), rtol=1e-6, atol=1e-6)


KERNEL_ROUTE_BATCHES = (16, 12)


def write_jax_kernel_route(path):
    """navc_tpu's kernel-route hypotheses for KERNEL_ROUTE_BATCHES, saved to
    ``path`` (.npz). Runs in a process of its own (``jax_kernel_route``):
    the device-only kernel gates are opened by replacing
    ``jax.default_backend`` and the kernels run in interpret mode, and XLA
    must run with --xla_allow_excess_precision=false — by default its CPU
    backend drops the bf16 rounding of the cached step's dense outputs
    inside a fused computation, which navc_tpu's step (and the port)
    round as flax Dense(dtype=bf16) does."""
    jax.default_backend = lambda: "tpu"
    for mod, name in ((jax_beam_attend, "beam_attend_step"),
                      (jax_beam_attend, "cross_attend"),
                      (jax_vocab_fused, "fused_project_topk"),
                      (jax_beam_permute, "permute_beam_caches")):
        setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    jcfg, jmodel, jvars, cfg, _ = _models(use_pallas=True, **WIDE)
    out = {}
    for b in KERNEL_ROUTE_BATCHES:
        feats, cat = _request(cfg, b, seed=5)
        enc = jmodel.apply(jvars, feats, method=lambda m, f: m.encode(f))
        hyp, _ = jax_make_ar_generator(jcfg, jmodel, jit=False)(
            jvars, enc, jnp.asarray(cat))
        out["b%d" % b] = np.asarray(hyp)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_kernel_route(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kernel_route") / "ref.npz")
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import test_torch_port_beam as t\n"
            "t.write_jax_kernel_route(sys.argv[1])\n" % os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("b", KERNEL_ROUTE_BATCHES, ids=["b16-K6", "b12-K8"])
def test_kernel_route_agrees_with_interpret_pallas(b, jax_kernel_route):
    """b=16: both packages take the fused attention step (K6) with K5 and
    K7. b=12: the port permutes with K8 and attends in plain PyTorch,
    navc_tpu permutes with take_along_axis; the permute is exact either
    way."""
    *_, cfg, model = _models(use_pallas=True, **WIDE)
    feats, cat = _request(cfg, b, seed=5)
    with torch.no_grad():
        enc = model.encode([torch.from_numpy(f) for f in feats])
    hyp, _ = make_ar_generator(cfg, model)(enc, torch.from_numpy(cat))
    ref = jax_kernel_route["b%d" % b]
    assert hyp.shape == ref.shape
    agree = float((hyp.numpy() == ref).mean())
    assert agree >= 0.99, "token agreement %.4f" % agree


def test_streaming_captioner_serves_arb_in_order():
    *_, cfg, model = _models(use_pallas=True, **WIDE)
    reqs = [_request(cfg, b, seed=9 + i) for i, b in enumerate((16, 12, 16))]
    gen = make_ar_generator(cfg, model)
    direct = []
    for feats, cat in reqs:
        with torch.no_grad():
            enc = model.encode([torch.from_numpy(f) for f in feats])
        direct.append(gen(enc, torch.from_numpy(cat))[0].numpy())
    for depth in (0, 2):
        cap = StreamingCaptioner(cfg, model, depth=depth, device="cpu")
        tickets, done = [], []
        for feats, cat in reqs:
            t, d = cap.submit(feats, cat)
            tickets.append(t)
            done.extend(d)
            assert len(cap._inflight) <= depth
        done.extend(cap.flush())
        assert [t for t, _ in done] == tickets
        for (_, hyp), ref in zip(done, direct):
            assert hyp.shape == (ref.shape[0], cfg.max_len - 1)
            np.testing.assert_array_equal(hyp, ref)
        assert cap.generate.steps_run > 0


def test_navc_tpu_checkpoint_loads_and_decodes_alike(tmp_path):
    jcfg, jmodel, jvars, cfg, _ = _models(compute_dtype="float32")
    params = jvars["params"]
    path = save_checkpoint({"params": params,
                            "batch_stats": jvars.get("batch_stats", {}),
                            "opt_state": optax.adam(1e-3).init(params),
                            "settings": jcfg, "epoch": 3},
                           str(tmp_path), "best.ckpt")
    model, lcfg, other = load_model_and_config(path, device="cpu")
    assert lcfg == cfg and other["epoch"] == 3
    feats, cat = _request(cfg, 4, seed=13)
    hyp, sc, ref_hyp, ref_sc = _decode_both(
        (jcfg, jmodel, jvars, lcfg, model), feats, cat)
    np.testing.assert_array_equal(hyp, ref_hyp)
    np.testing.assert_allclose(sc, ref_sc, rtol=1e-6, atol=1e-6)
    # reading the file needs nothing of JAX, flax or optax
    code = ("import sys\n"
            "from navc_tpu_torch.runtime.checkpoint import load_model_and_config\n"
            "model, cfg, other = load_model_and_config(sys.argv[1], device='cpu')\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax', 'optax', 'navc_tpu'))\n"
            "assert not bad, bad\n"
            "print('OK', cfg.method, other['epoch'])\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("OK ARB 3"), out.stderr

