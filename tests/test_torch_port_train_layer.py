"""The port's training layer (K11, K12a, K12b, the weight-gradient
reduction) as plain versions, against navc_tpu's fused training layer.

The same seeded numpy inputs go through navc_tpu's
``fused_bert_layer_train(..., interpret=True)`` (its Pallas kernels in
interpret mode, tb = 8) with ``jax.vjp``, and through the port's
``fused_bert_layer_train`` on the CPU with ``torch.autograd.grad``. The
dropout masks come from the same counter hash on the same lattice, so
dropout-on runs are exact too. Tolerances:

  * hash bits: equal;
  * float32 compute: atol = rtol = 1e-5 on the output, dx, denc and all 20
    weight gradients (the two sides differ in summation order only);
  * bfloat16 compute: the JAX side runs in a subprocess with
    ``XLA_FLAGS=--xla_allow_excess_precision=false`` (without it XLA's CPU
    backend keeps some bf16 roundings in float32); atol 2e-2 and rtol 2e-2
    on the output and the gradients, scaled to each tensor's largest
    magnitude: one product's operand rounding that flips with summation
    order moves a value by one bf16 ulp (2^-8 relative), which the next
    products spread. The key-bias gradients (dbk_s, dbk_c) are zero in
    exact arithmetic — a key bias shifts every score of a query row alike —
    so both sides hold rounding noise there; they are held to the scale of
    the query-bias gradient of the same attention.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.ops.fused_layer_train import _hash24 as jax_hash24
from navc_tpu.ops.fused_layer_train import \
    fused_bert_layer_train as jax_layer_train
from navc_tpu_torch.ops import fused_layer_train as FT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
H, NH, INTER = 32, 4, 48

# (name, n, l, le, causal): N and L off multiples of 8 in the second case
SHAPES = {"nar": (5, 10, 8, False), "causal-ragged": (11, 13, 6, True)}
PROBS = {"p0": (0.0, 0.0), "p05": (0.5, 0.5)}


def _case(n, l, le, seed=0):
    """Seeded numpy inputs: x, enc, kp, JAX-layout weights, dy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, l, H).astype(np.float32)
    enc = rng.randn(n, le, H).astype(np.float32)
    lengths = rng.randint(2, l + 1, n)
    kp = np.arange(l)[None, :] >= lengths[:, None]
    w = {}
    for k in FT.WEIGHT_KEYS:
        if k.startswith("b"):
            dim = INTER if k == "bi" else H
            w[k] = (rng.randn(dim) * 0.1).astype(np.float32)
        else:
            fin, fout = {"wi": (H, INTER), "wo2": (INTER, H)}.get(k, (H, H))
            w[k] = ((rng.rand(fin, fout) * 2 - 1) / np.sqrt(fin)).astype(np.float32)
    dy = rng.randn(n, l, H).astype(np.float32)
    return x, enc, kp, w, dy


def jax_layer_ref(n, l, le, causal, p, p_input, seed, compute="float32"):
    """navc_tpu's forward and (dx, denc, weight grads) as numpy."""
    x, enc, kp, w, dy = _case(n, l, le)
    cdt = jnp.dtype(compute)

    def f(x, enc, w):
        return jax_layer_train(
            x, enc, jnp.asarray(kp), w, jnp.array([seed], jnp.int32),
            n_head=NH, tb=8, causal=causal, p_hidden=p, p_input=p_input,
            compute_dtype=cdt, out_dtype=jnp.float32, interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(enc),
                       {k: jnp.asarray(v) for k, v in w.items()})
    dx, denc, dw = vjp(jnp.asarray(dy))
    return dict(out=np.asarray(out), dx=np.asarray(dx), denc=np.asarray(denc),
                **{"d" + k: np.asarray(v) for k, v in dw.items()})


@functools.lru_cache(maxsize=None)
def _jax_ref(shape, prob):
    n, l, le, causal = SHAPES[shape]
    p, p_in = PROBS[prob]
    return jax_layer_ref(n, l, le, causal, p, p_in, seed=1234567)


def port_layer(n, l, le, causal, p, p_input, seed, compute=torch.float32):
    """The port's forward and gradients, in navc_tpu's weight layout."""
    x, enc, kp, w, dy = _case(n, l, le)
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    wt = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v).requires_grad_()
          for k, v in w.items()}
    out = FT.fused_bert_layer_train(
        xt, et, torch.from_numpy(kp), wt, seed, n_head=NH, causal=causal,
        p_hidden=p, p_input=p_input, compute_dtype=compute,
        out_dtype=torch.float32)
    keys = list(FT.WEIGHT_KEYS)
    grads = torch.autograd.grad(out, [xt, et] + [wt[k] for k in keys],
                                torch.from_numpy(dy))
    res = dict(out=out.detach().numpy(), dx=grads[0].numpy(),
               denc=grads[1].numpy())
    for k, g in zip(keys, grads[2:]):
        res["d" + k] = g.numpy().T if g.dim() == 2 else g.numpy()
    return res


def test_hash_bits_match_navc_tpu():
    for seed in (0, 1, 7, 123, 987654321, 2 ** 31 - 1, -2 ** 31, -5):
        for tile in (0, 3, 250):
            for site in range(5):
                ref = np.asarray(jax_hash24(jnp.int32(seed), jnp.int32(tile),
                                            site, 40, 72))
                got = FT.hash24(seed, tile, site, 40, 72).numpy()
                np.testing.assert_array_equal(got, ref, err_msg=str((seed, tile, site)))


def test_lattice_places_sequences_on_the_jax_tiles():
    """Sequence s, position j sits at row (s % 8) * round_up(L, 8) + j of
    tile s // 8."""
    n, l = 19, 13
    bits = FT.lattice_bits(99, FT.SITE_FFN_DOWN, n, l, 24)
    for s in (0, 7, 8, 18):
        tile = FT.hash24(99, s // 8, FT.SITE_FFN_DOWN, 8 * 16, 24)
        np.testing.assert_array_equal(
            bits[s].numpy(), tile[(s % 8) * 16:(s % 8) * 16 + l].numpy())


@pytest.mark.parametrize("prob", list(PROBS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_matches_navc_tpu_f32(shape, prob):
    n, l, le, causal = SHAPES[shape]
    p, p_in = PROBS[prob]
    ref = _jax_ref(shape, prob)
    got = port_layer(n, l, le, causal, p, p_in, seed=1234567)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_plain_backward_is_autograd_of_plain_forward(p):
    """f32: the hand-written backward equals torch.autograd.grad of the
    plain forward (p = p_input, the same masks in both)."""
    x, enc, kp, w, dy = _case(6, 9, 5)
    xt = torch.from_numpy(x).requires_grad_()
    et = torch.from_numpy(enc).requires_grad_()
    wt = {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v).requires_grad_()
          for k, v in w.items()}
    inputs = [xt, et] + [wt[k] for k in FT.WEIGHT_KEYS]
    kpt, dyt = torch.from_numpy(kp), torch.from_numpy(dy)
    out, _ = FT.train_fwd_plain(xt, et, kpt, wt, 31, n_head=NH, causal=True, p=p,
                                p_input=p, compute_dtype=torch.float32)
    want = torch.autograd.grad(out, inputs, dyt)
    out2 = FT.fused_bert_layer_train(xt, et, kpt, wt, 31, n_head=NH, causal=True,
                                     p_hidden=p, p_input=p,
                                     compute_dtype=torch.float32)
    np.testing.assert_array_equal(out2.detach().numpy(), out.detach().numpy())
    got = torch.autograd.grad(out2, inputs, dyt)
    for name, a, b in zip(["x", "enc"] + list(FT.WEIGHT_KEYS), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


def test_dropout_keeps_1_minus_p_and_differs_by_seed():
    bits = FT.lattice_bits(5, FT.SITE_INPUT, 64, 30, 512)
    frac = float((bits >= int(round(0.5 * (1 << 24)))).float().mean())
    assert abs(frac - 0.5) < 0.005
    v = torch.ones(3, 7, 16)
    a = FT.dropmul(v, 1, FT.SITE_SELF_OUT, 0.5)
    assert torch.equal(a, FT.dropmul(v, 1, FT.SITE_SELF_OUT, 0.5))
    assert not torch.equal(a, FT.dropmul(v, 2, FT.SITE_SELF_OUT, 0.5))
    assert set(a.unique().tolist()) <= {0.0, 2.0}


BF16_TOL = 2e-2


def write_jax_bf16_refs(path):
    """navc_tpu's bf16 forward and gradients for both shapes at p = 0.5,
    saved to ``path`` (.npz); run in a process of its own with
    XLA_FLAGS=--xla_allow_excess_precision=false."""
    out = {}
    for shape, (n, l, le, causal) in SHAPES.items():
        ref = jax_layer_ref(n, l, le, causal, 0.5, 0.5, seed=77, compute="bfloat16")
        out.update({"%s/%s" % (shape, k): v for k, v in ref.items()})
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_bf16_refs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_layer") / "ref.npz")
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import test_torch_port_train_layer as t\n"
            "t.write_jax_bf16_refs(sys.argv[1])\n" % os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_matches_navc_tpu_bf16(shape, jax_bf16_refs):
    n, l, le, causal = SHAPES[shape]
    got = port_layer(n, l, le, causal, 0.5, 0.5, seed=77, compute=torch.bfloat16)
    for key, val in got.items():
        ref = jax_bf16_refs["%s/%s" % (shape, key)]
        like = key.replace("dbk_", "dbq_")
        scale = float(np.abs(jax_bf16_refs["%s/%s" % (shape, like)]).max())
        np.testing.assert_allclose(val, ref, atol=BF16_TOL * scale, rtol=BF16_TOL,
                                   err_msg=key)
