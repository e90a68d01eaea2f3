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
