"""``cfg.remat`` in the port's training step, on the CPU.

navc_tpu wraps its training forward in ``jax.checkpoint``; the port runs it
under ``torch.utils.checkpoint`` (non-reentrant) and again in the backward.

  * remat on equals remat off BIT FOR BIT over two steps — losses, every
    gradient, every parameter and BatchNorm running statistic — at p = 0
    and at p = 0.1 (the recompute must draw the forward's dropout masks and
    leave the running statistics where the forward put them), on the fused
    route (``use_pallas``: K11 / K9's plain versions) and the module route,
    for the eager step and the ``jit=True`` step (eager too on the CPU);
  * at p = 0 the remat step matches navc_tpu's remat step with
    tests/test_torch_port_train.py's tolerances (metrics 1e-4, gradients
    and parameters 1e-5);
  * the recompute runs: on the fused route the forward's K11 and K9 plain
    versions are called twice a decoder pass.
"""

import numpy as np
import pytest
import torch

from navc_tpu_torch.config import default_config
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops import fused_layer_train, vocab_ce
from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step
from test_torch_port_train import (METRIC_TOL, NO_DROPOUT, PARAM_TOL, TOY, assert_trees_close,
                                   configs, jax_one_step, make_batch, port_one_step)


def run(cfg, jit, steps=2):
    """(losses, gradients, state) after ``steps`` steps from seeded weights
    and a seeded CPU generator."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                        train=True)
    step = make_train_step(cfg, model, create_train_state(cfg, model).optimizer, jit=jit)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(make_batch(cfg, seed=i), gen)["total_loss"]) for i in range(steps)]
    return (losses, {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: t.clone() for k, t in model.state_dict().items()})


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "modules"])
@pytest.mark.parametrize("method", ["NACF", "ARB"])
def test_remat_is_bit_exact(method, pallas, p, jit):
    base = default_config(method, dataset="MSVD", **dict(
        TOY, use_pallas=pallas, hidden_dropout_prob=p, encoder_dropout=p))
    off = run(base, jit)
    on = run(base.replace(remat=True), jit)
    assert on[0] == off[0], (on[0], off[0])
    for i in (1, 2):
        assert set(on[i]) == set(off[i])
        bad = [k for k in off[i] if not torch.equal(on[i][k], off[i][k])]
        assert not bad, bad


def test_remat_recomputes_the_forward(monkeypatch):
    """NACF on the fused route: each decoder pass calls K11's and K9's
    forward twice (the forward, then the recompute in the backward)."""
    calls = []
    for mod, name in ((fused_layer_train, "train_fwd"), (vocab_ce, "vocab_ce_fwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    cfg = default_config("NACF", dataset="MSVD", **dict(TOY, use_pallas=True, remat=True))
    run(cfg, jit=False, steps=1)
    assert sorted(calls) == ["train_fwd"] * 4 + ["vocab_ce_fwd"] * 4


@pytest.mark.parametrize("pallas", [True, False], ids=["fused", "modules"])
@pytest.mark.parametrize("method", ["NACF", "ARB2"])
def test_remat_step_matches_navc_tpu(method, pallas, monkeypatch):
    monkeypatch.delenv("NAVC_NO_FUSED_TRAIN", raising=False)
    monkeypatch.delenv("NAVC_NO_FUSED_CE", raising=False)
    jcfg, cfg = (c.replace(remat=True) for c in
                 configs(method, use_pallas=pallas, **NO_DROPOUT))
    batch = make_batch(cfg)
    batch["valid_mask"] = np.array([1, 1, 0, 1], np.float32)
    want_vars, want_grads, want_metrics = jax_one_step(jcfg, batch)
    got_vars, got_grads, got_metrics = port_one_step(cfg, jcfg, batch, monkeypatch)
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], err_msg=k, **METRIC_TOL)
    assert_trees_close(got_grads, want_grads, PARAM_TOL, "grads")
    assert_trees_close(got_vars["params"], want_vars["params"], PARAM_TOL, "params")
    assert_trees_close(got_vars["batch_stats"], want_vars["batch_stats"], PARAM_TOL,
                       "batch_stats")
