"""The port's training step against navc_tpu's, on the CPU.

One train step from the same flax weights on the same seeded numpy batch,
one of whose rows the valid_mask drops: navc_tpu's jitted
``make_train_step`` and the port's ``make_train_step`` (with
``device="cpu"`` the fused layer runs its plain versions). All dropout
probabilities are 0 and the compute dtype float32, so the two steps do the
same arithmetic up to summation order. With ``use_pallas=True`` both take
the fused projection + cross-entropy route (K9/K10: navc_tpu's Pallas
kernels in interpret mode, the port's plain versions), tied and untied.
Tolerances: metrics atol = rtol = 1e-4; every parameter's gradient (before
the clip), and every updated parameter and BatchNorm running statistic,
read back through ``export_flax_variables``, atol = rtol = 1e-5. The
gradients are what the check rests on: Adam's first update is lr times
the gradient's sign, so the updated parameters alone would not see a
gradient of the wrong size.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from navc_tpu import constants as NC
from navc_tpu.config import default_config as jax_default_config
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu.ops.eligibility import fused_vocab_ce_eligible as jax_ce_eligible
from navc_tpu.runtime.train_step import create_train_state as jax_create_state
from navc_tpu.runtime.train_step import make_train_step as jax_make_step
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import export_flax_variables, load_flax_variables
from navc_tpu_torch.models import build_model
from navc_tpu_torch.ops.vocab_ce import vocab_ce_train
from navc_tpu_torch.runtime import optim, train_step
from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

TOY = dict(vocab_size=40, dim_hidden=16, num_attention_heads=2,
           intermediate_size=32, n_frames=4, dim_i=12, dim_m=10, modality="mi",
           max_len=10, batch_size=4, compute_dtype="float32")
NO_DROPOUT = dict(hidden_dropout_prob=0.0, encoder_dropout=0.0)
METRIC_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)


def configs(method, **kw):
    over = dict(TOY, **kw)
    jcfg = jax_default_config(method, dataset="MSVD", **over)
    cfg = default_config(method, dataset="MSVD", **over)
    assert cfg.to_dict() == jcfg.to_dict()
    return jcfg, cfg


def make_batch(cfg, seed=0):
    """A synthetic numpy batch shaped as bench.py builds its train batch."""
    rng = np.random.RandomState(seed)
    b = cfg.batch_size
    tokens = np.full((b, cfg.max_len), NC.PAD, np.int32)
    labels = np.full((b, cfg.max_len), NC.PAD, np.int32)
    for i in range(b):
        n = rng.randint(5, cfg.max_len)
        tokens[i, :n] = rng.randint(6, cfg.vocab_size, size=n)
        tokens[i, :n // 2] = NC.MASK
        labels[i, :n] = rng.randint(6, cfg.vocab_size, size=n)
    lt = rng.rand(b, cfg.max_len).astype(np.float32)
    lt /= lt.sum(-1, keepdims=True)
    batch = {
        "tokens": tokens, "labels": labels,
        "tokens_1": np.full((b, cfg.max_len), NC.VIS, np.int32),
        "labels_1": np.where(rng.rand(b, cfg.max_len) < 0.3, NC.MASK,
                             labels).astype(np.int32),
        "length_target": lt,
        "category": rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32),
    }
    for ch in cfg.modality.lower():
        batch["feats_%s" % ch] = rng.randn(
            b, cfg.n_frames, getattr(cfg, "dim_%s" % ch)).astype(np.float32)
    return batch


def flax_variables(jcfg, seed=0):
    jmodel = jax_build_model(jcfg)
    variables = init_params(jmodel, jax.random.PRNGKey(seed), jcfg)
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def keep_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_one_step(jcfg, batch, seed=0):
    """navc_tpu: (variables after one step, the step's gradients, all as
    numpy; metrics as floats)."""
    jmodel, variables = flax_variables(jcfg, seed)
    state, tx = jax_create_state(jcfg, jmodel, variables)
    tx = optax.chain(keep_grads(), tx)
    state = state._replace(opt_state=tx.init(state.params))
    step = jax_make_step(jcfg, jmodel, tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, metrics = step(state, jbatch, jax.random.PRNGKey(7))
    out = {"params": state.params, "batch_stats": state.batch_stats}
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, state.opt_state[0]),
            {k: float(v) for k, v in metrics.items()})


def port_model(cfg, jcfg, seed=0):
    return load_flax_variables(build_model(cfg, device="cpu", train=True),
                               flax_variables(jcfg, seed)[1])


def port_one_step(cfg, jcfg, batch, monkeypatch, seed=0):
    """The port: (variables after one step, the step's gradients before the
    clip, in navc_tpu's layout; metrics as floats)."""
    model = port_model(cfg, jcfg, seed)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    grads = copy.deepcopy(model)
    optimizer_step = optim.step

    def keep_grads_then_step(cfg, opt):
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads.parameters()):
                g.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        optimizer_step(cfg, opt)

    monkeypatch.setattr(optim, "step", keep_grads_then_step)
    metrics = step(batch, torch.Generator().manual_seed(0))
    return (export_flax_variables(model), export_flax_variables(grads)["params"],
            {k: float(v) for k, v in metrics.items()})


def assert_trees_close(got, want, tol, where=""):
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], tol, where + "/" + k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=where + "/" + k, **tol)


def check_step(method, monkeypatch, **kw):
    jcfg, cfg = configs(method, **NO_DROPOUT, **kw)
    batch = make_batch(cfg)
    batch["valid_mask"] = np.array([1, 1, 0, 1], np.float32)
    # with use_pallas both sides take the fused CE route (navc_tpu by its own
    # rule, the port through vocab_ce_train once per decoder pass); without
    # it, both take the logits route
    monkeypatch.delenv("NAVC_NO_FUSED_CE", raising=False)
    assert jax_ce_eligible(jcfg) == cfg.use_pallas
    ce_calls = []
    monkeypatch.setattr(train_step, "vocab_ce_train",
                        lambda *a, **k: ce_calls.append(1) or vocab_ce_train(*a, **k))
    want_vars, want_grads, want_metrics = jax_one_step(jcfg, batch)
    got_vars, got_grads, got_metrics = port_one_step(cfg, jcfg, batch, monkeypatch)
    passes = 2 if cfg.visual_word_generation else 1
    assert len(ce_calls) == (passes if cfg.use_pallas else 0)
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], err_msg=k,
                                   **METRIC_TOL)
    assert_trees_close(got_grads, want_grads, PARAM_TOL, "grads")
    assert_trees_close(got_vars["params"], want_vars["params"], PARAM_TOL, "params")
    assert_trees_close(got_vars["batch_stats"], want_vars["batch_stats"],
                       PARAM_TOL, "batch_stats")


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("method", ["NACF", "ARB", "NAB", "ARB2"])
def test_fused_train_step_matches_navc_tpu(method, tie, monkeypatch):
    """use_pallas=True: the fused layer and the fused CE route on both
    sides, with the projection untied (tgt_word_prj) and tied (the word
    table + tgt_word_prj_bias)."""
    check_step(method, monkeypatch, use_pallas=True, tie_weights=tie)

