"""The port's losses, optimizer, module-route train step, eval-loss step and
epoch loop against navc_tpu's, on the CPU.

Tolerances: loss metrics atol = rtol = 1e-5 (the same float32 reductions in
another order); optimizer steps 1e-6 (the same update formula); the module
route's step as tests/test_torch_port_train.py (metrics 1e-4, parameters
and running statistics 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import optax

from navc_tpu.config import Config as JaxConfig
from navc_tpu.runtime.crit import compute_losses as jax_compute_losses
from navc_tpu.runtime.optim import LrSchedule as JaxLrSchedule
from navc_tpu.runtime.optim import make_optimizer as jax_make_optimizer
from navc_tpu.runtime.optim import set_learning_rate as jax_set_lr
from navc_tpu.runtime.train_step import make_eval_loss_step as jax_eval_step
from navc_tpu_torch.config import Config
from navc_tpu_torch.ops.eligibility import (fused_train_eligible,
                                            fused_vocab_ce_eligible)
from navc_tpu_torch.runtime import optim
from navc_tpu_torch.runtime.crit import compute_losses
from navc_tpu_torch.runtime.loop import run_train_epoch
from navc_tpu_torch.runtime.train_step import (create_train_state,
                                               make_eval_loss_step,
                                               make_train_step)
from test_torch_port_train import (NO_DROPOUT, check_step, configs,
                                   flax_variables, make_batch, port_model)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("logit_dtype", ["float32", "bfloat16"])
def test_compute_losses_matches_navc_tpu(logit_dtype):
    """NACF's criterion (two weighted passes, MASK-excluding accuracy, the
    length KL) on the same raw logits, with a valid_mask dropping a row."""
    jcfg, cfg = configs("NACF")
    rng = np.random.RandomState(3)
    b, l, v = 4, cfg.max_len, cfg.vocab_size
    logits = [rng.randn(b, l, v).astype(np.float32) * 3 for _ in range(2)]
    labels = [rng.randint(0, v, (b, l)).astype(np.int32) for _ in range(2)]
    labels[0][0, 5:] = 0
    labels[1][2, 3:] = 0
    labels[0][1, :3] = 4  # MASK labels, left out of pass 0's accuracy
    pred = jax.nn.log_softmax(jnp.asarray(rng.randn(b, l).astype(np.float32)))
    tgt = rng.rand(b, l).astype(np.float32)
    tgt[1, 4:] = 0.0
    tgt /= tgt.sum(-1, keepdims=True)
    valid = np.array([1, 1, 0, 1], np.float32)
    jdt = jnp.dtype(logit_dtype)
    tdt = getattr(torch, logit_dtype)
    _, want = jax_compute_losses(jcfg, {
        "tgt_word_logits": [jnp.asarray(x).astype(jdt) for x in logits],
        "tgt_word_labels": [jnp.asarray(x) for x in labels],
        "pred_length": pred, "tgt_length": jnp.asarray(tgt)},
        jnp.asarray(valid))
    _, got = compute_losses(cfg, {
        "tgt_word_logits": [torch.from_numpy(x).to(tdt) for x in logits],
        "tgt_word_labels": [torch.from_numpy(x) for x in labels],
        "pred_length": torch.from_numpy(np.array(pred)),
        "tgt_length": torch.from_numpy(tgt)}, torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_optimizer_steps_match_the_optax_chain(name):
    """Three steps with warmup: value clip, weight decay, a parameter whose
    gradient is zero (None on the torch side), and LrSchedule's lr."""
    kw = dict(learning_rate=1e-3, weight_decay=5e-4, grad_clip=2.0, optim=name,
              n_warmup_steps=2)
    rng = np.random.RandomState(2)
    w0 = rng.randn(6, 4).astype(np.float32)
    z0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(6, 4).astype(np.float32) * 4 for _ in range(3)]

    jcfg = JaxConfig(**kw)
    tx = jax_make_optimizer(jcfg)
    params = {"w": jnp.asarray(w0), "z": jnp.asarray(z0)}
    state = tx.init(params)
    sched = JaxLrSchedule.from_config(jcfg)
    for g in grads:
        jax_set_lr(state, sched.step_lr())
        upd, state = tx.update({"w": jnp.asarray(g), "z": jnp.zeros(5)}, state, params)
        params = optax.apply_updates(params, upd)

    cfg = Config(**kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tz = torch.nn.Parameter(torch.from_numpy(z0.copy()))
    opt = optim.make_optimizer(cfg, [tw, tz])
    tsched = optim.LrSchedule.from_config(cfg)
    for g in grads:
        optim.set_learning_rate(opt, tsched.step_lr())
        opt.zero_grad(set_to_none=True)
        tw.grad = torch.from_numpy(g.copy())
        optim.step(cfg, opt)
    assert tsched.n_current_steps == 3 and opt.param_groups[0]["lr"] == 1e-3
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(params["w"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(params["z"]),
                               atol=1e-6, rtol=1e-6)
    assert not np.allclose(tz.detach().numpy(), z0)  # decayed and updated


@pytest.mark.parametrize("method", ["NACF", "ARB", "NAB", "ARB2"])
def test_module_route_step_matches_navc_tpu(method, monkeypatch):
    """use_pallas=False: every module in train mode on both sides."""
    check_step(method, monkeypatch, use_pallas=False)


def test_eligibility():
    _, cfg = configs("NACF", use_pallas=True)
    assert fused_train_eligible(cfg)
    assert fused_train_eligible(configs("ARB", use_pallas=True)[1])
    assert not fused_train_eligible(cfg.replace(use_pallas=False))
    assert not fused_train_eligible(cfg.replace(num_hidden_layers_decoder=2))
    assert not fused_train_eligible(cfg.replace(attention_probs_dropout_prob=0.1))
    assert not fused_train_eligible(configs("ARB", use_pallas=True, watch=2)[1])
    # navc_tpu's rule without its TPU VMEM residency gate: the kernels'
    # switch, whatever the vocab
    assert fused_vocab_ce_eligible(cfg)
    assert fused_vocab_ce_eligible(cfg.replace(vocab_size=3_000_000))
    assert not fused_vocab_ce_eligible(cfg.replace(use_pallas=False))


def test_eval_loss_step_matches_navc_tpu():
    jcfg, cfg = configs("NACF", use_pallas=True)
    batch = make_batch(cfg, seed=4)
    jmodel, variables = flax_variables(jcfg)
    want = jax_eval_step(jcfg, jmodel)(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_loss_step(cfg, port_model(cfg, jcfg))(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                   atol=1e-4, rtol=1e-4)


def test_dropout_on_training_lowers_the_loss():
    """Dropout 0.1 on the fused route: 12 steps on one batch lower the loss
    (navc_tpu's tests/test_fused_train_step.py::test_fused_learns_with_dropout)."""
    _, cfg = configs("NACF", use_pallas=True, hidden_dropout_prob=0.1)
    from navc_tpu_torch.models import build_model

    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                        train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    batch = make_batch(cfg)
    gen = torch.Generator().manual_seed(3)
    losses = [float(step(batch, gen)["total_loss"]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.995, losses


def test_run_train_epoch_keys_schedule_and_averages():
    """info has navc_tpu's keys, each the sample-weighted average of the
    steps' metrics; the lr follows the schedule's warmup."""
    jcfg, cfg = configs("NACF", use_pallas=True, n_warmup_steps=3, **NO_DROPOUT)
    batches = [make_batch(cfg, seed=s) for s in (1, 2)]
    seen = []

    model = port_model(cfg, jcfg)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)

    def spy(batch, gen):
        seen.append(float(state.optimizer.param_groups[0]["lr"]))
        return step(batch, gen)

    state, info = run_train_epoch(cfg, spy, state, batches,
                                  optim.LrSchedule.from_config(cfg),
                                  torch.Generator().manual_seed(0))
    assert state.step == 2
    np.testing.assert_allclose(seen, [cfg.learning_rate / 4, cfg.learning_rate / 2])
    assert set(info) == {"total_loss", "lang_loss", "length_loss", "word_acc0",
                         "word_acc1", "perplexity"}

    model2 = port_model(cfg, jcfg)
    state2 = create_train_state(cfg, model2)
    step2 = make_train_step(cfg, model2, state2.optimizer)
    ms = []
    for lr, b in zip(seen, batches):
        optim.set_learning_rate(state2.optimizer, lr)
        ms.append({k: float(v) for k, v in step2(b, torch.Generator()).items()})
    n = sum(m["num_samples"] for m in ms)
    want = sum(m["total_loss"] * m["num_samples"] for m in ms) / n
    np.testing.assert_allclose(info["total_loss"], want, rtol=1e-6)
    acc = sum(m["word_acc1_correct"] for m in ms) / sum(m["word_acc1_count"] for m in ms)
    np.testing.assert_allclose(info["word_acc1"], acc, rtol=1e-6)
    ppl = np.exp(sum(m["ppl_sum"] for m in ms) / sum(m["ppl_count"] for m in ms))
    np.testing.assert_allclose(info["perplexity"], ppl, rtol=1e-5)
