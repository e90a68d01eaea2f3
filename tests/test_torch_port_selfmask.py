"""The SelfMask decoding type in the port against navc_tpu, on the CPU.

SelfMask is the parallel-MLM AR variant: the decoder reads ``tokens[:, 1:]``
under the key-pad mask plus the diagonal, its targets shifted by one as
ARFormer's, and ``parallel_mlm`` drops the self-attention residual. It
trains on the module route in both packages (``fused_train_eligible`` is
false for it) and decodes through the AR beam search.

  * ``self_mask_diag`` equals navc_tpu's exactly;
  * a p = 0 train step of an ARB configuration with SelfMask and
    ``parallel_mlm`` matches navc_tpu's, kernels off and on, with
    tests/test_torch_port_train.py's tolerances (metrics 1e-4, gradients
    and parameters 1e-5);
  * one ``train_network_all`` epoch (validation and test decoded through
    the beam search) matches navc_tpu's: train loss within 1e-4 relative,
    every metric to 1e-9 (the same captions);
  * its teacher-forced forward's log-probs match navc_tpu's to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navc_tpu.ops import eligibility as JE
from navc_tpu.ops import masking as JM
from navc_tpu.runtime.loop import train_network_all as jax_train
from navc_tpu_torch.ops import eligibility as PE
from navc_tpu_torch.ops import masking as PM
from navc_tpu_torch.runtime.loop import train_network_all
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from test_torch_port_loop import METRICS
from test_torch_port_loop import configs as loop_configs
from test_torch_port_loop import seeded_init
from test_torch_port_train import (METRIC_TOL, NO_DROPOUT, PARAM_TOL, assert_trees_close,
                                   configs, flax_variables, jax_one_step, make_batch,
                                   port_model, port_one_step)

SELFMASK = dict(decoding_type="SelfMask", parallel_mlm=True)


def selfmask(pair):
    """(navc_tpu's config, the port's) with SelfMask set after the method's
    overlay (which sets ARB's decoding type)."""
    jcfg, cfg = (c.replace(**SELFMASK) for c in pair)
    assert cfg.to_dict() == jcfg.to_dict() and cfg.decoding_type == "SelfMask"
    return jcfg, cfg


def test_self_mask_diag_matches_navc_tpu():
    rng = np.random.RandomState(0)
    seq = rng.randint(0, 9, (5, 7)).astype(np.int32)
    seq[1, 4:] = 0
    seq[3, :] = 0
    got = PM.self_mask_diag(torch.from_numpy(seq)).numpy()
    want = np.asarray(JM.self_mask_diag(jnp.asarray(seq)))
    assert got.dtype == np.bool_ and got.shape == want.shape == (5, 7, 7)
    np.testing.assert_array_equal(got, want)
    assert got[:, np.arange(7), np.arange(7)].all()


@pytest.mark.parametrize("pallas", [False, True], ids=["modules", "kernels-on"])
def test_selfmask_step_matches_navc_tpu(pallas, monkeypatch):
    """Kernels on or off, SelfMask trains on the module route with the
    logits (no K11, no K9) in both packages."""
    monkeypatch.delenv("NAVC_NO_FUSED_TRAIN", raising=False)
    jcfg, cfg = selfmask(configs("ARB", use_pallas=pallas, **NO_DROPOUT))
    assert not PE.fused_train_eligible(cfg) and not JE.fused_train_eligible(jcfg)
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


def test_selfmask_forward_matches_navc_tpu():
    """The teacher-forced forward: the decoder reads tokens[1:] under the
    diagonal mask; log-probs within 1e-5."""
    jcfg, cfg = selfmask(configs("ARB"))
    jmodel, variables = flax_variables(jcfg)
    model = port_model(cfg, jcfg).eval()
    batch = make_batch(cfg, seed=2)
    feats = [batch["feats_%s" % ch] for ch in cfg.modality.lower()]
    want = jmodel.apply(variables, [jnp.asarray(f) for f in feats],
                        jnp.asarray(batch["tokens"]), deterministic=True)
    with torch.no_grad():
        got = model([torch.from_numpy(f) for f in feats], torch.from_numpy(batch["tokens"]))
    (w,), (g,) = want["tgt_word_logprobs"], got["tgt_word_logprobs"]
    assert g.shape == w.shape == (cfg.batch_size, cfg.max_len - 1, cfg.vocab_size)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_selfmask_train_network_all_matches_navc_tpu(tmp_path):
    jcfg, cfg = selfmask(loop_configs("ARB", tmp_path, epochs=1))
    corpus, refs = make_synthetic_corpus(cfg, n_videos=14, n_caps=2, vocab_size=40)
    data = dict(info_corpus=corpus, references=refs,
                in_memory_feats=make_synthetic_feats(cfg, n_videos=14, n_total_frames=10))
    init = seeded_init(cfg, str(tmp_path / "init.ckpt"))
    jcfg, cfg = jcfg.replace(pretrained_path=init), cfg.replace(pretrained_path=init)
    got = train_network_all(cfg, workdir=str(tmp_path / "port"), verbose=False,
                            device="cpu", **data)
    want = jax_train(jcfg, workdir=str(tmp_path / "jax"), verbose=False, **data)
    assert len(got["history"]) == len(want["history"]) == 1
    g, w = got["history"][0], want["history"][0]
    assert w["train_loss"] > 0
    np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
    for k in METRICS:
        assert abs(g[k] - w[k]) <= 1e-9, (k, g[k], w[k])
        assert abs(got["test_res"][k] - want["test_res"][k]) <= 1e-9, k
    assert jax.tree_util.tree_leaves(want["test_res"])  # a test split was scored
