"""``train_network_all`` of the port against navc_tpu's, on the CPU.

Both packages train from the same initial weights: the port writes its
seeded init as a ``.ckpt`` and both runs take it through
``cfg.pretrained_path``. Toy dims, float32, every dropout 0, the plain
routes (``use_pallas=False``: the repo's f32 policy, decoded tokens equal).
ARB trains for 2 epochs; NACF and NAB then train for 2 epochs each with the
port's ARB ``best.ckpt`` as their teacher on both sides (warm start +
rescoring), and ARB2 (two decoder passes a step) for 2 epochs.

  * per-epoch ``train_loss`` within 1e-4 relative;
  * every validation and test metric (BLEU, METEOR, ROUGE-L, CIDEr, Sum and
    the caption statistics) equal to 1e-9, which the scorer gives only for
    the same captions;
  * the port's ``best.ckpt`` loads in navc_tpu's ``load_model_and_config``
    and decodes the test split to the same tokens as the port;
  * resume: 2 epochs straight and 1 epoch + ``resume=True`` for 1 more give
    identical parameters (dropout 0.1 here, so the dropout generator's
    state is carried too).
"""

import os

import jax
import numpy as np
import pytest
import torch

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.runtime.checkpoint import load_model_and_config as jax_load
from navc_tpu.runtime.evaluate import Evaluator as JaxEvaluator
from navc_tpu.runtime.loop import train_network_all as jax_train
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import export_flax_variables
from navc_tpu_torch.data.loader import get_loader
from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
from navc_tpu_torch.models import build_model
from navc_tpu_torch.runtime.checkpoint import load_model_and_config, save_checkpoint
from navc_tpu_torch.runtime.evaluate import Evaluator
from navc_tpu_torch.runtime.loop import train_network_all

TOY = dict(vocab_size=40, dim_hidden=16, num_attention_heads=2, intermediate_size=32,
           n_frames=4, n_total_frames=10, dim_i=12, dim_m=10, modality="mi",
           max_len=10, batch_size=4, compute_dtype="float32", epochs=2,
           hidden_dropout_prob=0.0, encoder_dropout=0.0, use_pallas=False,
           scope="t")
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
           "Sum", "ave_length", "novel", "unique", "usage", "gram4")


def configs(method, root, **kw):
    over = dict(TOY, base_checkpoint_path=str(root), **kw)
    jcfg = jax_default_config(method, dataset="MSVD", **over)
    cfg = default_config(method, dataset="MSVD", **over)
    assert cfg.to_dict() == jcfg.to_dict()
    return jcfg, cfg


def seeded_init(cfg, path):
    """The port's seeded init (the generator ``train_network_all`` uses) as
    a .ckpt."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.seed))
    save_checkpoint({"model": model, "settings": cfg}, os.path.dirname(path),
                    os.path.basename(path))
    return path


def assert_runs_equal(got, want):
    assert len(got["history"]) == len(want["history"]) == TOY["epochs"]
    for g, w in zip(got["history"], want["history"]):
        assert w["train_loss"] > 0  # both trained
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-4)
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 1e-9, (k, g[k], w[k])
    for k in METRICS:
        assert abs(got["test_res"][k] - want["test_res"][k]) <= 1e-9, k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    _, cfg = configs("ARB", root)
    corpus, refs = make_synthetic_corpus(cfg, n_videos=14, n_caps=2, vocab_size=40)
    data = dict(info_corpus=corpus, references=refs,
                in_memory_feats=make_synthetic_feats(cfg, n_videos=14, n_total_frames=10))
    out = {"data": data, "root": root}
    teacher = str(root / "port" / "ARB" / "best.ckpt")
    for method in ("ARB", "NACF", "NAB", "ARB2"):
        jcfg, cfg = configs(method, root)
        kw = dict(pretrained_path=seeded_init(cfg, str(root / ("init_%s.ckpt" % method))))
        if cfg.decoding_type == "NARFormer":
            kw["teacher_path"] = teacher
        jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
        got = train_network_all(cfg, workdir=str(root / "port" / method), verbose=False,
                                device="cpu", **data)
        want = jax_train(jcfg, workdir=str(root / "jax" / method), verbose=False, **data)
        out[method] = (cfg, got, want)
    return out


@pytest.mark.parametrize("method", ["ARB", "NACF", "NAB", "ARB2"])
def test_train_network_all_matches_navc_tpu(runs, method):
    _, got, want = runs[method]
    assert_runs_equal(got, want)
    workdir = os.path.join(str(runs["root"]), "port", method)
    for name in ("best.ckpt", "checkpoint.ckpt", "trainning_record.csv"):
        assert os.path.exists(os.path.join(workdir, name)), name


@pytest.mark.parametrize("method", ["ARB", "NACF", "NAB", "ARB2"])
def test_port_best_ckpt_decodes_alike_in_navc_tpu(runs, method):
    cfg = runs[method][0]
    path = os.path.join(str(runs["root"]), "port", method, "best.ckpt")
    model, pcfg, _ = load_model_and_config(path, device="cpu")
    jmodel, jvars, jcfg, _ = jax_load(path)
    assert jcfg.to_dict() == pcfg.to_dict()
    loader = get_loader(cfg, "test", info_corpus=runs["data"]["info_corpus"],
                        in_memory_feats=runs["data"]["in_memory_feats"])
    ours, theirs = Evaluator(pcfg, model), JaxEvaluator(jcfg, jmodel)
    n = 0
    for batch in loader:
        hyp = ours.decode_batch(batch)[0]
        jhyp = theirs.decode_batch(jvars, batch)[0]
        np.testing.assert_array_equal(hyp, jhyp)
        n += batch["num_valid"]
    assert n > 0


def test_resume_is_exact(runs, tmp_path):
    root = runs["root"]
    _, cfg = configs("ARB", root, hidden_dropout_prob=0.1)
    cfg = cfg.replace(pretrained_path=str(root / "init_ARB.ckpt"), no_test=True)
    data = runs["data"]
    straight = train_network_all(cfg, workdir=str(tmp_path / "a"), verbose=False,
                                 device="cpu", **data)
    train_network_all(cfg.replace(epochs=1), workdir=str(tmp_path / "b"), verbose=False,
                      device="cpu", **data)
    resumed = train_network_all(cfg, workdir=str(tmp_path / "b"), verbose=False,
                                device="cpu", resume=True, **data)
    assert len(resumed["history"]) == 1 and resumed["history"][0]["epoch"] == 1
    a = jax.tree_util.tree_leaves(export_flax_variables(straight["model"]))
    b = jax.tree_util.tree_leaves(export_flax_variables(resumed["model"]))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    sa = straight["state"].optimizer.state_dict()["state"]
    sb = resumed["state"].optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
