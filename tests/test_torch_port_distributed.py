"""The port's multi-rank training loop and ``cli.train --distributed`` on a
2-rank gloo cluster on the CPU, started once for the module
(``torch_port_dist_worker.start``, suite ``loop``), as navc_tpu's
tests/test_distributed.py drives its own:

  * ``train_network_all_multihost`` (ARB, 2 epochs on the learnable
    synthetic corpus, 'data' 2): the global train loss per epoch identical
    on both ranks, validation on rank 0 only (2 and 0), the checkpoints,
    best.ckpt and the CSV written by rank 0 only;
  * the same on a data 1 x model 2 mesh: the evaluation-time gather of the
    TP slices runs on every rank without a deadlock (navc_tpu's
    test_multihost_tensor_parallel_eval_gather), and its best.ckpt holds
    the full weights;
  * ``cli.train.main([... "--distributed"], in_memory_feats=...)``: NACF
    with the first run's ARB as teacher (warm start and rescoring), rank 0
    validating and writing best.ckpt; with ``--resume`` both ranks raise
    navc_tpu's NotImplementedError;
  * the TP run's best.ckpt loads in the port's single-process
    ``load_model_and_config`` and scores the test split as the run did;
    the NACF run's loads in navc_tpu's with the port's weights bit for bit.
"""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

import torch_port_dist_worker as worker
from navc_tpu_torch.config import default_config
from navc_tpu_torch.data.loader import get_loader
from navc_tpu_torch.data.synthetic import make_learnable_synthetic
from navc_tpu_torch.runtime.checkpoint import load_model_and_config
from navc_tpu_torch.runtime.evaluate import Evaluator, run_eval

OVER = dict(dataset="MSVD", vocab_size=40, dim_hidden=16, num_attention_heads=2,
            intermediate_size=32, n_frames=4, n_total_frames=10, dim_i=12, dim_m=10,
            modality="mi", max_len=8, batch_size=8, epochs=2, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, encoder_dropout=0.0,
            compute_dtype="float32", beam_size=2, save_checkpoint_every=1)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop"))
    cfg = default_config("ARB", **OVER)
    corpus, refs, feats = make_learnable_synthetic(cfg, n_videos=16, n_classes=4)
    data = os.path.join(root, "data", "Youtube2Text")
    os.makedirs(data)
    for name, obj in (("info_corpus.pkl", corpus), ("refs.pkl", refs)):
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)
    teacher = os.path.join(root, "data2", "best.ckpt")
    cli_argv = ["--device", "cpu", "--dataset", "MSVD", "--method", "NACF", "--scope", "d",
                "--modality", "mi", "--dim_i", "12", "--dim_m", "10", "--dim_hidden", "16",
                "--num_attention_heads", "2", "--intermediate_size", "32",
                "--n_frames", "4", "--n_total_frames", "10", "--max_len", "8",
                "--batch_size", "8", "--epochs", "1", "--length_beam_size", "2",
                "--iterations", "2", "--compute_dtype", "float32",
                "--hidden_dropout_prob", "0", "--encoder_dropout", "0",
                "--teacher_path", teacher, "--load_teacher_weights",
                "--base_data_path", os.path.join(root, "data"),
                "--base_checkpoint_path", os.path.join(root, "experiments")]
    wait = worker.start("loop", 2, dict(device="cpu", loop=dict(
        root=root, corpus=corpus, refs=refs, feats=feats, cli_argv=cli_argv,
        loops=[("data2", cfg), ("tp_1x2", cfg.replace(mesh_shape={"data": 1, "model": 2}))])),
        os.path.join(root, "ranks"), timeout=300)
    return dict(root=root, outs=[o["loop"] for o in wait()], corpus=corpus, refs=refs,
                feats=feats, cli_dir=os.path.join(root, "experiments", "Youtube2Text",
                                                  "NACF", "d"))


@pytest.mark.parametrize("name", ["data2", "tp_1x2"])
def test_multihost_loop_in_lockstep_with_rank0_side_effects(loop_runs, name):
    r0, r1 = (o[name] for o in loop_runs["outs"])
    assert len(r0["train_curve"]) == 2 and all(np.isfinite(r0["train_curve"]))
    assert r0["train_curve"] == r1["train_curve"]  # the global loss, on both ranks
    assert (r0["n_eval"], r1["n_eval"]) == (2, 0)
    run = os.path.join(loop_runs["root"], name)
    assert r1["saved"] == []
    assert r0["saved"].count(os.path.join(run, "checkpoint.ckpt")) == 2
    assert os.path.join(run, "best.ckpt") in r0["saved"]
    with open(os.path.join(run, "trainning_record.csv")) as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0", "1"]
    assert "CIDEr" in r0["test_res"] and r1["test_res"] is None


def test_tp_best_checkpoint_holds_full_weights_and_decodes(loop_runs):
    """The data 1 x model 2 run's best.ckpt: full-size weights, loaded by
    the single-process port, decoding the test split as rank 0 scored it
    within the run's final evaluation."""
    model, cfg, other = load_model_and_config(
        os.path.join(loop_runs["root"], "tp_1x2", "best.ckpt"), device="cpu")
    assert model.decoder.embedding.word_embeddings.weight.shape == (40, 16)
    assert model.tgt_word_prj.weight.shape == (40, 16)
    assert model.decoder.layers[0].intermediate.dense.weight.shape == (32, 16)
    assert cfg.mesh_shape == {"data": 1, "model": 2} and other["epoch"] in (1, 2)
    loader = get_loader(cfg, "test", loop_runs["corpus"], loop_runs["feats"])
    loader.dataset.set_references(loop_runs["refs"])
    res = run_eval(cfg, Evaluator(cfg, model), loader, loader.dataset.get_vocab())
    want = loop_runs["outs"][0]["tp_1x2"]["test_res"]
    assert res["CIDEr"] == pytest.approx(want["CIDEr"], abs=1e-9)


def test_cli_distributed_trains_nacf_with_its_teacher(loop_runs):
    r0, r1 = (o["cli"] for o in loop_runs["outs"])
    assert r0["train_curve"] == r1["train_curve"] and len(r0["train_curve"]) == 1
    assert (r0["n_eval"], r1["n_eval"]) == (1, 0)
    assert "CIDEr" in r0["test_res"] and r1["test_res"] is None
    for name in ("opt_info.json", "best.ckpt", "checkpoint.ckpt", "trainning_record.csv"):
        assert os.path.exists(os.path.join(loop_runs["cli_dir"], name)), name


def test_cli_resume_with_distributed_raises(loop_runs):
    for o in loop_runs["outs"]:
        assert o["resume"].startswith("NotImplementedError: --resume is single-host only")


def test_cli_best_checkpoint_loads_in_navc_tpu(loop_runs):
    """The distributed NACF run's best.ckpt in navc_tpu's own
    load_model_and_config: its weights are the port's, bit for bit."""
    from navc_tpu.runtime.checkpoint import load_model_and_config as jax_load

    from navc_tpu_torch.convert import export_flax_variables

    path = os.path.join(loop_runs["cli_dir"], "best.ckpt")
    model, cfg, _ = load_model_and_config(path, device="cpu")
    _, jvars, jcfg, _ = jax_load(path)
    assert jcfg.method == cfg.method == "NACF"
    mine = export_flax_variables(model)

    def walk(a, b):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))

    walk(mine["params"], jvars["params"])
    assert torch.isfinite(model.tgt_word_prj.weight).all()
