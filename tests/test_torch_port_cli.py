"""``python -m navc_tpu_torch.cli.train --device cpu`` on a synthetic HDF5
data tree, as tests/test_cli.py drives navc_tpu's CLI: an ARB run, then
``--resume`` of the same run for one more epoch. It must write
opt_info.json, best.ckpt, the rolling checkpoint and the CSV record. And
``cli.train.main`` with the features in memory, on a tree without feature
files (as scripts/torch_flagship.py runs it on a host without h5py)."""

import csv
import json
import os
import pickle
import subprocess
import sys

from navc_tpu_torch.cli.train import main as train_main
from navc_tpu_torch.config import Config
from navc_tpu_torch.data.synthetic import (make_synthetic_corpus, make_synthetic_feats,
                                           write_hdf5_feats)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "navc_tpu_torch.cli.train"] + args,
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_train_cli_on_the_cpu(tmp_path):
    ddir = tmp_path / "data" / "Youtube2Text"
    (ddir / "feats").mkdir(parents=True)
    cfg = Config(dataset="Youtube2Text", modality="i", dim_i=12, max_len=8,
                 n_frames=4, n_total_frames=10)
    corpus, refs = make_synthetic_corpus(cfg, n_videos=8, n_caps=2, vocab_size=40)
    with open(ddir / "info_corpus.pkl", "wb") as f:
        pickle.dump(corpus, f)
    with open(ddir / "refs.pkl", "wb") as f:
        pickle.dump(refs, f)
    write_hdf5_feats(str(ddir / "feats" / "image_feats.hdf5"),
                     make_synthetic_feats(cfg, n_videos=8, n_total_frames=10)["feats_i"])
    ckpt_root = tmp_path / "experiments"
    args = ["--device", "cpu", "--dataset", "MSVD", "--method", "ARB", "--scope", "t",
            "--modality", "i", "--dim_i", "12", "--dim_hidden", "16",
            "--num_attention_heads", "2", "--intermediate_size", "32",
            "--n_frames", "4", "--max_len", "8", "--batch_size", "4",
            "--epochs", "1", "--beam_size", "2", "--feats_i_name", "image_feats.hdf5",
            "--base_data_path", str(tmp_path / "data"),
            "--base_checkpoint_path", str(ckpt_root),
            "--compute_dtype", "float32", "--hidden_dropout_prob", "0.1"]
    stdout = run_cli(args)
    assert "device cpu" in stdout and "CIDEr" in stdout
    workdir = ckpt_root / "Youtube2Text" / "ARB" / "t"
    for name in ("opt_info.json", "best.ckpt", "checkpoint.ckpt", "trainning_record.csv"):
        assert (workdir / name).exists(), name
    with open(workdir / "opt_info.json") as f:
        assert json.load(f)["vocab_size"] == 40

    run_cli(args[:args.index("--epochs")] + ["--epochs", "2", "--resume"]
            + args[args.index("--epochs") + 2:])
    with open(workdir / "trainning_record.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]


def test_train_cli_main_takes_features_in_memory(tmp_path):
    ddir = tmp_path / "data" / "Youtube2Text"
    ddir.mkdir(parents=True)
    cfg = Config(dataset="Youtube2Text", modality="i", dim_i=12, max_len=8,
                 n_frames=4, n_total_frames=10)
    corpus, refs = make_synthetic_corpus(cfg, n_videos=8, n_caps=2, vocab_size=40)
    with open(ddir / "info_corpus.pkl", "wb") as f:
        pickle.dump(corpus, f)
    with open(ddir / "refs.pkl", "wb") as f:
        pickle.dump(refs, f)
    ckpt_root = tmp_path / "experiments"
    out = train_main(["--device", "cpu", "--dataset", "MSVD", "--method", "ARB",
                      "--scope", "t", "--modality", "i", "--dim_i", "12",
                      "--dim_hidden", "16", "--num_attention_heads", "2",
                      "--intermediate_size", "32", "--n_frames", "4", "--max_len", "8",
                      "--batch_size", "4", "--epochs", "1", "--beam_size", "2",
                      "--base_data_path", str(tmp_path / "data"),
                      "--base_checkpoint_path", str(ckpt_root), "--compute_dtype", "float32"],
                     in_memory_feats=make_synthetic_feats(cfg, n_videos=8, n_total_frames=10))
    assert not (ddir / "feats").exists()
    assert len(out["history"]) == 1 and "CIDEr" in out["test_res"]
    assert (ckpt_root / "Youtube2Text" / "ARB" / "t" / "best.ckpt").exists()
