"""The port's corpus preparation against navc_tpu's, on the CPU.

Seeded annotation files in the shapes of MSR-VTT's ``videodatainfo.json``
and Youtube2Text's refs pickle are written into ``tmp_path``; both packages
build ``info_corpus.pkl`` and ``refs.pkl`` from them, through
``prepare_corpus`` and through their ``prepare_corpora`` CLIs. The pickles
must be equal (the same objects, and the same bytes): with nltk's import
blocked (the heuristic tagger, as on a host without nltk) and with nltk's
perceptron tagger (the vendored fixture model, ``conftest.nltk_pos_tagger``).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from navc_tpu.cli.prepare_corpora import main as jax_main
from navc_tpu.data.corpus import prepare_corpus as jax_prepare
from navc_tpu_torch.cli.prepare_corpora import main
from navc_tpu_torch.data import corpus as PC
from navc_tpu_torch.data.corpus import prepare_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("a man woman dog cat is are playing plays running the on in guitar ball "
         "park kitchen cooking food field soccer children someone people group of "
         "two small big red car driving road talking video game singing song stage "
         "dancing music water swimming pool rarely zebra").split()


def caption(rng):
    words = list(rng.choice(WORDS, rng.randint(3, 12), p=weights()))
    if rng.rand() < 0.3:
        words[0] = words[0].capitalize()
    return " ".join(w + ("," if rng.rand() < 0.1 else "") for w in words) + \
        ("." if rng.rand() < 0.5 else "")


def weights():
    w = np.arange(len(WORDS), 0, -1).astype(np.float64) ** 2
    return w / w.sum()


def write_msrvtt(path, n_videos=40, n_caps=5, seed=0):
    """MSR-VTT's annotation layout: videos (id, video_id, category, split)
    and sentences (video_id, caption)."""
    rng = np.random.RandomState(seed)
    splits = ["train"] * (n_videos * 6 // 10) + ["validate"] * (n_videos // 10)
    splits += ["test"] * (n_videos - len(splits))
    videos = [{"id": i, "video_id": "video%d" % i, "category": int(rng.randint(20)),
               "split": s} for i, s in enumerate(splits)]
    sentences = [{"video_id": "video%d" % i, "caption": caption(rng), "sen_id": i * n_caps + j}
                 for i in range(n_videos) for j in range(n_caps)]
    with open(path, "w") as f:
        json.dump({"videos": videos, "sentences": sentences}, f)
    return path


def write_youtube2text(path, seed=1):
    """Youtube2Text's refs pickle over videos across its fixed splits
    (train < 1200, validate < 1300, test < 1970)."""
    rng = np.random.RandomState(seed)
    refs = {}
    for num in list(range(0, 1970, 41)) + [1199, 1200, 1299, 1300, 1969]:
        vid = "video%d" % num
        refs[vid] = [{"image_id": vid, "cap_id": j, "caption": caption(rng)}
                     for j in range(int(rng.randint(2, 6)))]
    with open(path, "wb") as f:
        pickle.dump(refs, f)
    return path


CASES = {"MSRVTT": (write_msrvtt, "videodatainfo.json"),
         "Youtube2Text": (write_youtube2text, "refs_raw.pkl")}


def read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return raw, pickle.loads(raw)


def assert_same_outputs(got_dir, want_dir):
    for name in ("info_corpus.pkl", "refs.pkl"):
        (got_raw, got), (want_raw, want) = (read(os.path.join(d, name))
                                            for d in (got_dir, want_dir))
        assert got == want, name
        assert got_raw == want_raw, name


def run_both(dataset, tmp_path, **kw):
    writer, raw_name = CASES[dataset]
    raw = writer(str(tmp_path / raw_name))
    out = {}
    for side, fn in (("port", prepare_corpus), ("jax", jax_prepare)):
        d = tmp_path / side
        d.mkdir()
        out[side] = fn(dataset, raw, str(d / "info_corpus.pkl"), str(d / "refs.pkl"), **kw)
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    return out["port"]


@pytest.mark.parametrize("kw", [{}, dict(count_thr=0, sort_vocab=True)],
                         ids=["defaults", "thr0-sorted"])
@pytest.mark.parametrize("dataset", ["MSRVTT", "Youtube2Text"])
def test_prepare_corpus_matches_navc_tpu_heuristic_tagger(dataset, kw, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nltk", None)  # import nltk fails in both packages
    assert PC._pos_tag(["a", "dog"]) == ["X", "X"]
    info_corpus, refs = run_both(dataset, tmp_path, **kw)
    info = info_corpus["info"]
    assert set(info) >= {"itow", "itop", "length_info", "split"}
    assert ("itoc" in info) == (dataset == "MSRVTT")
    assert set(info_corpus["captions"]) == set(refs) == set(info_corpus["pos_tags"])


@pytest.mark.parametrize("dataset", ["MSRVTT", "Youtube2Text"])
def test_prepare_corpus_matches_navc_tpu_nltk_tagger(dataset, tmp_path, nltk_pos_tagger):
    assert PC._pos_tag(["a", "man", "is", "running"]) != ["X"] * 4  # the real tagger ran
    info_corpus, _ = run_both(dataset, tmp_path)
    assert len(info_corpus["info"]["itop"]) > 5  # special tokens and some tags


@pytest.mark.parametrize("dataset", ["MSRVTT", "Youtube2Text"])
def test_cli_matches_navc_tpu(dataset, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "nltk", None)
    writer, raw_name = CASES[dataset]
    raw = writer(str(tmp_path / raw_name))
    main(["-d", dataset, "--raw_path", raw, "--out_dir", str(tmp_path / "port"),
          "--count_thr", "1"])
    said = capsys.readouterr().out
    jax_main(["-d", dataset, "--raw_path", raw, "--out_dir", str(tmp_path / "jax"),
              "--count_thr", "1"])
    assert said.splitlines()[-1] == capsys.readouterr().out.splitlines()[-1]
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_cli_runs_as_a_module(tmp_path):
    """``python -m navc_tpu_torch.cli.prepare_corpora``, in a process that
    imports neither torch nor navc_tpu to run it."""
    raw = write_msrvtt(str(tmp_path / "videodatainfo.json"), n_videos=20)
    code = ("import runpy, sys; sys.argv = sys.argv[:1] + %r; "
            "runpy.run_module('navc_tpu_torch.cli.prepare_corpora', run_name='__main__'); "
            "assert 'torch' not in sys.modules and 'navc_tpu' not in sys.modules"
            % ["--dataset", "MSRVTT", "--raw_path", raw, "--out_dir", str(tmp_path / "out")])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "vocab size" in proc.stdout
    d = tmp_path / "jax"
    d.mkdir()
    jax_prepare("MSRVTT", raw, str(d / "info_corpus.pkl"), str(d / "refs.pkl"))
    assert_same_outputs(str(tmp_path / "out"), str(d))
