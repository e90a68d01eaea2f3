"""The port's inference entry points against navc_tpu's, on the CPU:
``cli.translate``, ``run_eval``'s collect and scoring modes,
``CaptionPipeline``, ``runtime.torch_convert`` and ``cli.convert``.

The checkpoints are port-trained: ``navc_tpu_torch.cli.train --device
cpu`` trains an ARB and then an NACF model with that ARB teacher for one
epoch each on a synthetic HDF5 data tree shaped like tests/test_cli.py's
(8 videos, vocab 40, captions of at most 8 tokens, d 16, float32, the
plain routes). Both
packages then read the same ``.ckpt`` files:

  * ``translate`` (``--device cpu``): every metric equal to navc_tpu's
    within 1e-9 (the scorer gives that only for the same captions), the
    ``-collect`` pickles equal — NAR sentences equal and probs within 1e-6,
    AR captions equal and scores within 1e-5 (atol, rtol 0) — and the
    ``--record`` rows equal;
  * ``run_eval``: ``no_score`` and the n-best refusal as navc_tpu's;
  * ``CaptionPipeline``: ids and captions equal;
  * ``torch_convert`` on a ``state_dict`` with the reference's key names:
    the tree equals navc_tpu's ``convert_state_dict`` leaf by leaf (and
    the weights it was made from); ``cli.convert`` writes a ``.ckpt``
    that both packages load to those weights;
  * without a card, every new entry point refuses unless asked for the CPU.
"""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

from navc_tpu.api import CaptionPipeline as JaxCaptionPipeline
from navc_tpu.cli.translate import main as jax_translate_main
from navc_tpu.runtime.checkpoint import load_model_and_config as jax_load
from navc_tpu.runtime.evaluate import Evaluator as JaxEvaluator
from navc_tpu.runtime.evaluate import run_eval as jax_run_eval
from navc_tpu.runtime.torch_convert import convert_state_dict as jax_convert_state_dict
from navc_tpu_torch.api import CaptionPipeline
from navc_tpu_torch.cli import convert as convert_cli
from navc_tpu_torch.cli.train import main as train_main
from navc_tpu_torch.cli.translate import main as translate_main
from navc_tpu_torch.config import Config, default_config
from navc_tpu_torch.convert import export_flax_variables
from navc_tpu_torch.data.loader import get_loader
from navc_tpu_torch.data.synthetic import (make_synthetic_corpus, make_synthetic_feats,
                                           write_hdf5_feats)
from navc_tpu_torch.models import build_model
from navc_tpu_torch.runtime.checkpoint import load_model_and_config
from navc_tpu_torch.runtime.evaluate import Evaluator, run_eval
from navc_tpu_torch.runtime.torch_convert import (_flat_paths, convert_state_dict,
                                                  validate_against)

METRIC_TOL, PROB_TOL, SCORE_TOL = 1e-9, 1e-6, 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("translate")
    ddir = root / "data" / "Youtube2Text"
    (ddir / "feats").mkdir(parents=True)
    cfg = Config(dataset="Youtube2Text", modality="i", dim_i=12, max_len=8,
                 n_frames=4, n_total_frames=10)
    corpus, refs = make_synthetic_corpus(cfg, n_videos=8, n_caps=2, vocab_size=40)
    feats = make_synthetic_feats(cfg, n_videos=8, n_total_frames=10)
    with open(ddir / "info_corpus.pkl", "wb") as f:
        pickle.dump(corpus, f)
    with open(ddir / "refs.pkl", "wb") as f:
        pickle.dump(refs, f)
    write_hdf5_feats(str(ddir / "feats" / "image_feats.hdf5"), feats["feats_i"])
    ckpt_root = str(root / "experiments")
    base = ["--device", "cpu", "--dataset", "MSVD", "--scope", "w", "--modality", "i",
            "--dim_i", "12", "--dim_hidden", "16", "--num_attention_heads", "2",
            "--intermediate_size", "32", "--n_frames", "4", "--batch_size", "4",
            "--epochs", "1", "--no_test", "--feats_i_name", "image_feats.hdf5",
            "--base_data_path", str(root / "data"), "--base_checkpoint_path", ckpt_root,
            "--compute_dtype", "float32", "--hidden_dropout_prob", "0.1",
            "--default", "--max_len", "8"]
    train_main(base + ["--method", "ARB"])
    train_main(base + ["--method", "NACF", "--length_beam_size", "2", "--iterations", "2"])
    run = os.path.join(ckpt_root, "Youtube2Text", "%s", "w", "best.ckpt")
    return dict(root=root, ckpt_root=ckpt_root, arb=run % "ARB", nacf=run % "NACF",
                feats=feats, corpus=corpus, refs=refs)


def assert_metrics_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "latency":
            assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])


def both_translate(args, collect_root=None):
    """(port result, navc_tpu result[, port pickle, navc_tpu pickle])."""
    out = []
    for who, main in (("port", lambda a: translate_main(["--device", "cpu"] + a)),
                      ("jax", jax_translate_main)):
        extra = []
        if collect_root is not None:
            extra = ["-collect", "-collect_path", os.path.join(collect_root, who)]
        out.append(main(list(args) + extra))
    if collect_root is None:
        return out
    for who in ("port", "jax"):
        d = os.path.join(collect_root, who)
        (name,) = os.listdir(d)
        with open(os.path.join(d, name), "rb") as f:
            out.append((name, pickle.load(f)))
    return out


def test_translate_nacf_collect_matches_navc_tpu(tree, tmp_path):
    """mp with CT and the ARB teacher, -collect: per-iteration pickle."""
    got, want, (pname, ppkl), (jname, jpkl) = both_translate(
        ["--model_path", tree["nacf"], "--teacher_path", tree["arb"], "-use_ct",
         "-i", "2", "-lbs", "2", "-em", "test", "-analyze"], str(tmp_path))
    assert_metrics_equal(got["test"], want["test"])
    assert "CIDEr" in got["test"] and pname == jname
    (sents, probs), (jsents, jprobs) = ppkl, jpkl
    assert sents == jsents and sorted(probs) == sorted(jprobs)
    vid = next(iter(sents))
    assert len(sents[vid]) == 3  # CT + 2 iterations
    for v in jprobs:
        np.testing.assert_allclose(np.asarray(probs[v]), np.asarray(jprobs[v]),
                                   rtol=0, atol=PROB_TOL)


@pytest.mark.parametrize("args", [
    ["-paradigm", "l2r", "-use_ct", "-q", "1", "-qi", "1", "-lbs", "2", "-em", "test"],
    ["--default", "--method", "NACF", "--dataset", "MSVD", "--scope", "w",
     "-paradigm", "ef", "-val_and_test"]],
    ids=["l2r-ct", "ef-default-val_and_test"])
def test_translate_nacf_paradigms_match_navc_tpu(tree, args):
    if "--default" in args:
        args = args + ["--base_checkpoint_path", tree["ckpt_root"]]
    else:
        args = ["--model_path", tree["nacf"], "--teacher_path", tree["arb"]] + args
    got, want = both_translate(args)
    assert sorted(got) == sorted(want)
    for mode in want:
        assert_metrics_equal(got[mode], want[mode])


def test_translate_arb_collect_matches_navc_tpu(tree, tmp_path):
    """AR collect at topk 2: every beam hypothesis with its score."""
    got, want, (pname, ppkl), (jname, jpkl) = both_translate(
        ["--model_path", tree["arb"], "-bs", "2", "-topk", "2", "-em", "test"],
        str(tmp_path))
    n_test = len(tree["corpus"]["info"]["split"]["test"])
    assert got == want == {"test": {"collected": n_test}} and pname == jname
    assert sorted(ppkl) == sorted(jpkl)
    for vid, caps in jpkl.items():
        assert [c["caption"] for c in ppkl[vid]] == [c["caption"] for c in caps]
        np.testing.assert_allclose([c["score"] for c in ppkl[vid]],
                                   [c["score"] for c in caps], rtol=0, atol=SCORE_TOL)


def test_translate_arb_record_and_latency(tree):
    """--record appends one CSV row per mode to the run directory: the
    port's row, then navc_tpu's, must be equal; -latency scores at batch 1."""
    got, want = both_translate(["--model_path", tree["arb"], "-bs", "2", "--record",
                                "-em", "validate"])
    assert_metrics_equal(got["validate"], want["validate"])
    with open(os.path.join(os.path.dirname(tree["arb"]), "validation_record.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 and rows[0]["seed"] == rows[1]["seed"]
    for k in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Sum", "ave_length", "usage"):
        assert abs(float(rows[0][k]) - float(rows[1][k])) <= METRIC_TOL, k
    got, want = both_translate(["--model_path", tree["arb"], "-bs", "2", "-latency",
                                "-em", "test"])
    assert got["test"]["latency"] > 0
    assert_metrics_equal(got["test"], want["test"])


def test_run_eval_no_score_and_nbest_refusal(tree):
    model, cfg, _ = load_model_and_config(tree["arb"], device="cpu")
    jmodel, jvars, jcfg, _ = jax_load(tree["arb"])
    cfg, jcfg = cfg.replace(beam_size=2, topk=2), jcfg.replace(beam_size=2, topk=2)
    loader = get_loader(cfg, "test", info_corpus=tree["corpus"], batch_size=4)
    loader.dataset.set_references(tree["refs"])
    vocab = loader.dataset.get_vocab()
    ours, theirs = Evaluator(cfg, model), JaxEvaluator(jcfg, jmodel)
    for run in (lambda **kw: run_eval(cfg, ours, loader, vocab, **kw),
                lambda **kw: jax_run_eval(jcfg, theirs, jvars, loader, vocab, **kw)):
        with pytest.raises(ValueError, match="topk == 1"):
            run()
        assert run(no_score=True) == {}
        res = run(no_score=True, analyze=True)
        assert sorted(res) == ["ave_length", "gram4", "novel", "unique", "usage"]
    assert run_eval(cfg, ours, loader, vocab, no_score=True, analyze=True) == \
        jax_run_eval(jcfg, theirs, jvars, loader, vocab, no_score=True, analyze=True)


def test_caption_pipeline_matches_navc_tpu(tree):
    pipe = CaptionPipeline.from_checkpoints(tree["nacf"], teacher=tree["arb"], device="cpu")
    jpipe = JaxCaptionPipeline.from_checkpoints(tree["nacf"], teacher=tree["arb"])
    vids = ["video%d" % i for i in range(8)]
    rng = np.random.RandomState(0)
    feats = {"feats_i": np.stack([tree["feats"]["feats_i"][v][:4] for v in vids])}
    cat = rng.randint(0, 20, 8)
    ids = pipe.caption_ids(feats, cat)
    np.testing.assert_array_equal(ids, jpipe.caption_ids(feats, cat))
    assert ids.shape == (8, pipe.cfg.max_len)
    assert pipe.caption(feats, cat) == jpipe.caption(feats, cat)
    arb = CaptionPipeline.from_checkpoints(tree["arb"], device="cpu")
    jarb = JaxCaptionPipeline.from_checkpoints(tree["arb"])
    assert arb.caption(feats) == jarb.caption(feats)


def _reference_state_dict(variables, aux_crits, tie_weights, bert):
    """A state_dict with the reference's key names and layouts (torch
    Linear weights (out, in)), written from a flax-layout tree."""
    sd = {}
    dec = "decoder.bert." if bert else "decoder."
    for path in _flat_paths(variables):
        coll, *p = path.split("/")
        node = variables[coll]
        for k in p:
            node = node[k]
        arr = np.asarray(node)
        if coll == "batch_stats":  # fusion/bnN/mean|var
            sd["joint_representation_learner.%s.running_%s" % (p[1], p[2])] = arr
            sd["joint_representation_learner.%s.num_batches_tracked" % p[1]] = np.array(7)
            continue
        leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(p[-1], "bias")
        val = arr.T if p[-1] == "kernel" else arr
        if p[0] == "encoder":
            mid = "0" if p[2] == "linear" else "1." + p[3]
            key = "encoder.%s.%s.%s" % (p[1], mid, leaf)
        elif p[0] == "fusion":
            key = "joint_representation_learner.%s.%s" % (p[1], leaf)
        elif p[0].startswith("predictor_"):
            key = "auxiliary_task_predictor.layers.%d.net.%s.%s" % (
                list(aux_crits).index(p[0][len("predictor_"):]),
                {"fc1": "0", "fc2": "3"}[p[1]], leaf)
        elif p[0] == "decoder":
            mid = [m.replace("layer_", "layer.") for m in p[1:-1]]
            key = dec + ".".join(mid) + "." + leaf
        elif p[0] == "tgt_word_prj":
            key = "tgt_word_prj.weight"
        else:
            assert p == ["tgt_word_prj_bias"], p
            key = "tgt_word_prj.bias"
        sd[key] = val
    if tie_weights:  # the reference keeps the shared table under both names
        sd["tgt_word_prj.weight"] = sd[dec + "embedding.word_embeddings.weight"]
    return sd


def _leaves(tree):
    return {k: v for k, v in _flat_leaves(tree, "")}


def _flat_leaves(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


CONVERT_CASES = [("NACF", dict(), False), ("ARB", dict(tie_weights=True), True)]


@pytest.mark.parametrize("method,kw,bert", CONVERT_CASES, ids=["nacf", "arb-tied-bert"])
def test_torch_convert_matches_navc_tpu(method, kw, bert):
    cfg = default_config(method, dataset="MSVD", vocab_size=40, dim_hidden=16,
                         num_attention_heads=2, intermediate_size=32, n_frames=4,
                         dim_i=12, dim_m=10, modality="mi", **kw)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    want = export_flax_variables(model)
    aux = [c for c in cfg.crit if c.lower() != "lang"]
    sd = _reference_state_dict(want, aux, cfg.tie_weights, bert)
    got = convert_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}, aux_crits=aux,
                             tie_weights=cfg.tie_weights)
    theirs = jax_convert_state_dict(sd, aux_crits=aux, tie_weights=cfg.tie_weights)
    validate_against(got, export_flax_variables(build_model(cfg, device="cpu")))
    flat, jflat, wflat = _leaves(got), _leaves(theirs), _leaves(want)
    assert sorted(flat) == sorted(jflat) == sorted(wflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])
        np.testing.assert_array_equal(flat[k], wflat[k])
    with pytest.raises(KeyError, match="unrecognized"):
        convert_state_dict(dict(sd, **{"decoder.unknown.weight": np.zeros(1)}),
                           aux_crits=aux, tie_weights=cfg.tie_weights)
    missing = {k: v for k, v in sd.items() if not k.endswith("query.bias")}
    with pytest.raises(ValueError, match="missing"):
        validate_against(convert_state_dict(missing, aux_crits=aux,
                                            tie_weights=cfg.tie_weights), want)


def test_convert_cli_writes_a_ckpt_both_packages_load(tmp_path, monkeypatch):
    method, kw, bert = CONVERT_CASES[0]
    cfg = default_config(method, dataset="MSVD", vocab_size=40, dim_hidden=16,
                         num_attention_heads=2, intermediate_size=32, n_frames=4,
                         dim_i=12, dim_m=10, modality="mi", **kw)
    want = _leaves(export_flax_variables(
        build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))))
    sd = _reference_state_dict(export_flax_variables(
        build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))),
        ["length"], False, bert)
    src, dst = str(tmp_path / "best.pth.tar"), str(tmp_path / "out" / "best.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "settings": cfg.to_dict(), "epoch": 3}, src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_cli.main([src, dst])
    assert not os.path.exists(dst)
    convert_cli.main([src, dst, "--device", "cpu"])
    model, pcfg, other = load_model_and_config(dst, device="cpu")
    jmodel, jvars, jcfg, _ = jax_load(dst)
    assert pcfg.to_dict() == cfg.to_dict() == jcfg.to_dict() and other["epoch"] == 3
    got, jgot = _leaves(export_flax_variables(model)), _leaves(jvars)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(jgot[k], want[k])


def test_entry_points_refuse_without_a_card(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        translate_main(["--model_path", tree["arb"], "-em", "test"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CaptionPipeline.from_checkpoints(tree["arb"])
