"""Evaluation/translation entry point (port of navc_tpu/cli/translate.py,
reference translate.py).

    python -m navc_tpu_torch.cli.translate --default --method NACF \
        --dataset MSRVTT --use_ct --val_and_test --record [--device cuda|cpu]

``--device`` (default ``cuda``) picks where the models run; without a card
ask for ``cpu``. The options are navc_tpu's. ``translate`` is the body
after argument parsing: it also takes the corpus, the features and the
references in memory (HDF5 features need h5py). navc_tpu's compilation
cache has no counterpart: the kernels' hashed build directory takes its
place.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

from ..config import Config
from ..data.loader import get_loader
from ..runtime.checkpoint import load_model_and_config
from ..runtime.evaluate import Evaluator, run_eval
from ..runtime.logger import CsvLogger
from ..runtime.sentence import get_dict_mapping

RECORD_FIELDS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                 "CIDEr", "Sum", "ave_length", "novel", "unique", "usage"]


def build_parser():
    p = argparse.ArgumentParser(description="translate")
    p.add_argument("-df", "--default", default=False, action="store_true")
    p.add_argument("-method", "--method", default="ARB", type=str)
    p.add_argument("-dataset", "--dataset", default="MSRVTT", type=str)
    p.add_argument("--default_model_name", default="best.ckpt", type=str)
    p.add_argument("-scope", "--scope", default="", type=str)
    p.add_argument("-record", "--record", default=False, action="store_true")
    p.add_argument("-field", "--field", nargs="+", type=str, default=["seed"])
    p.add_argument("-val_and_test", "--val_and_test", default=False, action="store_true")
    p.add_argument("-model_path", "--model_path", type=str, default="")
    p.add_argument("-teacher_path", "--teacher_path", type=str, default="")
    p.add_argument("-bs", "--beam_size", type=int, default=5)
    p.add_argument("-ba", "--beam_alpha", type=float, default=1.0)
    p.add_argument("-topk", "--topk", type=int, default=1)
    p.add_argument("-i", "--iterations", type=int, default=5)
    p.add_argument("-lbs", "--length_beam_size", type=int, default=6)
    p.add_argument("-q", "--q", type=int, default=1)
    p.add_argument("-qi", "--q_iterations", type=int, default=1)
    p.add_argument("-paradigm", "--paradigm", type=str, default="mp")
    p.add_argument("-use_ct", "--use_ct", default=False, action="store_true")
    p.add_argument("-md", "--masking_decision", default=False, action="store_true")
    p.add_argument("-ncd", "--no_candidate_decision", default=False, action="store_true")
    p.add_argument("-batch_size", "--batch_size", type=int, default=128)
    p.add_argument("-em", "--evaluation_mode", type=str, default="test")
    p.add_argument("-print_sent", action="store_true")
    p.add_argument("-ns", "--no_score", default=False, action="store_true")
    p.add_argument("-analyze", default=False, action="store_true")
    p.add_argument("-latency", default=False, action="store_true")
    p.add_argument("-specific", default=-1, type=int)
    p.add_argument("-collect_path", type=str, default="./collected_captions")
    p.add_argument("-collect", default=False, action="store_true")
    p.add_argument("--base_checkpoint_path", type=str, default="./experiments")
    return p


def prepare_collect_path(cfg: Config, opt) -> str:
    """Collection-file naming (reference translate.py:14-41)."""
    os.makedirs(opt.collect_path, exist_ok=True)
    names = [cfg.dataset, cfg.method, opt.evaluation_mode]
    if cfg.decoding_type == "ARFormer":
        parameter = "bs%d_topk%d.pkl" % (cfg.beam_size, cfg.topk)
    else:
        names.append(("CT" if cfg.use_ct else "") + cfg.paradigm)
        if cfg.paradigm == "mp":
            parameter = "i%db%da%03d.pkl" % (
                cfg.iterations, cfg.length_beam_size, int(100 * cfg.beam_alpha))
        else:
            parameter = "q%dqi%db%da%03d.pkl" % (
                cfg.q, cfg.q_iterations, cfg.length_beam_size,
                int(100 * cfg.beam_alpha))
    return os.path.join(opt.collect_path, "_".join(names + [parameter]))


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def translate(opt, device="cuda", info_corpus=None, in_memory_feats=None,
              references=None):
    """Evaluate the checkpoint ``opt`` names on its split(s); returns
    {mode: metrics}. ``info_corpus`` stands in for the checkpoint's corpus
    file (and the teacher's, when its config names the same file),
    ``in_memory_feats`` for its feature files and ``references`` for its
    reference file."""
    if opt.default:
        if opt.dataset.lower() == "msvd":
            opt.dataset = "Youtube2Text"
        opt.model_path = os.path.join(opt.base_checkpoint_path, opt.dataset,
                                      opt.method, opt.scope, opt.default_model_name)
        if opt.method in ("NAB", "NACF"):
            opt.teacher_path = os.path.join(
                opt.base_checkpoint_path, opt.dataset, "ARB", opt.scope,
                opt.default_model_name)
            assert os.path.exists(opt.teacher_path), opt.teacher_path
    assert opt.model_path and os.path.exists(opt.model_path), opt.model_path

    model, cfg, _ = load_model_and_config(opt.model_path, device=device)
    teacher_model = teacher_cfg = None
    if opt.teacher_path:
        print("Loading teacher model from %s" % opt.teacher_path)
        teacher_model, teacher_cfg, _ = load_model_and_config(opt.teacher_path,
                                                              device=device)

    # eval-time option re-derivation (reference translate.py:127-144)
    if not opt.default:
        cfg = cfg.replace(
            beam_size=opt.beam_size, beam_alpha=opt.beam_alpha, topk=opt.topk,
            iterations=opt.iterations, length_beam_size=opt.length_beam_size,
            q=opt.q, q_iterations=opt.q_iterations, paradigm=opt.paradigm,
            use_ct=opt.use_ct, masking_decision=opt.masking_decision,
            no_candidate_decision=opt.no_candidate_decision,
            batch_size=opt.batch_size)
    elif cfg.decoding_type != "NARFormer":
        cfg = cfg.replace(topk=opt.topk, beam_size=5, beam_alpha=1.0)
    else:
        cfg = cfg.replace(
            paradigm=opt.paradigm, iterations=5, length_beam_size=6,
            beam_alpha=1.35 if opt.dataset == "MSRVTT" else 1.0,
            q=1, q_iterations=1 if opt.use_ct else 0, use_ct=opt.use_ct)
    if opt.latency:
        opt.batch_size = 1
        cfg = cfg.replace(batch_size=1)

    modes = ["validate", "test"] if opt.val_and_test else [opt.evaluation_mode]
    csv_names = {"validate": "validation_record.csv", "test": "testing_record.csv"}
    corpus = info_corpus if info_corpus is not None else _read(cfg.info_corpus)
    dict_mapping = None
    if teacher_cfg is not None:
        same = info_corpus is not None and teacher_cfg.info_corpus == cfg.info_corpus
        teacher_info = corpus if same else _read(teacher_cfg.info_corpus)
        dict_mapping = get_dict_mapping(cfg, teacher_cfg, corpus, teacher_info)

    collect_nar = opt.collect and cfg.decoding_type == "NARFormer"
    evaluator = Evaluator(cfg, model, teacher_cfg, teacher_model, dict_mapping,
                          collect=collect_nar)
    results = {}
    for mode in modes:
        opt.evaluation_mode = mode
        loader = get_loader(cfg, mode=mode, info_corpus=corpus,
                            in_memory_feats=in_memory_feats,
                            batch_size=opt.batch_size, specific=opt.specific)
        if references is not None:
            loader.dataset.set_references(references)
        vocab = loader.dataset.get_vocab()
        metric = run_eval(cfg, evaluator, loader, vocab, no_score=opt.no_score,
                          analyze=True if opt.record else opt.analyze,
                          print_sent=opt.print_sent,
                          collect_path=prepare_collect_path(cfg, opt)
                          if opt.collect else None)
        print(mode, metric)
        results[mode] = metric
        if opt.record:
            logger = CsvLogger(filepath=cfg.checkpoint_path,
                               filename=csv_names.get(mode, "record.csv"),
                               fieldsnames=RECORD_FIELDS + opt.field)
            for key in opt.field:
                metric[key] = getattr(cfg, key, None)
            logger.write(metric)
    return results


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    return translate(build_parser().parse_args(rest), device=args.device)


if __name__ == "__main__":
    main()
