#!/usr/bin/env python3
"""The port's flagship quality run: the four methods trained on corpus v3.

The counterpart, for ``navc_tpu_torch`` on an NVIDIA card, of the run of
scripts/flagship_quality.py (``--epochs 30 --seeds 0 1 2 3 4``) that wrote
FLAGSHIP_E2E.json; it leaves that script as it is. It

  * makes corpus v3 with the port's ``make_hard_synthetic`` (768 videos,
    128 latent (subject, verb, object) classes, 4 paraphrase captions a
    video, ``role_features=True``, ``modifier_distractors=True``) and writes
    its corpus and references as a dataset directory (``info_corpus.pkl``,
    ``refs.pkl``); the features stay in memory and reach ``cli.train.main``
    and ``cli.translate.translate`` as ``in_memory_feats`` (the card's host
    has no h5py for HDF5 feature files);
  * trains ARB, ARB2, NAB and NACF at seed 0 through
    ``navc_tpu_torch.cli.train`` with flagship_quality.py's flags (MSRVTT
    ``--default``, batch 128, 30 epochs, ``--n_frames 8 --n_total_frames 16
    --save_checkpoint_every 1 --tolerence 1000``; NAB and NACF take the ARB
    run's ``best.ckpt`` as their teacher, as ``--default`` derives it), then
    NACF and NAB again at seeds 1-4 against that fixed seed-0 teacher;
  * runs flagship_quality.py's decode ablations through
    ``navc_tpu_torch.cli.translate`` on the test split at every seed: NACF
    default (CT), no CT, no rescoring, mask decision; NAB default, no
    rescoring, mask decision;
  * scores the oracle (each test video's most frequent training caption of
    its class) and the majority caption with the port's ``COCOScorer``;
  * writes FLAGSHIP_H100.json: each training run's history (seed 0), test
    metrics and wall seconds, each ablation's test metrics and wall seconds
    per seed with their mean and std, the card's name and power limit
    (``nvidia-smi``), and one comparison row per method and ablation: the
    port's seed-0 CIDEr and its 5-seed mean, std and range beside
    navc_tpu's, read from FLAGSHIP_E2E.json as a JSON file. A gap is called
    only where the port's figure (its seed 0, and its 5-seed mean) lies
    outside navc_tpu's 5-seed range; where navc_tpu has one seed (ARB,
    ARB2) the difference is given without a verdict.

Run from the root of a checkout on a machine with one card:

    python3 scripts/torch_flagship.py [--out FLAGSHIP_H100.json]

``--small`` runs the whole sweep at toy width on a small corpus (SMALL: 80
videos, 12 classes, vocab 700, 3 epochs, seeds 0 and 1; ``--device cpu``
without a card): a check of the script, not a measurement. Imports nothing
of JAX or navc_tpu.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
from collections import Counter, defaultdict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METHODS = ("ARB", "ARB2", "NAB", "NACF")
STUDENTS = ("NACF", "NAB")  # retrained at every seed against the seed-0 teacher
# corpus v3 and flagship_quality.py's schedule, as FLAGSHIP_E2E.json was made
PROTOCOL = dict(videos=768, classes=128, caps=4, vocab=10048, batch=128, epochs=30,
                seeds=(0, 1, 2, 3, 4), corpus_kw={}, dim_args=[])
# --small: flagship_quality.py's smoke settings (:279-283) at toy width
SMALL = dict(videos=80, classes=12, caps=3, vocab=700, batch=16, epochs=3, seeds=(0, 1),
             corpus_kw=dict(adj_pool=80, adv_pool=40),
             dim_args=["--dim_hidden", "64", "--num_attention_heads", "4",
                       "--intermediate_size", "128"])
ABLATION_SPECS = (  # flagship_quality.py:240-248: (name, student, extra argv)
    ("NACF_default", "NACF", ["--use_ct"]),
    ("NACF_no_ct", "NACF", []),
    ("NACF_no_rescore", "NACF", ["--use_ct", "--no_candidate_decision"]),
    ("NACF_mask_decision", "NACF", ["--use_ct", "--masking_decision"]),
    ("NAB_default", "NAB", []),
    ("NAB_no_rescore", "NAB", ["--no_candidate_decision"]),
    ("NAB_mask_decision", "NAB", ["--masking_decision"]),
)


def write_dataset(cfg, corpus, refs, base):
    """The dataset directory ``base``/MSRVTT that ``--base_data_path base``
    resolves: the corpus and references as pickles."""
    ddir = os.path.join(base, "MSRVTT")
    os.makedirs(ddir, exist_ok=True)
    with open(os.path.join(ddir, cfg.info_corpus_name), "wb") as f:
        pickle.dump(corpus, f)
    with open(os.path.join(ddir, cfg.reference_name), "wb") as f:
        pickle.dump(refs, f)


def calibration_scores(corpus, refs, n_videos, n_classes):
    """Oracle (perfect class, mode-seeking decode) and majority-caption
    baselines on the test split: the ceiling and floor that make the
    trained numbers readable (flagship_quality.py:66)."""
    from navc_tpu_torch.metrics.scorer import COCOScorer

    info = corpus["info"]
    itow, caps = info["itow"], corpus["captions"]
    video_class = {v: v % n_classes for v in range(n_videos)}
    class_caps = defaultdict(Counter)
    for v in info["split"]["train"]:
        for c in caps["video%d" % v]:
            class_caps[video_class[v]][tuple(c[1:-1])] += 1
    overall = Counter()
    for cc in class_caps.values():
        overall.update(cc)
    glob = list(overall.most_common(1)[0][0])

    def to_str(ws):
        return " ".join(itow[w] for w in ws)

    test = info["split"]["test"]
    gts = {"video%d" % v: refs["video%d" % v] for v in test}
    res_o, res_m = {}, {}
    for v in test:
        cc = class_caps[video_class[v]]
        best = list(cc.most_common(1)[0][0]) if cc else glob
        res_o["video%d" % v] = [{"image_id": "video%d" % v, "caption": to_str(best)}]
        res_m["video%d" % v] = [{"image_id": "video%d" % v, "caption": to_str(glob)}]
    sc = COCOScorer()
    ids = list(gts)
    oracle, _ = sc.score(gts, res_o, ids)
    majority, _ = sc.score(gts, res_m, ids)
    return ({k: float(v) for k, v in oracle.items()},
            {k: float(v) for k, v in majority.items()})


def clean(res):
    return {k: float(v) for k, v in (res or {}).items() if isinstance(v, (int, float))}


def card_name():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except OSError as e:
        return "nvidia-smi failed: %s" % e
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        "nvidia-smi failed: " + out.stderr.strip()


def spread(per_seed):
    """mean, std and range of a list of per-seed figures."""
    return dict(mean=float(np.mean(per_seed)), std=float(np.std(per_seed)),
                range=[min(per_seed), max(per_seed)], n_seeds=len(per_seed))


def compare(port, navc, where):
    """One comparison row: the port's seed-0 CIDEr and, where it has more
    seeds, their spread, against navc_tpu's seed 0 and, where it has more
    seeds, its spread; a verdict where navc_tpu has a range."""
    row = dict(port_seed0=port[0], navc_tpu_seed0=navc["seed0"], navc_tpu_from=where,
               diff_seed0=port[0] - navc["seed0"])
    if len(port) > 1:
        row["port"] = spread(port)
    seeds = navc.get("per_seed", [])
    if len(seeds) < 2:
        row["verdict"] = "none: navc_tpu has one seed"
        return row
    row["navc_tpu"] = spread(seeds)
    lo, hi = row["navc_tpu"]["range"]

    def verdict(x, what):
        return ("%s within navc_tpu's range" % what if lo <= x <= hi else
                "gap: %s %s navc_tpu's %d-seed range" % (what, "below" if x < lo else "above",
                                                          len(seeds)))
    row["verdict"] = verdict(port[0], "seed 0")
    if len(port) > 1:
        row["verdict_mean"] = verdict(row["port"]["mean"], "mean")
    return row


def navc_reference(path):
    """navc_tpu's seed-0 and per-seed test CIDEr from FLAGSHIP_E2E.json:
    {name: {"seed0", "per_seed"}} for each method's training run (its
    5-seed spread taken from the matching default ablation for NAB and
    NACF) and each ablation."""
    with open(path) as f:
        ref = json.load(f)
    out = {}
    for name, ab in ref.get("ablations", {}).items():
        per = ab["per_seed"]
        out[name] = dict(seed0=per["0"]["CIDEr"],
                         per_seed=[per[s]["CIDEr"] for s in sorted(per)])
    for m, rec in ref.get("methods", {}).items():
        seeds = out.get("%s_default" % m, {}).get("per_seed", [])
        out[m] = dict(seed0=rec["test_res"]["CIDEr"], per_seed=seeds)
    return out, ref.get("device")


def comparison(report, reference):
    """{method or ablation: ``compare`` row} of a finished report against
    navc_tpu's record at ``reference``; a student's runs are its default
    decode's."""
    navc, navc_device = navc_reference(reference)
    rows = {}
    for name in list(METHODS) + [a for a, _, _ in ABLATION_SPECS]:
        if name in STUDENTS:
            name_ab = "%s_default" % name
        elif name in METHODS:
            name_ab = None
        else:
            name_ab = name
        port = ([report["methods"][name]["test_res"]["CIDEr"]] if name_ab is None else
                [r["CIDEr"] for r in report["ablations"][name_ab]["per_seed"].values()])
        if name in navc:
            rows[name] = compare(port, navc[name], "FLAGSHIP_E2E.json (%s, %s)" % (
                navc_device, "methods" if name in METHODS else "ablations"))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="toy width and a small corpus (SMALL): a check of the script")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "experiments", "torch_flagship"))
    ap.add_argument("--reference", default=os.path.join(ROOT, "FLAGSHIP_E2E.json"))
    ap.add_argument("--out", default=os.path.join(ROOT, "FLAGSHIP_H100.json"))
    args = ap.parse_args()
    p = SMALL if args.small else PROTOCOL
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    import torch

    from navc_tpu_torch.cli.train import main as train_main
    from navc_tpu_torch.cli.translate import build_parser, translate
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.synthetic import make_hard_synthetic

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: run on a card or pass --device cpu")
    card = card_name() if args.device == "cuda" else "cpu"
    print("[flagship] %s; torch %s" % (card, torch.__version__), file=sys.stderr)

    gen_cfg = default_config("NACF", dataset="MSRVTT", vocab_size=p["vocab"], n_frames=8,
                             n_total_frames=16)
    corpus, refs, feats = make_hard_synthetic(
        gen_cfg, n_videos=p["videos"], n_classes=p["classes"], vocab_size=p["vocab"],
        n_caps=p["caps"], n_total_frames=16, role_features=True,
        modifier_distractors=True, **p["corpus_kw"])
    data_dir = os.path.join(args.workdir, "data")
    write_dataset(gen_cfg, corpus, refs, data_dir)
    oracle, majority = calibration_scores(corpus, refs, p["videos"], p["classes"])
    print("[flagship] oracle test CIDEr %.4f, majority %.4f" % (
        oracle["CIDEr"], majority["CIDEr"]), file=sys.stderr)

    ckpt_root = os.path.join(args.workdir, "experiments")
    common = ["--dataset", "MSRVTT", "--default", "--base_data_path", data_dir,
              "--base_checkpoint_path", ckpt_root, "--batch_size", str(p["batch"]),
              "--epochs", str(p["epochs"]), "--n_frames", "8", "--n_total_frames", "16",
              "--save_checkpoint_every", "1", "--tolerence", "1000",
              "--device", args.device] + p["dim_args"]

    def scope(seed):
        return "flagship" if seed == 0 else "flagship_s%d" % seed

    def ckpt(method, seed=0):
        return os.path.join(ckpt_root, "MSRVTT", method, scope(seed), "best.ckpt")

    report = dict(
        protocol=("navc_tpu_torch on %s: corpus v3 (make_hard_synthetic, %d videos, %d "
                  "classes, %d captions a video, role_features, modifier_distractors), "
                  "MSRVTT --default, batch %d, %d epochs%s; the four methods at seed 0, NACF "
                  "and NAB at seeds %s against the seed-0 ARB teacher; the decode ablations "
                  "of scripts/flagship_quality.py through navc_tpu_torch.cli.translate at "
                  "every seed" % (
                      card, p["videos"], p["classes"], p["caps"], p["batch"], p["epochs"],
                      ", toy width (--small)" if args.small else ", d=512, vocab 10048",
                      " ".join(map(str, p["seeds"][1:])))),
        device=card, torch=torch.__version__, epochs=p["epochs"], batch_size=p["batch"],
        seeds=list(p["seeds"]), calibration=dict(oracle_test=oracle, majority_test=majority),
        methods={}, sweep={}, ablations={})

    def flush():
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")

    def train(method, seed):
        t0 = time.perf_counter()
        print("[flagship] training %s, seed %d ..." % (method, seed), file=sys.stderr)
        out = train_main(common + ["--scope", scope(seed), "--method", method,
                                   "--seed", str(seed)], in_memory_feats=feats)
        rec = dict(test_res=clean(out.get("test_res")),
                   wall_s=round(time.perf_counter() - t0, 1))
        if seed == 0:
            report["methods"][method] = dict(history=[clean(h) for h in out["history"]], **rec)
        else:
            report["sweep"]["%s_s%d" % (method, seed)] = rec
        flush()

    for method in METHODS:
        train(method, 0)
    for seed in p["seeds"][1:]:
        # --default derives the teacher from the scope: the seed-0 teacher there
        os.makedirs(os.path.dirname(ckpt("ARB", seed)), exist_ok=True)
        if not os.path.exists(ckpt("ARB", seed)):
            os.symlink(ckpt("ARB"), ckpt("ARB", seed))
        for student in STUDENTS:
            train(student, seed)

    nar_common = ["--dataset", "MSRVTT", "--evaluation_mode", "test",
                  "--batch_size", str(p["batch"]), "--beam_alpha", "1.35",
                  "--iterations", "5", "--length_beam_size", "6", "--paradigm", "mp",
                  "--teacher_path", ckpt("ARB")]
    for name, student, extra in ABLATION_SPECS:
        entry = report["ablations"][name] = dict(per_seed={})
        for seed in p["seeds"]:
            t0 = time.perf_counter()
            print("[flagship] ablation %s, seed %d ..." % (name, seed), file=sys.stderr)
            opt = build_parser().parse_args(["--model_path", ckpt(student, seed)]
                                            + nar_common + extra)
            res = translate(opt, device=args.device, info_corpus=corpus,
                            in_memory_feats=feats, references=refs)
            entry["per_seed"][str(seed)] = dict(clean(res["test"]),
                                                wall_s=round(time.perf_counter() - t0, 1))
            flush()
        ciders = [r["CIDEr"] for r in entry["per_seed"].values()]
        entry.update(CIDEr_mean=float(np.mean(ciders)), CIDEr_std=float(np.std(ciders)))

    if os.path.exists(args.reference) and not args.small:
        report["comparison"] = comparison(report, args.reference)
    report["wall_s"] = round(time.perf_counter() - t_start, 1)
    flush()
    print(json.dumps(dict(
        device=card, oracle_CIDEr=round(oracle["CIDEr"], 4),
        majority_CIDEr=round(majority["CIDEr"], 4),
        methods={m: dict(CIDEr=round(r["test_res"].get("CIDEr", float("nan")), 4),
                         wall_s=r["wall_s"]) for m, r in report["methods"].items()},
        ablations={a: "%.4f +/- %.4f" % (r["CIDEr_mean"], r["CIDEr_std"])
                   for a, r in report["ablations"].items()},
        comparison={k: (round(r["port_seed0"], 4), r["verdict"], r.get("verdict_mean"))
                    for k, r in report.get("comparison", {}).items()},
        wall_s=report["wall_s"]), indent=1))


if __name__ == "__main__":
    main()
