"""Corpus-preparation entry point (reference prepare_corpora.py), navc_tpu's
flags:

    python -m navc_tpu_torch.cli.prepare_corpora --dataset MSRVTT \
        --raw_path /path/to/videodatainfo.json --out_dir ./data/MSRVTT

It writes ``info_corpus.pkl`` and ``refs.pkl`` in navc_tpu's schema
(``data/corpus.py``); it needs no card and no torch.
"""

from __future__ import annotations

import argparse
import os

from ..data.corpus import prepare_corpus


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", type=str, required=True,
                   help="MSRVTT | Youtube2Text | MSVD")
    p.add_argument("--raw_path", type=str, required=True,
                   help="MSRVTT: videodatainfo.json; MSVD: refs pickle")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--count_thr", type=int, default=None,
                   help="default: 2 for MSRVTT, 0 for MSVD")
    p.add_argument("--sort_vocab", default=False, action="store_true")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    info_corpus, refs = prepare_corpus(
        args.dataset, args.raw_path,
        os.path.join(args.out_dir, "info_corpus.pkl"),
        os.path.join(args.out_dir, "refs.pkl"),
        count_thr=args.count_thr, sort_vocab=args.sort_vocab)
    print("vocab size: %d; videos: %d"
          % (len(info_corpus["info"]["itow"]), len(info_corpus["captions"])))


if __name__ == "__main__":
    main()
