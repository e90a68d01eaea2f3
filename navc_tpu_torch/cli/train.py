"""Training entry point (port of navc_tpu/cli/train.py, reference train.py).

    python -m navc_tpu_torch.cli.train --default --dataset MSRVTT --method NACF \
        --base_data_path /path/to/VC_data --base_checkpoint_path ./experiments \
        [--device cuda|cpu] [--resume] [--distributed]

``--device`` (default ``cuda``) picks where the model trains; without a card
ask for ``cpu``. ``--resume`` continues from the run directory's rolling
``checkpoint.ckpt``. ``--distributed`` joins the process group
(``parallel.initialize``: ``NAVC_COORDINATOR`` / ``NAVC_NUM_PROCESSES`` /
``NAVC_PROCESS_ID``, else torch's ``env://`` variables;
every rank runs this same command line) and, with more than one rank,
trains through ``train_network_all_multihost`` (``--resume`` is then
refused, as navc_tpu refuses it). navc_tpu's compile cache has no
counterpart: the kernels' build directory is hashed (``ops/_build.py``).
HDF5 feature files need h5py; ``main(argv, in_memory_feats=...)``
takes the features from memory instead (as ``cli.translate.translate``
does), for a host without it.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random

from ..config import resolve_data_paths, where_to_save_model
from ..parallel import distributed
from ..runtime.loop import train_network_all
from .opts import parse_config


def main(argv=None, in_memory_feats=None):
    """Train as the command line ``argv`` says; ``in_memory_feats`` maps
    'feats_<ch>' to {video id: (frames, dim) array} in place of the feature
    files. Returns ``train_network_all``'s result (or
    ``train_network_all_multihost``'s)."""
    import sys
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    pre.add_argument("--resume", action="store_true")
    pre.add_argument("--distributed", action="store_true")
    args, rest = pre.parse_known_args(list(sys.argv[1:] if argv is None else argv))
    if args.distributed:
        distributed.initialize(device=args.device)

    cfg = parse_config(rest)
    if cfg.seed == -1:
        cfg = cfg.replace(seed=random.randint(1, 65534))
    cfg = resolve_data_paths(cfg)
    workdir = where_to_save_model(cfg)
    os.makedirs(workdir, exist_ok=True)
    cfg = cfg.replace(checkpoint_path=workdir)

    # vocab size from the corpus, before model construction (train.py:73)
    with open(cfg.info_corpus, "rb") as f:
        info_corpus = pickle.load(f)
    cfg = cfg.replace(vocab_size=len(info_corpus["info"]["itow"]))

    with open(os.path.join(workdir, "opt_info.json"), "w") as f:
        json.dump(cfg.to_dict(), f)
    print("save opt details to %s" % os.path.join(workdir, "opt_info.json"))
    print("| method %s | vocab_size %d | modality %s | max_len %d | seed %d | device %s"
          % (cfg.method, cfg.vocab_size, cfg.modality, cfg.max_len, cfg.seed, args.device))

    loop_kw = dict(workdir=workdir, info_corpus=info_corpus,
                   in_memory_feats=in_memory_feats, device=args.device)
    if args.distributed and distributed.process_count() > 1:
        if args.resume:
            raise NotImplementedError(
                "--resume is single-host only (the multi-host rolling checkpoint "
                "stores no optimizer state)")
        from ..runtime.distributed_loop import train_network_all_multihost
        out = train_network_all_multihost(cfg, **loop_kw)
    else:
        out = train_network_all(cfg, resume=args.resume, **loop_kw)
    if "test_res" in out:
        print({k: v for k, v in out["test_res"].items()})
    return out


if __name__ == "__main__":
    main()
