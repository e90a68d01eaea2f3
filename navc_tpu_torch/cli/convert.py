"""Convert a reference PyTorch checkpoint into a navc_tpu ``.ckpt`` through
a port model (port of navc_tpu/cli/convert.py).

    python -m navc_tpu_torch.cli.convert best.pth.tar best.ckpt [--device cuda|cpu]

The ``.pth.tar`` (torch.save({'state_dict', 'settings', ...}) — reference
misc/utils.py:195-202) is read on the CPU. Its resolved reference opt
becomes the Config; the converted tree is validated leaf by leaf against a
fresh port model's exported tree (same paths and shapes), loaded into that
model on ``--device`` (default ``cuda``; without a card ask for ``cpu``),
and written from it in the ``.ckpt`` format that both packages read.
Unpickling runs code named by the file: convert only checkpoints you trust.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="reference .pth.tar checkpoint")
    ap.add_argument("dst", help="output .ckpt path")
    ap.add_argument("--device", default="cuda",
                    help="where the converted model is loaded (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config
    from ..convert import export_flax_variables, load_flax_variables
    from ..models import build_model
    from ..runtime.checkpoint import save_checkpoint
    from ..runtime.torch_convert import _flat_paths, convert_state_dict, validate_against

    ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
    if "state_dict" not in ckpt or "settings" not in ckpt:
        sys.exit("not a reference checkpoint: expected torch.save("
                 "{'state_dict', 'settings', ...}) (misc/utils.py:195-202)")
    cfg = Config.from_dict(dict(ckpt["settings"]))

    aux = [c for c in cfg.crit if c.lower() != "lang"]
    variables = convert_state_dict(ckpt["state_dict"], aux_crits=aux,
                                   tie_weights=cfg.tie_weights)
    model = build_model(cfg, device=args.device)
    validate_against(variables, export_flax_variables(model))
    load_flax_variables(model, variables)

    save_checkpoint({
        "epoch": ckpt.get("epoch", 0),
        "model": model,
        "opt_state": None,
        "validate_result": ckpt.get("validate_result", {}),
        "settings": cfg,
    }, os.path.dirname(os.path.abspath(args.dst)) or ".", os.path.basename(args.dst))
    print("converted %s -> %s (%d parameter leaves, loaded on %s, method=%s, vocab=%d)"
          % (args.src, args.dst, len(_flat_paths(variables)), args.device,
             cfg.method or cfg.decoding_type, cfg.vocab_size))


if __name__ == "__main__":
    main()
