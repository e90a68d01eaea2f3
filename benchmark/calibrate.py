"""The readings that a serving cell's limits are set from (not run by the
benchmark's own runs).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... --seconds <s> \
        [--controls N] [--out FILE]

For each seed it makes a whole run of the cell, window and check included,
in this one process, and reads the program's caption_mismatch against the
reference. For the first ``--controls`` seeds it also puts the control in
the program's place: the reference in float8 (e4m3, per-tensor scales, the
precision below the configuration's bfloat16) captions the same videos, and
its mismatch against the reference is the control's reading; beside it, the
reference in float32, for information. One JSON line per seed, on standard
output and appended to FILE.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def differ_share(other, refs):
    """The share of the check's videos whose captions in ``other`` differ
    from the reference's ``refs`` (both {pool: captions})."""
    compared = sum(ref.shape[0] for ref in refs.values())
    differ = sum(int((other[p] != ref).any(1).sum()) for p, ref in refs.items())
    return differ / compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    import gc

    import torch

    from benchmark import serving
    from benchmark.check import mismatch, reference_captions

    work = harness.workload(args.workload)
    if args.rate is not None:
        work["traffic"]["rate"] = args.rate
    limits = work["check"]["limits"]
    if limits["caption_mismatch"] is None:
        limits["caption_mismatch"] = 1.0
    client_mod = harness.traffic(work["traffic"]["kind"])
    card = torch.cuda.get_device_name(0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        parts = serving.run(dict(cell=args.workload, workload=work, seed=seed,
                                 seconds=args.seconds, trace=False, device="cuda", t0=t0),
                            client_mod.Client)
        row = dict(cell=args.workload, seed=seed, card=card,
                   program=parts["checks"]["caption_mismatch"]["value"],
                   unanswered=parts["checks"]["unanswered"]["value"],
                   requests=len(parts["run"].requests), setup_s=parts["run"].setup_s)
        if i < args.controls:
            client, weights, refs = parts["client"], parts["weights"], parts["refs"]
            config = parts["run"].config
            others = {}
            for name in ("fp8", "fp32"):
                t1 = time.perf_counter()
                others[name] = {pool: reference_captions(config, weights, feats, cat,
                                                         client.check_rows(pool), "cuda", name)
                                for pool, (feats, cat) in enumerate(client.pools)}
                row[name] = differ_share(others[name], refs)
                row[name + "_s"] = time.perf_counter() - t1
            # the program against the float32 reference, for information
            compared, differ = mismatch(client, parts["run"].requests, others["fp32"])
            row["program_vs_fp32"] = differ / max(1, compared)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del parts
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
