"""The readings that an MLAMoE cell's limits are set from (not run by the
benchmark's own runs).

    python benchmark/lm_calibrate.py --workload <cell> --seeds 1 2 ... --seconds <s> \
        [--controls N] [--out FILE] [--fault NAME] [--dump DIR]

For each seed it makes a whole run of the cell (``traffic/lm_closed_loop``'s
run: window and check) in this one process and reads the program's
logprob_err and beam_rank_violation. For the first ``--controls`` seeds it
also reads the control, the reference in float8 (e4m3, per-tensor scales,
the precision below the configuration's bfloat16) on the same served
captions: its teacher-forced log-probability of each served token against
the float32 reference's (``logprob_err``), and the share of positions whose
float8 best token lies, by the float32 reference, below its k-th best by
more than the rank tolerance (``beam_rank_violation``: what a decoder in
float8 would have chosen). One JSON line per seed, on standard output and
appended to FILE. ``--fault`` plants one of ``lm_faults.FAULTS`` in the
program first: what the check reads of a broken path. ``--dump`` writes each
seed's checked answers and the readings of them, token by token, to
DIR/<fault or program>_<seed>.npz.
"""

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def control(config, weights, client, refs, tol, device="cuda"):
    """The float8 reference's readings on the served captions ``refs``
    (each pool's entry gains its token by token readings, ``lp8`` and
    ``lp_best``)."""
    from benchmark.lm_check import reference_readings, through_eos

    err = viol = count = 0.0
    for pool, r in refs.items():
        feats = client.pools[pool][0]
        lp8, _, best8 = reference_readings(config, weights, feats, r["rows"], r["tokens"],
                                           device, "fp8")
        lp_best, _, _ = reference_readings(config, weights, feats, r["rows"], r["tokens"],
                                           device, score=best8)
        r.update(lp8=lp8, lp_best=lp_best)
        mask = through_eos(r["tokens"])
        err += float((np.abs(lp8 - r["ref_lp"]) * mask).sum())
        viol += float(((lp_best < r["kth"] - tol) & mask).sum())
        count += float(mask.sum())
    return err / count, viol / count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--controls", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None, help="one of lm_faults.FAULTS")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    import torch

    if args.fault:
        from benchmark.lm_faults import FAULTS

        FAULTS[args.fault](setattr)

    work = harness.workload(args.workload)
    kind = harness.traffic(work["traffic"]["kind"])
    card = torch.cuda.get_device_name(0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        parts = kind.run(dict(cell=args.workload, workload=work, seed=seed,
                              seconds=args.seconds, trace=False, device="cuda", t0=t0))
        checks = parts["checks"]
        row = dict(cell=args.workload, seed=seed, card=card, fault=args.fault,
                   logprob_err=checks["logprob_err"]["value"],
                   beam_rank_violation=checks["beam_rank_violation"]["value"],
                   unanswered=checks["unanswered"]["value"],
                   requests=len(parts["run"].requests), setup_s=parts["run"].setup_s)
        if i < args.controls:
            t1 = time.perf_counter()
            row["fp8_logprob_err"], row["fp8_beam_rank_violation"] = control(
                parts["run"].config, parts["weights"], parts["client"], parts["refs"],
                work["check"]["rank_tolerance"])
            row["fp8_s"] = time.perf_counter() - t1
        row["seconds"] = time.perf_counter() - t0
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.savez(os.path.join(args.dump, "%s_%d.npz" % (args.fault or "program", seed)),
                     **{"%d_%s" % (pool, k): v for pool, r in parts["refs"].items()
                        for k, v in r.items()})
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
