"""The open-loop knee of a cell (not run by the benchmark's own runs): one
set-up, then the cell's window at each of several rates.

    python benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 20 40 ...

Per rate one JSON line: requests, p50 and p95 latency (ms, from due time),
the mean latency of the window's first and last quarter of requests (a
backlog that grows shows as a last quarter far above the first), and how
far past the window's last due time the last answer came.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    import numpy as np
    import torch

    from benchmark import inputs, program

    work = harness.workload(args.workload)
    config = harness.config(work["config"])
    weights = {"student": inputs.make_weights(config["student"]["model"], args.seed, "cuda")}
    if "teacher" in config:
        weights["teacher"] = inputs.make_weights(config["teacher"]["model"], args.seed + 1,
                                                 "cuda")
    program.build_kernels()
    client = harness.traffic(work["traffic"]["kind"]).Client(dict(work["traffic"], rate=1.0),
                                                            config, args.seed, "cuda")
    cap = program.captioner(config, weights, "cuda", work["traffic"]["depth"])
    client.warm(cap)
    torch.cuda.synchronize()
    card = torch.cuda.get_device_name(0)
    for rate in args.rates:
        client.params["rate"] = rate
        t0 = time.perf_counter()
        reqs = client.window(cap, args.seconds, lambda name: contextlib.nullcontext())
        wall = time.perf_counter() - t0
        lat = np.array([r.done - r.due for r in reqs])
        q = max(1, len(lat) // 4)
        print(json.dumps(dict(cell=args.workload, card=card, rate=rate, requests=len(reqs),
                              videos=int(sum(r.videos for r in reqs)),
                              p50_ms=float(np.percentile(lat, 50) * 1e3),
                              p95_ms=float(np.percentile(lat, 95) * 1e3),
                              first_quarter_ms=float(lat[:q].mean() * 1e3),
                              last_quarter_ms=float(lat[-q:].mean() * 1e3),
                              drain_s=float(max(r.done for r in reqs) - max(r.due for r in reqs)),
                              wall_s=wall)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
