"""One run of one cell of navc_tpu_torch's benchmark on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It makes the cell's inputs and weights
from the seed, builds the program and warms every shape the cell's traffic
sends (set-up), measures for ``--seconds`` (with ``--trace 1`` under
torch.profiler), checks what the window produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` (traced
runs) and ``check`` (each compared number beside its limit, also the last
lines on standard error). It exits non-zero, printing no result, without a
card (or with fewer than the cell asks for), or if ``jax``, ``jaxlib``,
``flax`` or ``navc_tpu`` was loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    bench = harness.spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print("run.py: no cell %r in BENCHMARK.json" % args.workload, file=sys.stderr)
        return 2
    work = harness.workload(args.workload)

    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("run.py: the cell needs %d CUDA device(s); torch sees %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else "none"),
            file=sys.stderr)
        return 3
    client = harness.traffic(work["traffic"]["kind"])
    ctx = dict(cell=args.workload, workload=work, seed=args.seed, seconds=args.seconds,
               trace=bool(args.trace), device="cuda", t0=T0)
    parts = client.run(ctx) if hasattr(client, "run") else _serve(ctx, client)
    line = harness.result_line(parts["run"], harness.metrics_for(bench, args.workload,
                                                                 bool(args.trace)),
                               parts["correct"], parts["attempted"], parts["failed"],
                               parts["device"], parts["checks"])
    found = harness.forbidden_modules()
    if found:
        print("run.py: this process loaded %s; the benchmark runs none of %s"
              % (found, list(harness.FORBIDDEN)), file=sys.stderr)
        return 4
    print("run.py: seconds by phase %s" % json.dumps(parts["run"].extra.get("phases", {})),
          file=sys.stderr)
    for name, c in parts["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _serve(ctx, client):
    from benchmark import serving

    return serving.run(ctx, client.Client)


if __name__ == "__main__":
    sys.exit(main())
