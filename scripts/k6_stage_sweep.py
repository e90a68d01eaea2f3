#!/usr/bin/env python3
"""K6 (beam_attend_step) on the card under several stage budgets.

The run length of K6's position-split pass is planned by
navc_tpu_torch/ops/beam_attend.py::attend_runs, which caps a block's shared
memory at STAGE_BYTES. This script sets STAGE_BYTES to each budget in turn
and times K6 at the ARB decode's shapes (beam 5, H 512, 8 heads, L 30, bf16
caches, tpos 14) at 320 rows (64 videos) and 5120 rows (B=1024): device ms
per call (CUDA events) and, from torch.profiler, the device ms of each
kernel it launches. Run from the repo root on a machine with an NVIDIA
card:

    python3 scripts/k6_stage_sweep.py [--budgets 32,48,64,96]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budgets", default="32,48,64,96",
                    help="stage budgets in KB, comma-separated")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as CS
    from navc_tpu_torch.ops import beam_attend as BA

    if not torch.cuda.is_available():
        sys.exit("k6_stage_sweep: needs an NVIDIA card")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(0)
    k, l, h, nh, tpos = 5, 30, 512, 8, 14
    for b in (64, 1024):
        n = b * k
        kc, vc = (torch.randn(n, l * h, generator=g).to(dev, torch.bfloat16) for _ in range(2))
        q, kt, vt = (torch.randn(n, h, generator=g).to(dev) for _ in range(3))
        prev_k = torch.randint(0, k, (b, k), generator=g).to(dev, torch.int32)
        amask = torch.zeros(n, l, device=dev)
        for kb in (int(x) for x in args.budgets.split(",")):
            BA.STAGE_BYTES = kb << 10
            def run():
                return BA.beam_attend_step(kc, vc, q, kt, vt, prev_k, amask, tpos, nh)
            ms = CS.device_ms(run)
            prof = CS.device_breakdown(lambda: [run() for _ in range(10)])
            parts = {}
            for name, (dev_ms, _) in ({} if prof is None else prof[2]).items():
                key = next((kn for kn in ("step_run_kernel", "step_merge_kernel")
                            if kn in name), "other")
                parts[key] = round(parts.get(key, 0.0) + dev_ms / 10, 4)
            print("rows %d, stage %d KB, (run, runs) %s: %.4f ms a call; %s"
                  % (n, kb, BA.attend_runs(b, k, tpos, h, nh, 2, sms), ms, parts), flush=True)


if __name__ == "__main__":
    main()
