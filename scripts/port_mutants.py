#!/usr/bin/env python3
"""Mutation check of the redesigned kernels (K11, K12a, K12b, K2, K1, K6,
K7, K1u) and of the decodes' CUDA graphs (runtime/graphs.py, the beam's
blocks) on a card.

Each mutant is one exact edit of a file of navc_tpu_torch, made in a copy of
the package under a temporary directory (never in the checkout); the
`cuda` tests of tests/test_torch_port_cuda.py that cover it (the
training tests, K2's, K1's walk tests, K6's, K7's, K1u's or the graphs')
then run against the copy, all mutants at once, one process each. A mutant
that no test fails is reported as surviving and the script exits 1. Run
from the repo root on a machine with an NVIDIA card:

    python3 scripts/port_mutants.py [TESTS ...]

where TESTS (e.g. ``graphs``) keeps only the mutants whose tests are named
so.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUTANTS = {  # name: (file under navc_tpu_torch, text, its replacement, tests)
    "a product skips its last k-step": (
        "csrc/row_gemm.cuh", "for (int k = 0; k < RG_BK / 16; ++k) {",
        "for (int k = 0; k < RG_BK / 16 - (c == chunks - 1); ++k) {", "train"),
    "a part sum drops the last sequence of a tile": (
        "csrc/row_gemm.cuh", "for (int i = 0; i < g.valid; ++i) sum +=",
        "for (int i = 0; i < (sq == per - 1 ? 0 : g.valid); ++i) sum +=", "train"),
    "a dropout lattice row off by one": (
        "csrc/fused_layer_train.cu", "s[e] = dr.hidden(y, SITE_SELF_OUT, i, c + e);",
        "s[e] = dr.hidden(y, SITE_SELF_OUT, i + 1, c + e);", "train"),
    "the causal mask off by one": (
        "csrc/fused_layer_train.cu",
        "auto self_masked = [=](int i, int j) { return kmask[j] > 0.5f || (causal && j > i); };",
        "auto self_masked = [=](int i, int j) { return kmask[j] > 0.5f || (causal && j > i + 1); };",
        "train"),
    "K11: the cross-out dropout on the self-out site": (
        "csrc/fused_layer_train.cu", "v[e] + g.bias[0][c + e], SITE_CROSS_OUT, i, c + e)",
        "v[e] + g.bias[0][c + e], SITE_SELF_OUT, i, c + e)", "train"),
    "K11: r2's residual dropped from the last epilogue": (
        "csrc/fused_layer_train.cu", "SITE_FFN_DOWN, i, c + e) +\n                                   r2v[e],",
        "SITE_FFN_DOWN, i, c + e),", "train"),
    "K2: an unused slot left unzeroed": (
        "csrc/fused_layer.cu", "npm = (a.qidx ? a.qidx[r] >= 0 : !a.kp[r])",
        "npm = (a.qidx ? (EPI == S_OUT || a.qidx[r] >= 0) : !a.kp[r])", "qsub"),
    "K2: the query LayerNorm reads raw instead of the <mask> row": (
        "csrc/fused_layer.cu", "x[j] = __bfloat162float(a.mrow[c]) +",
        "x[j] = __bfloat162float(a.raw[((size_t)n * L + max(pos, 0)) * H + c]) +", "qsub"),
    "K1: the causal term dropped from the self mask": (
        "csrc/fused_layer.cu", "return kmask_p[j] > 0.5f || (causal && j > i); });",
        "return kmask_p[j] > 0.5f || (causal && j > i + L); });", "fused_layer_walk"),
    "K1: the S_OUT multiplier fixed at 1 (PAD rows not zeroed)": (
        "csrc/fused_layer.cu", "npm = (a.qidx ? a.qidx[r] >= 0 : !a.kp[r])",
        "npm = (a.qidx ? a.qidx[r] >= 0 : (EPI == S_OUT || !a.kp[r]))", "fused_layer_walk"),
    "K6: the tpos row left out of its run's partial": (
        "csrc/beam_attend.cu", "const float e = expf(sr[p] - mx);",
        "const float e = p0 + p < tpos ? expf(sr[p] - mx) : 0.f;", "beam_attend_step"),
    "K6: the merge takes the runs' sums out of order": (
        "csrc/beam_attend.cu", "acc += __ldcg(&a[(size_t)j * H]) *",
        "acc += __ldcg(&a[(size_t)(runs - 1 - j) * H]) *", "beam_attend_step"),
    "K7: the last position left out of the weighted V sum": (
        "csrc/beam_attend.cu", "load2<T>(vs + p * ldk + c, v);",
        "if (p < te - 1) load2<T>(vs + p * ldk + c, v); else v[0] = v[1] = 0.f;",
        "cross_attend"),
    "K7: a head group's K/V staged one head off": (
        "csrc/beam_attend.cu", "return (size_t)p * H + c0 + e;",
        "return (size_t)p * H + (c0 + e + dh) % H;", "cross_attend"),
    "K1u: the output skips the PAD multiplier": (
        "csrc/fused_layer_train.cu", "SITE_FFN_FINAL, i, c + e) * npm;",
        "SITE_FFN_FINAL, i, c + e);", "unfolded"),
    "graphs: outputs returned without a clone": (
        "runtime/graphs.py", "return clone_tensors(self.graph.replay())",
        "return self.graph.replay()", "graphs"),
    "graphs: arguments not copied into the static inputs": (
        "runtime/graphs.py", "buf.copy_(x)", "pass", "graphs"),
    "graphs: a replay adds no launches": (
        "runtime/graphs.py", "_build.add_launches(self.launches)", "pass", "graphs"),
    "graphs: no collection before the capture": (
        "runtime/graphs.py", "    gc.collect()\n", "", "graphs"),
    "graphs: the beam's features not copied into its static input": (
        "decoding/beam.py", "self.static[0].copy_(enc_output)", "pass", "graphs"),
}


def main():
    keep = sys.argv[1:]
    work = tempfile.mkdtemp(prefix="port_mutants_")
    procs = {}
    try:
        for k, (name, (src, old, new, tests)) in enumerate(MUTANTS.items()):
            if keep and tests not in keep:
                continue
            root = os.path.join(work, "m%d" % k)
            shutil.copytree(os.path.join(ROOT, "navc_tpu_torch"),
                            os.path.join(root, "navc_tpu_torch"),
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            shutil.copytree(os.path.join(ROOT, "tests"), os.path.join(root, "tests"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            path = os.path.join(root, "navc_tpu_torch", src)
            text = open(path).read()
            if text.count(old) != 1:
                sys.exit("mutant %r: its text is not in %s exactly once" % (name, src))
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            cmd = [sys.executable, "-m", "pytest", "tests/test_torch_port_cuda.py", "-q",
                   "--noconftest", "-p", "no:cacheprovider", "-k", tests]
            procs[name] = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True,
                                           env=dict(os.environ, PYTHONPATH=root))
        survived = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            tail = out.strip().splitlines()[-1] if out.strip() else "(no output)"
            failed = re.search(r"(\d+) failed", tail)
            print("%-48s %s" % (name, tail), flush=True)
            if not failed:
                survived.append(name)
        if survived:
            sys.exit("mutants no test failed: %s" % survived)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
