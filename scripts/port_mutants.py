#!/usr/bin/env python3
"""Mutation check of the redesigned kernels (K11, K12a, K12b, K2, K1, K6,
K7, K1u), of the decodes' CUDA graphs (runtime/graphs.py, the beam's
blocks; the IF nodes of the compiled l2r and ef, csrc/graph_cond.cu, their
counters, ef's loop condition and the lagged flag read), of the
captured training step (runtime/train_step.py, its seed, lr and generator),
of navc_tpu's route switches (a switch read but its route kept), of
``cfg.remat``'s recompute (fresh dropout masks, running statistics moved
twice) and of data and tensor parallelism (the gradient all-reduce, the
global BatchNorm statistics and loss denominator, a TP slice's gradient) on
a card.

Each mutant is one exact edit of a file of navc_tpu_torch, made in a copy of
the package under a temporary directory (never in the checkout); the
`cuda` tests of tests/test_torch_port_cuda.py that cover it (the
training tests, K2's, K1's walk tests, K6's, K7's, K1u's, the graphs' or
the captured step's) then run against the copy, one process each, at most
JOBS (4) at once; a mutant of the ``parallel`` group must also make
chip_smoke.py's parallel phase, run alone in the copy, exit non-zero.
The kernels are built once in the checkout first and each
copy starts from that build, so a copy rebuilds only a source its edit
changed. Beside the mutants, one unedited copy per group of tests (the
control) runs the same tests under the same load: a control that does not
pass them all voids the run. A mutant that no test fails is reported as
surviving. The script exits 1 if a control fails or a mutant survives. Run
from the repo root on a machine with an NVIDIA card:

    python3 scripts/port_mutants.py [TESTS ...]

where TESTS (e.g. ``graphs``, ``cond_graphs``, ``train_graphs``, ``switch``,
``remat``, ``parallel``) keeps only the mutants whose tests are named so.
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

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
    "graphs: a loop's arguments (the beam's, ef's) not copied into its static inputs": (
        "runtime/graphs.py", "static.copy_(x)", "pass", "graphs"),
    "when: the IF node's predicate inverted": (
        "csrc/graph_cond.cu", "cudaGraphSetConditional(handle, *pred ? 1u : 0u);",
        "cudaGraphSetConditional(handle, *pred ? 0u : 1u);", "cond_graphs"),
    "when: a body's runs not counted": (
        "runtime/graphs.py", "                counter.add_(1)\n", "", "cond_graphs"),
    "ef: the loop condition without its stall term": (
        "decoding/mask_predict.py", "return (total > 0) & (total != pre)", "return total > 0",
        "cond_graphs"),
    "lagged_blocks: a block's flag read without its lag": (
        "runtime/graphs.py",
        "        if pending is not None:\n            reads += 1\n            if pending():\n",
        "        if True:\n            reads += 1\n            if read():\n", "cond_graphs"),
    "when: the body captured on a stream of PyTorch's pool": (
        "runtime/graphs.py",
        "stream, pool = _body_stream(pred.device.index), torch.cuda.graph_pool_handle()",
        "stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()", "cond_graphs"),
    "train graphs: the fused layer's seed read on the host": (
        "ops/fused_layer_train.py", "    opts = _Opts(int(n_head),",
        "    seed = seed_value(seed)\n    opts = _Opts(int(n_head),", "train_graphs"),
    "train graphs: the lr baked in as a float": (
        "runtime/optim.py", 'group["lr"].fill_(lr)', 'group["lr"] = lr', "train_graphs"),
    "train graphs: the device generator not reseeded": (
        "runtime/train_step.py", "        dropout_gen.manual_seed(int(draws[0]))\n", "",
        "train_graphs"),
    "train graphs: a graph kept after optimizer.load_state_dict": (
        "runtime/train_step.py", "        _drop_graphs_on_reload(opt, jitted)\n", "",
        "train_graphs"),
    "train graphs: the dropout generator not registered with the capture": (
        "runtime/graphs.py", "self.graph.register_generator_state(gen)", "pass",
        "train_graphs"),
    "switches: NAVC_NO_ATTEND_KERNEL read but K6 kept": (
        "decoding/beam.py", "and beam_attend_eligible(b, h) and not switches.no_attend)",
        "and beam_attend_eligible(b, h))", "switch"),
    "switches: NAVC_DENSE_REFINE read but the sparse steps kept": (
        "decoding/mask_predict.py", "        if sparse:\n            predict.predict_sub",
        "        if ops is not None:\n            predict.predict_sub", "switch"),
    "switches: NAVC_NO_FUSED_CE read but K9 / K10 kept": (
        "runtime/train_step.py", "return cls(layer, layer and fused_vocab_ce_eligible(cfg))",
        "return cls(layer, layer)", "switch"),
    "remat: the recompute draws fresh dropout masks": (
        "runtime/train_step.py", "        drawing[0] = self.replay\n", "", "remat"),
    "remat: the recompute moves the running statistics again": (
        "runtime/train_step.py", "                    t.copy_(k)\n", "                    pass\n",
        "remat"),
    "parallel: the gradient all-reduce dropped": (
        "runtime/train_step.py", "        D.all_reduce_(flat, self.group)\n", "", "parallel"),
    "parallel: BatchNorm statistics left local": (
        "models/fusion.py", "        sums = all_reduce(sums, group)\n", "", "parallel"),
    "parallel: the loss denominator left local": (
        "runtime/crit.py", "        all_reduce_(batch_denom, group)\n", "        pass\n",
        "parallel"),
    "parallel: a TP slice's gradient from the other rank's part": (
        "parallel/mesh.py", "part = s.full.grad.narrow(s.dim, self.mesh.model_index * n, n)",
        "part = s.full.grad.narrow(s.dim, (self.mesh.model - 1 - self.mesh.model_index) * n, "
        "n)", "parallel"),
}


CONTROL = "control (no edit)"
JOBS = 4  # test processes at once: the card and its host cores are shared by them all
# groups whose mutants chip_smoke.py's phase must also catch: the phase alone,
# in the copy
SMOKE = {"parallel": "import chip_smoke; chip_smoke.parallel_phase('mutant check')"}


def copy_tree(work, k, edit=None):
    """A copy of the package (its kernel build included) and the tests
    under ``work``, with ``edit`` = (file, text, replacement) made."""
    root = os.path.join(work, "m%d" % k)
    shutil.copytree(os.path.join(ROOT, "navc_tpu_torch"), os.path.join(root, "navc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "tests"), os.path.join(root, "tests"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), root)
    if edit:
        src, old, new = edit
        path = os.path.join(root, "navc_tpu_torch", src)
        text = open(path).read()
        if text.count(old) != 1:
            sys.exit("mutant: %r is not in %s exactly once" % (old, src))
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main():
    keep = sys.argv[1:]
    sys.path.insert(0, ROOT)
    from navc_tpu_torch.ops import _build

    _build.build()
    work = tempfile.mkdtemp(prefix="port_mutants_")
    chosen = [(name, m) for name, m in MUTANTS.items() if not keep or m[3] in keep]
    groups = sorted({m[3] for _, m in chosen})
    pytest = [sys.executable, "-m", "pytest", "tests/test_torch_port_cuda.py", "-q",
              "--noconftest", "-p", "no:cacheprovider", "-k"]
    jobs = [("%s: %s" % (CONTROL, g), None, g) for g in groups] + [
        (name, (src, old, new), tests) for name, (src, old, new, tests) in chosen]
    queue = [(name, edit, pytest + [tests]) for name, edit, tests in jobs] + [
        ("%s [chip_smoke.py]" % name, edit, [sys.executable, "-c", SMOKE[tests]])
        for name, edit, tests in jobs if tests in SMOKE]
    running, tails = {}, {}
    try:
        for k, (name, edit, cmd) in enumerate(queue):
            while len(running) >= JOBS:
                wait_one(running, tails)
            root = copy_tree(work, k, edit)
            with open(os.path.join(root, "pytest.out"), "w") as out:
                running[name] = subprocess.Popen(cmd, cwd=root, stdout=out,
                                                 stderr=subprocess.STDOUT,
                                                 env=dict(os.environ, PYTHONPATH=root))
                running[name].out = out.name
        while running:
            wait_one(running, tails)
        void, survived = [], []
        for name, _, _ in queue:
            tail = tails[name]
            print("%-66s %s" % (name, tail), flush=True)
            if name.endswith("[chip_smoke.py]"):  # the phase exits non-zero on a fault
                passed = tail.startswith("exit 0:")
                failed = not passed
            else:
                failed = re.search(r"(\d+) (failed|error)", tail)
                passed = not failed and re.search(r"\d+ passed", tail)
            if name.startswith(CONTROL):
                if not passed:
                    void.append(name)
            elif not failed:
                survived.append(name)
        if void:
            sys.exit("controls that did not pass (the run is void): %s" % void)
        if survived:
            sys.exit("mutants no test failed: %s" % survived)
    finally:
        for proc in running.values():
            proc.kill()
        shutil.rmtree(work, ignore_errors=True)


def wait_one(running, tails):
    """Wait for one of the running processes and keep its last line."""
    while True:
        for name, proc in list(running.items()):
            if proc.poll() is not None:
                with open(proc.out) as f:
                    out = f.read().strip()
                tails[name] = out.splitlines()[-1] if out else "(no output)"
                if name.endswith("[chip_smoke.py]"):
                    tails[name] = "exit %d: %s" % (proc.returncode, tails[name][-300:])
                del running[name]
                return
        time.sleep(1)


if __name__ == "__main__":
    main()
