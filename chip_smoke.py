#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (navc_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from navc_tpu_torch/csrc with nvcc and
drives the two ported serving paths at full width (random weights from a
seed). NACF: each of K1-K4 held against its plain PyTorch version at the
NACF main path's shapes and timed; four 64-video requests through
StreamingCaptioner with an NACF student and ARB teacher, with the launch
counts and outputs checked; one more request profiled with torch.profiler
(device time by kernel, idle share); part of the first request decoded
again on the CPU through the plain versions. ARB beam search: each of K5-K8
held against its plain version at the ARB main path's shapes and timed;
four 64-video requests (K5, K6, K7 once per beam step) and one 60-video
request (K8 instead of K6) through StreamingCaptioner; one decode at
B=1024 under bench.py's protocol; one request profiled; 16 videos decoded
again on the CPU. Training: K11, K12a, K12b and the weight-gradient
reduction held against their plain versions at full width (B=64, dropout
0.5) and timed; the fused projection + cross-entropy K9 and K10 (both
launches) held against their plain versions at the B=64 NACF pass, untied,
tied and with a large bias, timed there and at B=2048 beside the logits
route on the same operands; 5 NACF steps of 64 videos through
run_train_epoch (launch counts, ms per step, peak memory, one step
profiled); bench.py's train protocol at B=2048 (profiled); one bf16 step of
16 videos against the CPU plain path; 20 steps on one batch at dropout 0.1
must lower the loss. K1u (the unfolded eval layer, which no path calls) is
held against its plain version at K1's shape. The entry point:
train_network_all at full width on a synthetic 320-video corpus, ARB for
one epoch, then NACF for two with that teacher (validation decodes through
K1-K7, steps through K9-K12). It exits non-zero on any failure, without a
CUDA device, and outside a checkout. Imports nothing of JAX or navc_tpu.

Standard output ends with two JSON lines: {"kernels": [...]} and
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
N_VIDEOS, N_REQUESTS, CPU_VIDEOS = 64, 4, 8
PER_DECODE = {"fused_layer": 3, "fused_layer_qsub": 4, "project_argmax": 6,
              "project_gather_prob": 1}
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 rate outside the tensor cores
ARB_VIDEOS, ARB_RAGGED, ARB_BENCH, ARB_CPU = 64, 60, 1024, 16
ARB_KERNELS = ("project_topk", "beam_attend_step", "cross_attend",
               "permute_beam_caches")


def log(msg):
    print(msg, flush=True)


def die(msg):
    print("chip_smoke: FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call of a kernel too short to outrun its
    host wrapper: a device-side sleep holds the card while the host queues
    every call, so the events time the calls back to back and not the
    host's launch rate. Doubles the sleep until the queue was full in time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
    die("device_ms: the host could not queue %d calls within the sleep" % iters)


def device_ms_cold(fn, iters=20):
    """``device_ms`` of ``fn`` with its inputs out of L2: each call follows
    a write of a 64 MB buffer (the L2 holds 50 MB), and the write's own
    time, measured alone the same way, is subtracted."""
    import torch

    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    both = device_ms(lambda: (buf.fill_(1), fn()), iters)
    return both - device_ms(lambda: buf.fill_(1), iters)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def layer_flops(rows_q, rows_kv, n, le, h, inter):
    """Matmul FLOPs one fused layer needs for this data: K/V projections of
    the rows_kv non-PAD canvas rows; Q, output, cross Q/output, FFN and
    attention (over the sequence's non-PAD keys, rows_kv / n on average)
    for the rows_q real query rows. PAD rows need no work: their output is
    zero and their keys are masked."""
    return (2 * 2 * rows_kv * h * h
            + rows_q * (2 * h * h * 4 + 2 * 2 * h * inter
                        + 2 * 2 * (rows_kv / n) * h + 2 * 2 * le * h))


def layer_bytes(n, l, le, h, inter, rows_out, extra=0):
    weights = (8 * h * h + 2 * h * inter) * 2 + (8 * h + inter + h) * 4
    return (2 * n * l * h * 2 + n * l + 2 * n * le * h * 2 + weights
            + rows_out * h * 2 + 2 * h * 4 + extra)


def device_breakdown(run):
    """Profile ``run`` with torch.profiler: (window ms, device-busy ms,
    {kernel name: [device ms, launches]}), or None if the profiler saw no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = list(prof.events())
    # device events, without the spans of user annotations (torch.optim's
    # "Optimizer.step#Adam.step" marks its kernels on the device timeline)
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]
    if not kern:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    by_name = {}
    for e in kern:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return window / 1e3, busy / 1e3, by_name


def host_ops(run):
    """Counter of the top-level PyTorch operators ``run`` issues on the host
    (those not called from another operator), from torch.profiler."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    ops = collections.Counter()
    for e in prof.events():
        parent = e.cpu_parent
        if e.name.startswith("aten::") and (
                parent is None or not parent.name.startswith("aten::")):
            ops[e.name] += 1
    return ops


def print_profile(prof, what="request"):
    if prof is None:
        log("profiler: no device activity recorded (breakdown not measured)")
        return
    window, busy, by_name = prof
    log("profile of one %s: window %.3f ms, device busy %.3f ms, "
        "idle share %.3f" % (what, window, busy, 1.0 - busy / window))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, count) in top[:14]:
        log("  %8.3f ms %4d x  %s" % (ms, count, name[:90]))
    rest = sum(ms for _, (ms, _) in top[14:])
    log("  %8.3f ms        (%d other kernels)" % (rest, max(0, len(top) - 14)))


def check_captions(hyp, b, max_len, v, eos, pad):
    """(b, max_len - 1) int32 ids in [0, v); nothing but PAD after an EOS."""
    import numpy as np

    if hyp.shape != (b, max_len - 1) or hyp.dtype != np.int32:
        die("ARB hypotheses of shape %s %s" % (hyp.shape, hyp.dtype))
    if hyp.min() < 0 or hyp.max() >= v:
        die("ARB token ids out of range")
    after_eos = np.cumsum(hyp == eos, axis=1) - (hyp == eos) > 0
    if np.any(hyp[after_eos] != pad):
        die("ARB: a non-PAD token follows an EOS")


def arb_phases(cfg, model, cpu_model, record):
    """K5-K8 against their plain versions at the ARB main path's shapes, then
    ARB serving through StreamingCaptioner. Returns ({kernel: record},
    {kernel: launches on the ARB main path})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops.beam_attend import (beam_attend_step,
                                                beam_attend_step_plain,
                                                cross_attend,
                                                cross_attend_plain)
    from navc_tpu_torch.ops.beam_permute import (permute_beam_caches,
                                                 permute_beam_caches_plain)
    from navc_tpu_torch.ops.vocab_fused import (project_topk,
                                                project_topk_plain,
                                                projection_weights)
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    # the card's bf16 GEMMs accumulate in float32 throughout, as the CPU's
    # do: the cached step's dense layers then round once, where the port
    # (and flax Dense(dtype=bf16)) round
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    h, nh, v, k, l = (cfg.dim_hidden, cfg.num_attention_heads, cfg.vocab_size,
                      cfg.beam_size, cfg.max_len)
    b = ARB_VIDEOS
    n, te = b * k, len(cfg.modality) * cfg.n_frames
    log("ARB d=%d heads=%d ffn=%d vocab=%d max_len=%d beam=%d alpha=%.2f "
        "Te=%d: %d videos = %d beam rows" % (h, nh, cfg.intermediate_size, v, l,
                                             k, cfg.beam_alpha, te, b, n))
    g = torch.Generator(device="cpu").manual_seed(321)
    recs = {}

    # K5: projection + top-k, with and without a bias
    w16, _ = projection_weights(model)
    hid = (torch.randn(n, h, generator=g) * 2).to(dev, torch.bfloat16)
    bias = (torch.randn(v, generator=g) * 0.1).to(dev)
    scores = hid.float() @ w16.float().t()
    err = 0.0
    for bb in (None, bias):
        lp, ids = project_topk(hid, w16, k, bb)
        lp_p, ids_p = project_topk_plain(hid, w16, k, bb)
        sc = scores if bb is None else scores + bb
        srt = sc.sort(dim=-1, descending=True).values[:, :k + 1]
        clear = (srt[:, :-1] - srt[:, 1:]) > 1e-3
        bad = int(((ids != ids_p) & clear).sum())
        log("project_topk%s ids: %d of %d differ where the gap to the next "
            "candidate > 1e-3 (%d within 1e-3)" % (
                "" if bb is None else "[bias]", bad, n * k, int((~clear).sum())))
        if bad:
            die("project_topk ids disagree with the plain version")
        err = max(err, float((lp - lp_p).abs().max()))
    recs["project_topk"] = record(
        "project_topk", err, 1e-4,
        device_ms(lambda: project_topk(hid, w16, k)),
        device_ms(lambda: project_topk_plain(hid, w16, k), iters=5),
        2 * n * h * v, n * h * 2 + v * h * 2 + n * k * 8,
        lib_ms=device_ms(lambda: torch.matmul(hid, w16.t())),
        note="  (max_err: log-prob, absolute)")

    # K6: single steps at tpos 0, 14, 29, then every step of a decode
    def step_inputs(tpos):
        q, kt, vt = (torch.randn(n, h, generator=g).to(dev) for _ in range(3))
        prev_k = torch.randint(0, k, (b, k), generator=g).to(dev, torch.int32)
        mask = torch.arange(l)[None, :] > tpos
        mask = mask | ((torch.rand(n, l, generator=g) < 0.1) & (torch.arange(l) > 0))
        mask[:, tpos] = False
        return q, kt, vt, prev_k, torch.where(mask, -1e7, 0.0).to(dev)

    def caches():
        return tuple(torch.randn(n, l * h, generator=g).to(dev, torch.bfloat16)
                     for _ in range(2))

    def step_err(kc, vc, args, tpos):
        rk, rv = kc.clone(), vc.clone()
        ok, ov, att = beam_attend_step(kc, vc, *args, tpos, nh)
        rk, rv, ratt = beam_attend_step_plain(rk, rv, *args, tpos, nh)
        lim = (tpos + 1) * h
        if not (torch.equal(ok[:, :lim], rk[:, :lim])
                and torch.equal(ov[:, :lim], rv[:, :lim])):
            die("beam_attend_step caches differ from the plain version at "
                "tpos %d" % tpos)
        return float((att - ratt).abs().max())

    err = 0.0
    for tpos in (0, 14, 29):
        err = max(err, step_err(*caches(), step_inputs(tpos), tpos))
    kc = torch.zeros(n, l * h, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    for tpos in range(l - 1):
        args = step_inputs(tpos)
        if tpos == 0:
            args[3].zero_()
        err = max(err, step_err(kc, vc, args, tpos))
    log("beam_attend_step: single steps at tpos 0, 14, 29 and a chained "
        "%d-step decode agree with the plain version" % (l - 1))
    tpos = 14
    kc, vc = caches()
    args = step_inputs(tpos)
    pk, pv = kc.clone(), vc.clone()
    att_bytes = (2 * n * tpos * h * 2 + 3 * n * h * 4 + n * 4 + n * (tpos + 1) * 4
                 + 2 * n * (tpos + 1) * h * 2 + n * h * 4)
    recs["beam_attend_step"] = record(
        "beam_attend_step", err, 1e-4,
        device_ms(lambda: beam_attend_step(kc, vc, *args, tpos, nh)),
        device_ms(lambda: beam_attend_step_plain(pk, pv, *args, tpos, nh), iters=5),
        4 * n * (tpos + 1) * h, att_bytes, peak=PEAK_F32_FLOPS,
        note="  (tpos %d; max_err: attention, absolute; library_ms null: no "
             "one PyTorch call permutes, appends and attends)" % tpos)

    # K7: cross-attention over the Te encoder positions
    q = torch.randn(n, h, generator=g).to(dev)
    ke = torch.randn(b, te, h, generator=g).to(dev, torch.bfloat16)
    ve = torch.randn(b, te, h, generator=g).to(dev, torch.bfloat16)
    err = float((cross_attend(q, ke, ve, nh) - cross_attend_plain(q, ke, ve, nh)
                 ).abs().max())
    dh = h // nh
    q4 = q.to(torch.bfloat16).view(b, k, nh, dh).transpose(1, 2)
    k4 = ke.view(b, te, nh, dh).transpose(1, 2)
    v4 = ve.view(b, te, nh, dh).transpose(1, 2)
    recs["cross_attend"] = record(
        "cross_attend", err, 1e-4, device_ms(lambda: cross_attend(q, ke, ve, nh)),
        device_ms(lambda: cross_attend_plain(q, ke, ve, nh), iters=5),
        4 * n * te * h, n * h * 4 + 2 * b * te * h * 2 + n * h * 4,
        lib_ms=device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        peak=PEAK_F32_FLOPS, note="  (max_err: absolute; library: bf16 SDPA)")

    # K8: the cache permute
    kc, vc = caches()
    prev_k = torch.randint(0, k, (b, k), generator=g).to(dev, torch.int32)
    ok, ov = permute_beam_caches(kc, vc, prev_k)
    rk, rv = permute_beam_caches_plain(kc, vc, prev_k)
    if not (torch.equal(ok, rk) and torch.equal(ov, rv)):
        die("permute_beam_caches differs from the plain version")
    src = (torch.arange(b, device=dev)[:, None] * k + prev_k.long()).reshape(n)
    # timed with the caches out of L2, as the HBM bound assumes
    warm = device_ms(lambda: permute_beam_caches(kc, vc, prev_k))
    recs["permute_beam_caches"] = record(
        "permute_beam_caches", 0.0, 0.0,
        device_ms_cold(lambda: permute_beam_caches(kc, vc, prev_k)),
        device_ms_cold(lambda: permute_beam_caches_plain(kc, vc, prev_k), iters=5),
        0, 4 * n * l * h * 2 + n * 4,
        lib_ms=device_ms_cold(lambda: (kc.index_select(0, src), vc.index_select(0, src))),
        note="  (exact; inputs evicted from L2 before each call, %.4f ms L2-warm; "
             "library: index_select of both caches)" % warm)
    torch.cuda.synchronize()

    # ARB serving: 4 requests of 64 videos, then one of 60
    rng = np.random.RandomState(17)

    def request(videos):
        feats = [rng.randn(videos, cfg.n_frames, d).astype(np.float32)
                 for d in cfg.modality_dims]
        return feats, rng.randint(0, cfg.num_category, (videos, 1)).astype(np.int64)

    cap = StreamingCaptioner(cfg, model, depth=2)
    list(cap.map_stream([request(b), request(ARB_RAGGED)]))  # first use
    torch.cuda.synchronize()
    reqs = [request(b) for _ in range(N_REQUESTS)]
    steps0 = cap.generate.steps_run
    _build.reset_launches()
    outs, per_request = cap.timed_stream(reqs)
    launches = {name: _build.LAUNCHES[name] for name in ARB_KERNELS}
    steps = cap.generate.steps_run - steps0
    log("ARB main path: %d requests x %d videos, %.2f ms per request (%.1f "
        "captions/s, host clock, depth 2); %d beam steps (%.2f per decode); "
        "launches %s" % (N_REQUESTS, b, per_request * 1e3, b / per_request,
                         steps, steps / N_REQUESTS, launches))
    for name, want in (("project_topk", steps), ("beam_attend_step", steps),
                       ("cross_attend", steps), ("permute_beam_caches", 0)):
        if launches[name] != want:
            die("ARB: %s launched %d times, expected %d" % (name, launches[name], want))
    for hyp in outs:
        check_captions(hyp, b, l, v, C.EOS, C.PAD)

    ragged = request(ARB_RAGGED)
    steps0 = cap.generate.steps_run
    _build.reset_launches()
    (hyp60,) = cap.map_stream([ragged])
    ragged_launches = {name: _build.LAUNCHES[name] for name in ARB_KERNELS}
    steps = cap.generate.steps_run - steps0
    log("ARB %d-video request: %d beam steps; launches %s"
        % (ARB_RAGGED, steps, ragged_launches))
    for name, want in (("project_topk", steps), ("beam_attend_step", 0),
                       ("cross_attend", 0), ("permute_beam_caches", steps)):
        if ragged_launches[name] != want:
            die("ARB %d videos: %s launched %d times, expected %d"
                % (ARB_RAGGED, name, ragged_launches[name], want))
    check_captions(hyp60, ARB_RAGGED, l, v, C.EOS, C.PAD)
    launches["permute_beam_caches"] = ragged_launches["permute_beam_caches"]

    # bench.py's protocol (bench.py:296-318): encode outside the timed region
    big = request(ARB_BENCH)
    with torch.no_grad():
        enc = model.encode([torch.as_tensor(f).to(dev) for f in big[0]])
    cat = torch.as_tensor(big[1]).to(dev)
    cap.generate(enc, cat)[0].cpu()
    iters = 3
    steps0 = cap.generate.steps_run
    t0 = time.perf_counter()
    for _ in range(iters):
        hyp = cap.generate(enc, cat)[0].cpu()
    dt = time.perf_counter() - t0
    log("ARB decode at B=%d (bench.py protocol, %d decodes, %.1f beam steps "
        "each): %.2f ms per decode, %.1f captions/s, peak memory %.2f GB" % (
            ARB_BENCH, iters, (cap.generate.steps_run - steps0) / iters,
            dt / iters * 1e3, ARB_BENCH * iters / dt,
            torch.cuda.max_memory_allocated() / 1e9))
    check_captions(hyp.numpy(), ARB_BENCH, l, v, C.EOS, C.PAD)

    print_profile(device_breakdown(lambda: list(cap.map_stream([request(b)]))))
    steps0 = cap.generate.steps_run
    ops = host_ops(lambda: list(cap.map_stream([request(b)])))
    steps = cap.generate.steps_run - steps0
    log("host: %.1f top-level PyTorch ops per beam step (%d steps); most "
        "frequent: %s" % (sum(ops.values()) / steps, steps, ", ".join(
            "%s %.1f" % (name, count / steps) for name, count in ops.most_common(8))))

    # the first request's first videos again, on the CPU, plain versions; 16
    # videos take the card's route (K6 + K7: a multiple of 16), whose softmax
    # weights stay float32
    feats, cats = reqs[0]
    cpu_cap = StreamingCaptioner(cfg, cpu_model, depth=0, device="cpu")
    t0 = time.perf_counter()
    (cpu_hyp,) = cpu_cap.map_stream([([f[:ARB_CPU] for f in feats], cats[:ARB_CPU])])
    agree = float((cpu_hyp == outs[0][:ARB_CPU]).mean())
    log("ARB CPU plain decode of %d videos (%.1f s): token agreement %.4f"
        % (ARB_CPU, time.perf_counter() - t0, agree))
    if agree < 0.99:
        die("ARB token agreement with the CPU plain path %.4f < 0.99" % agree)
    return recs, launches


TRAIN_B, TRAIN_STEPS, TRAIN_BENCH, TRAIN_BENCH_ITERS, TRAIN_CPU = 64, 5, 2048, 5, 16
LAYER_KERNELS = ("train_fwd", "train_ffn_bwd", "train_attn_bwd", "train_wgrad")
CE_KERNELS = ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")
TRAIN_KERNELS = LAYER_KERNELS + CE_KERNELS
CE_TOL, CE_RMS_TOL = 1e-4, 2e-5  # g, z: float32 sums in another order, online lse
# the error's largest |value| against the reference's, and the error's root
# mean square against the reference's (tests/test_torch_port_cuda.py says why)
TRAIN_TOL, WGRAD_TOL = 2e-2, 1e-3
TRAIN_RMS_TOL, WGRAD_RMS_TOL = 4e-3, 1e-4


def train_batch(cfg, b, rng):
    """A synthetic NACF batch, built as bench.py's train protocol builds it
    (bench.py:390-412)."""
    import numpy as np

    from navc_tpu_torch import constants as C

    lengths = rng.randint(5, cfg.max_len - 1, size=b)
    tokens = np.full((b, cfg.max_len), C.PAD, np.int32)
    labels = np.full((b, cfg.max_len), C.PAD, np.int32)
    for i in range(b):
        n = lengths[i]
        tokens[i, :n] = rng.randint(6, cfg.vocab_size, size=n)
        tokens[i, :n // 2] = C.MASK
        labels[i, :n // 2] = rng.randint(6, cfg.vocab_size, size=n // 2)
    lt = rng.rand(b, cfg.max_len).astype(np.float32)
    lt /= lt.sum(-1, keepdims=True)
    batch = {
        "tokens": tokens, "labels": labels,
        "tokens_1": np.full((b, cfg.max_len), C.VIS, np.int32),
        "labels_1": np.where(rng.rand(b, cfg.max_len) < 0.3, C.MASK,
                             labels).astype(np.int32),
        "length_target": lt,
        "category": rng.randint(0, cfg.num_category, (b, 1)).astype(np.int32),
        "valid_mask": np.ones(b, np.float32),
    }
    for ch in cfg.modality.lower():
        batch["feats_%s" % ch] = rng.randn(
            b, cfg.n_frames, getattr(cfg, "dim_%s" % ch)).astype(np.float32)
    return batch


def scaled_err(got, want, like=None):
    """(max |got - want|, max |like|, rms(got - want), rms(like)), like
    defaulting to want."""
    ref = (want if like is None else like).float()
    d = got.float() - want.float()
    return (float(d.abs().max()), max(float(ref.abs().max()), 1e-6),
            float(d.square().mean().sqrt()), max(float(ref.square().mean().sqrt()), 1e-6))


def ce_checks(cfg, model, g, record):
    """K9 and K10 against their plain versions at the B=64 NACF pass (N = B
    x 30 rows), untied, tied and tied with a bias ten times the scores'
    scale; timed at N = 1920 and N = 61440 (B=2048) beside the logits route
    on the same operands (torch.matmul + runtime.crit's loss)."""
    import torch

    from navc_tpu_torch.ops import vocab_ce as VC
    from navc_tpu_torch.runtime.crit import _label_logprob

    dev = torch.device("cuda")
    h, v = cfg.dim_hidden, cfg.vocab_size
    w_master = model.projection_weight().detach()        # (V, D) float32
    w16 = w_master.to(torch.bfloat16).contiguous()

    def operands(rows):
        hh = torch.randn(rows, h, generator=g).to(dev, torch.bfloat16)
        lab = torch.randint(0, v, (rows,), generator=g, dtype=torch.int32).to(dev)
        keep = (torch.rand(rows, generator=g) > 0.4).float()   # PAD / dropped rows
        return hh, lab, (torch.randn(rows, generator=g) * keep).to(dev)

    n = TRAIN_B * cfg.max_len
    hh, lab, dg = operands(n)
    scale = float((hh[:256].float() @ w16.float().t()).std())
    cases = {"untied": None,
             "tied": (torch.randn(v, generator=g) * 0.1).to(dev),
             "large bias": (torch.randn(v, generator=g) * 10 * scale).to(dev)}
    errs = {k: 0.0 for k in CE_KERNELS}
    worst_rms = {k: 0.0 for k in CE_KERNELS}
    for case, bias in cases.items():
        g_k, pred_k, z_k = VC.vocab_ce_fwd(hh, w16, bias, lab)
        g_p, pred_p, z_p = VC.vocab_ce_fwd_plain(hh, w16, bias, lab)
        dh_k, dw_k, db_k = VC.vocab_ce_bwd(hh, w16, bias, lab, z_k, dg,
                                           dh_dtype=torch.bfloat16)
        dh_p, dw_p, db_p = VC.vocab_ce_bwd_plain(hh, w16, bias, lab, z_p, dg)
        torch.cuda.synchronize()
        s_p = hh.float() @ w16.float().t() + (0 if bias is None else bias)
        top2 = s_p.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        if int(((pred_k != pred_p) & clear).sum()):
            die("ce_fwd (%s) argmax differs from the plain version where the "
                "top-2 margin > 1e-3" % case)
        if not torch.all(dh_k[dg == 0] == 0):
            die("ce_bwd_dh (%s): a row with dg = 0 has a non-zero gradient" % case)
        checks = [("ce_fwd", "g", g_k, g_p, CE_TOL, CE_RMS_TOL),
                  ("ce_fwd", "z", z_k, z_p, CE_TOL, CE_RMS_TOL),
                  ("ce_bwd_dh", "dh", dh_k, dh_p, TRAIN_TOL, TRAIN_RMS_TOL),
                  ("ce_bwd_dw", "dW", dw_k, dw_p, TRAIN_TOL, TRAIN_RMS_TOL)]
        if bias is not None:
            checks.append(("ce_bwd_dw", "db", db_k, db_p, TRAIN_TOL, TRAIN_RMS_TOL))
        for name, what, a, b, tol, rms_tol in checks:
            err, sc, rms_err, rms = scaled_err(a, b)
            if not (err <= tol * sc and rms_err <= rms_tol * rms):
                die("%s %s (%s) disagrees with its plain version: max err %.3e "
                    "(scale %.3e), rms err %.3e (rms %.3e)"
                    % (name, what, case, err, sc, rms_err, rms))
            errs[name] = max(errs[name], err)
            worst_rms[name] = max(worst_rms[name], rms_err / rms)
    log("vocab CE kernels agree with their plain versions at N=%d, D=%d, V=%d "
        "(untied, tied, large bias; ids equal where the top-2 margin > 1e-3; "
        "g, z within %.0e of the largest |value| and %.0e of the rms; dh, dW, "
        "db within %.0e and %.0e; worst rms ratios %s)" % (
            n, h, v, CE_TOL, CE_RMS_TOL, TRAIN_TOL, TRAIN_RMS_TOL,
            {k: "%.3g" % r for k, r in worst_rms.items()}))

    b_main = None if model.tgt_word_prj is not None else cases["tied"]
    w_route = w_master.clone().requires_grad_()

    def logits_route(hh, lab, dg, backward):
        """The logits route on the same operands: the bf16 projection, then
        runtime.crit's label log-prob, forward (and backward)."""
        with torch.set_grad_enabled(backward):
            hr = hh.detach().requires_grad_(backward)
            logits = hr @ w_route.to(torch.bfloat16).t()
            if b_main is not None:
                logits = logits + b_main.to(torch.bfloat16)
            gathered, _ = _label_logprob(logits, lab)
            if backward:
                (-(gathered * dg).sum()).backward()

    def launch_ms(fn, name, calls=5):
        prof = device_breakdown(lambda: [fn() for _ in range(calls)])
        hits = [] if prof is None else [v for k, v in prof[2].items() if name in k]
        if not hits:
            die("the profiler recorded no device time for %s" % name)
        return sum(v[0] for v in hits) / calls

    times = {}
    for rows in (n, TRAIN_BENCH * cfg.max_len):
        hr, lr, dr = (hh, lab, dg) if rows == n else operands(rows)
        z = VC.vocab_ce_fwd(hr, w16, b_main, lr)[2]
        bwd = lambda: VC.vocab_ce_bwd(hr, w16, b_main, lr, z, dr,  # noqa: E731
                                      dh_dtype=torch.bfloat16)
        times[rows] = dict(
            fwd=cuda_ms(lambda: VC.vocab_ce_fwd(hr, w16, b_main, lr), iters=5),
            bwd=cuda_ms(bwd, iters=5),
            dh=launch_ms(bwd, "ce_bwd_dh"), dw=launch_ms(bwd, "ce_bwd_dw"),
            route_fwd=cuda_ms(lambda: logits_route(hr, lr, dr, False), iters=5),
            route_both=cuda_ms(lambda: logits_route(hr, lr, dr, True), iters=5))
        log("vocab CE at N=%d (B=%d): K9 %.4f ms, K10 %.4f ms (dh %.4f, dW %.4f); "
            "bounds by the function's own operations: K9 %.4f ms, K10 %.4f ms; "
            "logits route on the same operands: forward %.4f ms, forward + "
            "backward %.4f ms (K9 + K10 %.4f ms)" % (
                rows, rows // cfg.max_len, times[rows]["fwd"], times[rows]["bwd"],
                times[rows]["dh"], times[rows]["dw"],
                bound(2 * rows * h * v, 0)[0], bound(6 * rows * h * v, 0)[0],
                times[rows]["route_fwd"], times[rows]["route_both"],
                times[rows]["fwd"] + times[rows]["bwd"]))
        del hr, lr, dr, z
    torch.cuda.empty_cache()

    t = times[n]
    plain_fwd = cuda_ms(lambda: VC.vocab_ce_fwd_plain(hh, w16, b_main, lab), iters=3)
    z = VC.vocab_ce_fwd(hh, w16, b_main, lab)[2]
    plain_bwd = cuda_ms(lambda: VC.vocab_ce_bwd_plain(hh, w16, b_main, lab, z, dg), iters=3)
    nd_v = n * h * v
    in_bytes = n * h * 2 + v * h * 2 + (0 if b_main is None else v * 4) + n * 4
    big = times[TRAIN_BENCH * cfg.max_len]
    note = ("  (max_err: absolute, over the untied, tied and large-bias cases; "
            "B=2048 (N=%d): %.4f ms; logits route on the same operands: B=64 "
            "forward %.4f, forward+backward %.4f ms, B=2048 %.4f, %.4f ms; "
            "library_ms null: no one PyTorch call)")
    return {
        "ce_fwd": record(
            "ce_fwd", errs["ce_fwd"], None, t["fwd"], plain_fwd, 2 * nd_v,
            in_bytes + 3 * n * 4,
            note=note % (TRAIN_BENCH * cfg.max_len, big["fwd"], t["route_fwd"],
                         t["route_both"], big["route_fwd"], big["route_both"])),
        "ce_bwd_dh": record(
            "ce_bwd_dh", errs["ce_bwd_dh"], None, t["dh"], plain_bwd, 4 * nd_v,
            in_bytes + 2 * n * 4 + n * h * 2,
            note=note % (TRAIN_BENCH * cfg.max_len, big["dh"], t["route_fwd"],
                         t["route_both"], big["route_fwd"], big["route_both"])
            + " [K10's score recompute and dh = ds W; plain_ms: the whole plain backward]"),
        "ce_bwd_dw": record(
            "ce_bwd_dw", errs["ce_bwd_dw"], None, t["dw"], plain_bwd, 2 * nd_v,
            v * h * 4 + (0 if b_main is None else v * 4),
            note=note % (TRAIN_BENCH * cfg.max_len, big["dw"], t["route_fwd"],
                         t["route_both"], big["route_fwd"], big["route_both"])
            + " [dW = ds^T h and db; its own score recompute is the port's cost, "
            "not in the bound; plain_ms: the whole plain backward]"),
    }


def train_phases(record, seeded):
    """K11, K12a, K12b and the weight-gradient reduction against their plain
    versions at full width, then NACF training through run_train_epoch.
    Returns ({kernel: record}, {kernel: launches on the training main
    path})."""
    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops import fused_layer_train as FT
    from navc_tpu_torch.runtime.loop import run_train_epoch
    from navc_tpu_torch.runtime.optim import LrSchedule
    from navc_tpu_torch.runtime.train_step import (create_train_state,
                                                   make_train_step)

    dev = torch.device("cuda")
    over = dict(dataset="MSRVTT", vocab_size=10048, use_pallas=True)
    cfg = default_config("NACF", batch_size=TRAIN_B, **over)
    h, nh, inter = cfg.dim_hidden, cfg.num_attention_heads, cfg.intermediate_size
    te = len(cfg.modality) * cfg.n_frames
    g = torch.Generator().manual_seed(77)

    # -- (a) each kernel against its plain version -------------------------
    model = build_model(cfg, device="cuda", generator=seeded(0), train=True)
    w = FT.kernel_weights(FT.layer_train_weights(model.decoder.layers[0]),
                          torch.bfloat16)
    w = {k: v.detach() for k, v in w.items()}
    recs, errs = {}, {k: 0.0 for k in LAYER_KERNELS}
    rms_ratio = {k: (0.0, "") for k in LAYER_KERNELS}
    seed = 1234567
    for causal in (False, True):
        l = cfg.max_len - 1 if causal else cfg.max_len
        lengths = torch.randint(5, l + 1, (TRAIN_B,), generator=g)
        kp = (torch.arange(l)[None] >= lengths[:, None]).to(dev)
        x = torch.randn(TRAIN_B, l, h, generator=g).to(dev)
        enc = torch.randn(TRAIN_B, te, h, generator=g).to(dev)
        dy = torch.randn(TRAIN_B, l, h, generator=g).to(dev)
        kw = dict(n_head=nh, causal=causal, p=0.5, p_input=0.5)
        out, r2 = FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)
        out_p, r2_p = FT.train_fwd_plain(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)
        dr2, fprods = FT.ffn_bwd_operands(r2, dy, kp, w, seed, p=0.5)
        dr2_p, fprods_p = FT.ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=0.5)
        dx, denc, aprods = FT.attn_bwd_operands(x, enc, dr2, kp, w, seed, **kw)
        dx_p, denc_p, aprods_p = FT.attn_bwd_operands_plain(x, enc, dr2, kp, w,
                                                            seed, **kw)
        prods = fprods + aprods
        grads = FT.weight_grads(fprods)
        grads.update(FT.weight_grads(aprods))
        want = FT.weight_grads_plain(prods)
        torch.cuda.synchronize()
        checks = {  # kernel: [(tensor, stats)]
            "train_fwd": [("out", scaled_err(out, out_p)), ("r2", scaled_err(r2, r2_p))],
            "train_ffn_bwd": [("dr2", scaled_err(dr2, dr2_p))] + [
                ("%s %s" % (a.w, f), scaled_err(getattr(a, f), getattr(b, f)))
                for a, b in zip(fprods, fprods_p) for f in ("P", "Q", "part")],
            "train_attn_bwd": [("dx", scaled_err(dx, dx_p)), ("denc", scaled_err(denc, denc_p))] + [
                ("%s %s" % (a.w, f), scaled_err(getattr(a, f), getattr(b, f)))
                for a, b in zip(aprods, aprods_p) for f in ("P", "Q")] + [
                ("%s part" % a.w, scaled_err(a.part, b.part)) for a, b in zip(aprods, aprods_p)
                if a.b not in ("bk_s", "bk_c")] + [
                # a key bias's gradient is zero in exact arithmetic, both sides
                # rounding noise: its largest error held to the query bias's
                # scale, its rms not checked
                ("%s part" % a.w,
                 scaled_err(a.part, b.part, aprods_p[0 if a.b == "bk_s" else 4].part)[:2]
                 + (None, None)) for a, b in zip(aprods, aprods_p) if a.b in ("bk_s", "bk_c")],
            "train_wgrad": [(k, scaled_err(grads[k], want[k])) for k in FT.WEIGHT_KEYS],
        }
        for name, stats in checks.items():
            tol, rms_tol = ((WGRAD_TOL, WGRAD_RMS_TOL) if name == "train_wgrad"
                            else (TRAIN_TOL, TRAIN_RMS_TOL))
            where = "%s (%s)" % (name, "causal" if causal else "nar")
            for what, (err, scale, rms_err, rms) in stats:
                if not err <= tol * scale:
                    die("%s %s disagrees with its plain version: max err %.3e > "
                        "%.1e x %.3e" % (where, what, err, tol, scale))
                if rms is not None and not rms_err <= rms_tol * rms:
                    die("%s %s disagrees with its plain version: rms err %.3e > "
                        "%.1e x %.3e" % (where, what, rms_err, rms_tol, rms))
                errs[name] = max(errs[name], err)
                if rms is not None and rms_err / rms > rms_ratio[name][0]:
                    rms_ratio[name] = (rms_err / rms, what)
    log("training kernels agree with their plain versions at B=%d, L 30 NAR / 29 "
        "causal, Te %d, p = p_input = 0.5 (largest error within %.0e, reduction "
        "%.0e, of each tensor's largest |value|; rms error within %.0e, reduction "
        "%.0e, of each tensor's rms; worst rms ratios %s)" % (
            TRAIN_B, te, TRAIN_TOL, WGRAD_TOL, TRAIN_RMS_TOL, WGRAD_RMS_TOL,
            {k: "%.3g (%s)" % v for k, v in rms_ratio.items()}))

    # timing and bounds on the causal inputs (the last loop's), NAR lengths
    # close: R real rows, S self-attention pairs. Each kernel's bytes are the
    # TPU function's own inputs and outputs (x, enc, dy, dr2, r2, the mask,
    # the weights it reads; out, r2, dr2, dx, denc); the operand rows and
    # partial sums that K12a/K12b hand to the reduction, and K12b's Q/K/V
    # scratch, are the port's own traffic and count in no bound but the
    # reduction's, which must read its operands. The weight-gradient
    # products count in the reduction's operations.
    n, l = TRAIN_B, x.shape[1]
    rr = int((~kp).sum())
    pairs = int(sum(int(m) * (int(m) + 1) // 2 for m in (~kp).sum(1)))
    act, enc_b = n * l * h * 4, n * te * h * 4          # f32 (N, L, H), (N, Te, H)
    attn_w = 8 * h * h * 2 + 8 * h * 4
    ffn_w = 2 * h * inter * 2 + (inter + h) * 4
    attn_fwd = (2 * rr * h * h * 6 + 2 * 2 * n * te * h * h
                + 2 * 2 * pairs * h + 2 * 2 * rr * te * h)
    fl11 = attn_fwd + 2 * 2 * rr * h * inter
    nb11 = act + enc_b + n * l + attn_w + ffn_w + 2 * (n * l * h * 2)   # out, r2 bf16
    fl12a = 3 * 2 * rr * h * inter
    nb12a = n * l * h * 2 + act + n * l + 2 * h * inter * 2 + inter * 4 + act  # r2, dy -> dr2
    fl12b = (attn_fwd + 2 * rr * h * h * 6 + 2 * 2 * n * te * h * h
             + 4 * 2 * rr * te * h + 4 * 2 * pairs * h)
    nb12b = 2 * act + enc_b + n * l + attn_w + act + enc_b             # x, dr2 -> dx, denc
    real_rows = {"wk_c": n * te, "wv_c": n * te}
    fl_w = sum(2 * real_rows.get(pr.w, rr) * pr.P.shape[1] * pr.Q.shape[1] for pr in prods)
    nb_w = sum((pr.P.numel() + pr.Q.numel()) * 2 + pr.part.numel() * 4
               + (pr.P.shape[1] * pr.Q.shape[1] + pr.P.shape[1]) * 4 for pr in prods)
    note = ("  (max_err: absolute; tolerance %.0e of each tensor's largest |value| "
            "and %.0e of its rms for the error's rms")
    recs["train_fwd"] = record(
        "train_fwd", errs["train_fwd"], None,
        device_ms(lambda: FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)),
        cuda_ms(lambda: FT.train_fwd_plain(x, enc, kp, w, seed, out_dtype=torch.bfloat16,
                                           **kw), iters=3),
        fl11, nb11, note=note % (TRAIN_TOL, TRAIN_RMS_TOL) + "; library_ms null: no one PyTorch call)")
    recs["train_ffn_bwd"] = record(
        "train_ffn_bwd", errs["train_ffn_bwd"], None,
        device_ms(lambda: FT.ffn_bwd_operands(r2, dy, kp, w, seed, p=0.5)),
        cuda_ms(lambda: FT.ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=0.5), iters=3),
        fl12a, nb12a, note=note % (TRAIN_TOL, TRAIN_RMS_TOL) + "; library_ms null: no one PyTorch call)")
    recs["train_attn_bwd"] = record(
        "train_attn_bwd", errs["train_attn_bwd"], None,
        device_ms(lambda: FT.attn_bwd_operands(x, enc, dr2, kp, w, seed, **kw)),
        cuda_ms(lambda: FT.attn_bwd_operands_plain(x, enc, dr2, kp, w, seed, **kw),
                iters=3),
        fl12b, nb12b, note=note % (TRAIN_TOL, TRAIN_RMS_TOL) + "; library_ms null: no one PyTorch call)")
    recs["train_wgrad"] = record(
        "train_wgrad", errs["train_wgrad"], None,
        device_ms(lambda: (FT.weight_grads(fprods), FT.weight_grads(aprods))),
        cuda_ms(lambda: FT.weight_grads_plain(prods), iters=3), fl_w, nb_w,
        lib_ms=device_ms(lambda: [torch.matmul(pr.P.t(), pr.Q) for pr in prods]),
        note=note % (WGRAD_TOL, WGRAD_RMS_TOL) + "; the two launches of one backward; library: "
        "torch.matmul of the same bf16 operands)")
    del out, r2, dr2, dx, denc, prods, fprods, aprods, grads, want
    del out_p, r2_p, dr2_p, dx_p, denc_p, fprods_p, aprods_p

    recs.update(ce_checks(cfg, model, g, record))

    # -- (b) the main path: 5 NACF steps through run_train_epoch -----------
    rng = np.random.RandomState(5)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    sched = LrSchedule.from_config(cfg)
    gen = torch.Generator().manual_seed(0)
    batches = [train_batch(cfg, TRAIN_B, rng) for _ in range(TRAIN_STEPS)]
    run_train_epoch(cfg, step, state, batches[:1], sched, gen)  # first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, info = run_train_epoch(cfg, step, state, batches, sched, gen)
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {k: _build.LAUNCHES[k] for k in TRAIN_KERNELS}
    log("NACF training main path: %d steps x %d videos through run_train_epoch, "
        "%.2f ms per step, %.1f captions/s (host clock, metrics read at the end), "
        "peak memory %.2f GB; launches %s; info %s" % (
            TRAIN_STEPS, TRAIN_B, dt * 1e3, TRAIN_B / dt,
            torch.cuda.max_memory_allocated() / 1e9, launches,
            {k: round(v, 4) for k, v in info.items()}))
    want_launches = {"train_fwd": 2, "train_ffn_bwd": 2, "train_attn_bwd": 2,
                     "train_wgrad": 4, "ce_fwd": 2, "ce_bwd_dh": 2, "ce_bwd_dw": 2}
    for name, per in want_launches.items():
        if launches[name] != per * TRAIN_STEPS:
            die("training: %s launched %d times, expected %d per step"
                % (name, launches[name], per))
    if not all(np.isfinite(v) for v in info.values()):
        die("training metrics not finite: %s" % info)
    print_profile(device_breakdown(lambda: step(batches[0], gen)), "training step")

    # -- (c) bench.py's train protocol at B=2048 ----------------------------
    del state, step, model
    torch.cuda.empty_cache()
    bcfg = default_config("NACF", batch_size=TRAIN_BENCH, **over)
    bmodel = build_model(bcfg, device="cuda", generator=seeded(0), train=True)
    bstate = create_train_state(bcfg, bmodel)
    bstep = make_train_step(bcfg, bmodel, bstate.optimizer)
    big = train_batch(bcfg, TRAIN_BENCH, np.random.RandomState(0))
    torch.cuda.reset_peak_memory_stats()
    float(bstep(big, gen)["total_loss"])
    t0 = time.perf_counter()
    for _ in range(TRAIN_BENCH_ITERS):
        loss = float(bstep(big, gen)["total_loss"])  # host sync each step
    dt_sync = (time.perf_counter() - t0) / TRAIN_BENCH_ITERS
    t0 = time.perf_counter()
    ms = [bstep(big, gen) for _ in range(TRAIN_BENCH_ITERS)]
    loss = float(ms[-1]["total_loss"])
    dt_pipe = (time.perf_counter() - t0) / TRAIN_BENCH_ITERS
    log("NACF train step at B=%d (bench.py protocol, %d steps each): synchronised "
        "%.2f ms, %.1f captions/s; pipelined %.2f ms, %.1f captions/s; loss %.3f; "
        "peak memory %.2f GB" % (
            TRAIN_BENCH, TRAIN_BENCH_ITERS, dt_sync * 1e3, TRAIN_BENCH / dt_sync,
            dt_pipe * 1e3, TRAIN_BENCH / dt_pipe, loss,
            torch.cuda.max_memory_allocated() / 1e9))
    if not np.isfinite(loss):
        die("B=%d training loss is not finite" % TRAIN_BENCH)
    print_profile(device_breakdown(lambda: bstep(big, gen)),
                  "training step at B=%d" % TRAIN_BENCH)
    del bstate, bstep, bmodel, ms
    torch.cuda.empty_cache()

    # -- (d) one bf16 step at p = 0 on the card against the CPU plain path --
    ccfg = default_config("NACF", batch_size=TRAIN_CPU, hidden_dropout_prob=0.0,
                          encoder_dropout=0.0, **over)
    small = train_batch(ccfg, TRAIN_CPU, np.random.RandomState(9))
    sides = {}
    for where in ("cuda", "cpu"):
        m = build_model(ccfg, device=where, generator=seeded(3), train=True)
        st = create_train_state(ccfg, m)
        met = make_train_step(ccfg, m, st.optimizer)(small, torch.Generator().manual_seed(1))
        sides[where] = (float(met["total_loss"]),
                        {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()})
    (loss_g, grad_g), (loss_c, grad_c) = sides["cuda"], sides["cpu"]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    key_bias = ("attention.self.key.bias", "attend_to_enc_output.self.key.bias")
    rel = {k: float((grad_g[k] - v).norm() / max(float(v.norm()), 1e-12))
           for k, v in grad_c.items() if not k.endswith(key_bias)}
    worst = max(rel, key=rel.get)
    log("bf16 step at p = 0, %d videos, card vs CPU plain path: loss %.5f vs %.5f "
        "(relative %.2e, tolerance 1e-2); gradient norm-relative error worst %.2e "
        "(%s), median %.2e over %d parameters (tolerance 5e-2; the two key biases, "
        "zero in exact arithmetic, left out)" % (
            TRAIN_CPU, loss_g, loss_c, loss_rel, rel[worst], worst,
            float(np.median(list(rel.values()))), len(rel)))
    if not (loss_rel <= 1e-2 and rel[worst] <= 5e-2):
        die("the card's bf16 training step disagrees with the CPU plain path")

    # -- (e) 20 steps on one batch at dropout 0.1 lower the loss -------------
    dcfg = default_config("NACF", batch_size=TRAIN_B, hidden_dropout_prob=0.1,
                          encoder_dropout=0.1, **over)
    dmodel = build_model(dcfg, device="cuda", generator=seeded(4), train=True)
    dstate = create_train_state(dcfg, dmodel)
    dstep = make_train_step(dcfg, dmodel, dstate.optimizer)
    one = train_batch(dcfg, TRAIN_B, np.random.RandomState(3))
    losses = torch.stack([dstep(one, gen)["total_loss"] for _ in range(20)]).tolist()
    log("20 steps on one batch at dropout 0.1: loss %.4f -> %.4f (first 3 mean "
        "%.4f, last 3 mean %.4f)" % (losses[0], losses[-1], np.mean(losses[:3]),
                                     np.mean(losses[-3:])))
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])):
        die("training on one batch did not lower the loss")
    return recs, launches


ENTRY_VIDEOS, ENTRY_CAPS, ENTRY_FRAMES = 320, 5, 16


def entry_point_phase():
    """train_network_all at full width: make_synthetic_corpus with the
    MSRVTT vocab (10048) and in-memory 2048-d features, modality mi, 320
    videos (192 / 64 / 64), 5 captions each, batch 64. ARB for 1 epoch, then
    NACF for 2 with that best.ckpt as teacher. Validation decodes go through
    K1-K4 (NACF, with the ARB teacher's rescoring) and K5-K7 (ARB), every
    step through K9-K12."""
    import tempfile

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime import loop

    over = dict(dataset="MSRVTT", vocab_size=10048, use_pallas=True, batch_size=64)
    base = default_config("ARB", epochs=1, no_test=True, **over)
    corpus, refs = make_synthetic_corpus(base, n_videos=ENTRY_VIDEOS, n_caps=ENTRY_CAPS,
                                         vocab_size=10048)
    feats = make_synthetic_feats(base, n_videos=ENTRY_VIDEOS, n_total_frames=ENTRY_FRAMES)
    data = dict(info_corpus=corpus, references=refs, in_memory_feats=feats)
    split = {k: len(v) for k, v in corpus["info"]["split"].items()}

    times = {"epoch": [], "eval": []}
    train_epoch, run_eval = loop.run_train_epoch, loop.run_eval

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    loop.run_train_epoch, loop.run_eval = timed(train_epoch, "epoch"), timed(run_eval, "eval")
    try:
        with tempfile.TemporaryDirectory() as root:
            _build.reset_launches()
            arb = loop.train_network_all(base, workdir=os.path.join(root, "ARB"),
                                         verbose=False, **data)
            arb_launches = dict(_build.LAUNCHES)
            teacher = os.path.join(root, "ARB", "best.ckpt")
            ncfg = default_config("NACF", epochs=2, **over).replace(teacher_path=teacher)
            _build.reset_launches()
            nacf = loop.train_network_all(ncfg, workdir=os.path.join(root, "NACF"),
                                          verbose=False, **data)
            nacf_launches = dict(_build.LAUNCHES)
            for run in ("ARB", "NACF"):
                for name in ("best.ckpt", "checkpoint.ckpt", "trainning_record.csv"):
                    if not os.path.exists(os.path.join(root, run, name)):
                        die("entry point: %s wrote no %s" % (run, name))
    finally:
        loop.run_train_epoch, loop.run_eval = train_epoch, run_eval
    losses = [r["train_loss"] for r in nacf["history"]]
    log("entry point: train_network_all, %d videos (%s), %d captions each, batch 64, "
        "d=512, vocab 10048: ARB 1 epoch then NACF 2 epochs with that teacher; "
        "seconds per epoch %s, per validation %s, test evaluation %.3f; ARB "
        "validation %s; NACF validation %s, train loss %s; NACF test %s" % (
            ENTRY_VIDEOS, split, ENTRY_CAPS, ["%.3f" % t for t in times["epoch"]],
            ["%.3f" % t for t in times["eval"][:-1]], times["eval"][-1],
            {k: round(arb["history"][0][k], 4) for k in ("Bleu_4", "METEOR", "CIDEr")},
            [{k: round(r[k], 4) for k in ("Bleu_4", "METEOR", "CIDEr")}
             for r in nacf["history"]], ["%.4f" % x for x in losses],
            {k: round(nacf["test_res"][k], 4) for k in ("Bleu_4", "METEOR", "CIDEr")}))
    log("entry point launches: ARB run %s; NACF run %s" % (
        {k: c for k, c in arb_launches.items() if c},
        {k: c for k, c in nacf_launches.items() if c}))
    if not (len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0]
            and np.isfinite(arb["history"][0]["train_loss"])):
        die("entry point: NACF train losses %s are not finite and falling" % losses)
    for name in ("project_topk", "beam_attend_step", "cross_attend", "train_fwd",
                 "train_ffn_bwd", "train_attn_bwd", "train_wgrad", "ce_fwd",
                 "ce_bwd_dh", "ce_bwd_dw"):
        if not arb_launches[name]:
            die("entry point: the ARB run never launched %s" % name)
    for name in ("fused_layer", "fused_layer_qsub", "project_argmax",
                 "project_gather_prob", "train_fwd", "train_ffn_bwd", "train_attn_bwd",
                 "train_wgrad", "ce_fwd", "ce_bwd_dh", "ce_bwd_dw"):
        if not nacf_launches[name]:
            die("entry point: the NACF run never launched %s" % name)


def main():
    if not os.path.isdir(os.path.join(ROOT, "navc_tpu_torch", "csrc")):
        die("navc_tpu_torch/csrc not found next to chip_smoke.py: run it "
            "from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi failed: " + smi.stderr.strip()
    log(card)
    log("torch %s cuda %s python %s" % (torch.__version__, torch.version.cuda,
                                        sys.version.split()[0]))
    dev = torch.device("cuda")

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.decoding.mask_predict import KernelOperands, query_index
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops.fused_layer import (fused_layer, fused_layer_plain,
                                                fused_layer_qsub,
                                                fused_layer_qsub_plain,
                                                fused_layer_unfolded,
                                                fused_layer_unfolded_plain)
    from navc_tpu_torch.ops.vocab_fused import (project_argmax,
                                                project_argmax_plain,
                                                project_gather_prob,
                                                project_gather_prob_plain)
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log("build: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %s" % (k, "built" if v is not None else "cached") for k, v in logs.items())))
    for name, text in logs.items():
        for line in (text or "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas %s: %s" % (name, line.strip()))

    # -- 2. models at full width, seeded random weights ---------------------
    over = dict(dataset="MSRVTT", vocab_size=10048, use_pallas=True)
    cfg = default_config("NACF", **over)
    tcfg = default_config("ARB", **over)
    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    model = build_model(cfg, device="cuda", generator=seeded(0))
    teacher = build_model(tcfg, device="cuda", generator=seeded(1))
    ops, tops = KernelOperands.of(model), KernelOperands.of(teacher)
    h, inter, v = cfg.dim_hidden, cfg.intermediate_size, cfg.vocab_size
    n = N_VIDEOS * cfg.length_beam_size
    l = -(-cfg.max_len // 8) * 8
    le = 2 * cfg.n_frames
    log("NACF d=%d heads=%d ffn=%d vocab=%d max_len=%d canvas=%d Te=%d "
        "lbs=%d iterations=%d ct=%s teacher=ARB" % (
            h, cfg.num_attention_heads, inter, v, cfg.max_len, l, le,
            cfg.length_beam_size, cfg.iterations, cfg.use_ct))

    # -- 3. each kernel against its plain version, at the main path's shapes -
    g = torch.Generator(device="cpu").manual_seed(123)
    lengths = torch.randint(4, cfg.max_len, (n,), generator=g)
    tokens = torch.randint(C.NUM_SPECIAL_TOKENS, v, (n, l), generator=g)
    tokens[torch.arange(l)[None] >= lengths[:, None]] = C.PAD
    tokens = tokens.to(dev, torch.int32)
    kp = tokens == C.PAD
    enc = torch.randn(N_VIDEOS, le, h, generator=g).to(dev)
    cat = torch.randint(0, cfg.num_category, (n, 1), generator=g).to(dev)
    ke, ve = ops.cross_kv(enc, cfg.length_beam_size)
    static = ops.static(n, l, cat, torch.repeat_interleave(enc, cfg.length_beam_size, 0))
    raw = ops.word16[tokens.long()]
    lw = (ops.layer, ops.ln_scale, ops.ln_bias)

    def record(name, err, tol, ms, plain_ms, flops, nbytes, lib_ms=None, note="",
               peak=PEAK_BF16_FLOPS):
        b_ms, b_by = bound(flops, nbytes, peak)
        log("%-20s max_err %.3e (tol %s)  kernel_ms %.4f  plain_ms %.4f  "
            "library_ms %s  bound_ms %.4f (%s)%s" % (
                name, err, "scaled, checked above" if tol is None else "%.1e" % tol,
                ms, plain_ms, "null" if lib_ms is None else "%.4f" % lib_ms, b_ms,
                b_by, note))
        if tol is not None and not err <= tol:
            die("%s disagrees with its plain version: max_err %.3e > %.1e"
                % (name, err, tol))
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)

    def hid_err(a, b):
        return float((a.float() - b.float()).abs().max())

    HID_TOL = 5e-2  # bf16 operands; a float32 sum-order flip of one bf16
    #                 rounding (2^-8 relative) propagates through the layer

    # K1, dense NAR form
    k1 = lambda: fused_layer(raw, static, kp, ke, ve, *lw,  # noqa: E731
                             n_head=ops.n_head, out_dtype=torch.bfloat16)
    k1p = lambda: fused_layer_plain(raw, static, kp, ke, ve, *lw,  # noqa: E731
                                    n_head=ops.n_head, out_dtype=torch.bfloat16)
    out_k1 = k1()
    torch.cuda.synchronize()
    err_nar = hid_err(fused_layer(raw, static, kp, ke, ve, *lw, n_head=ops.n_head),
                      fused_layer_plain(raw, static, kp, ke, ve, *lw,
                                        n_head=ops.n_head))
    real = int((~kp).sum())
    fl = layer_flops(real, real, n, le, h, inter)
    nb = layer_bytes(n, l, le, h, inter, n * l)
    rec_nar = record("fused_layer[nar]", err_nar, HID_TOL, cuda_ms(k1),
                     cuda_ms(k1p, iters=5), fl, nb)

    # K1, causal teacher form
    t_inp = torch.cat([torch.full((n, 1), C.BOS, device=dev, dtype=torch.int32),
                       tokens[:, :-1]], 1)
    t_raw = tops.word16[t_inp.long()]
    t_static = tops.static(n, l, cat)
    t_kp = t_inp == C.PAD
    tke, tve = tops.cross_kv(enc, cfg.length_beam_size)
    tlw = (tops.layer, tops.ln_scale, tops.ln_bias)
    k1c = lambda: fused_layer(t_raw, t_static, t_kp, tke, tve, *tlw,  # noqa: E731
                              n_head=tops.n_head, causal=True,
                              out_dtype=torch.bfloat16)
    k1cp = lambda: fused_layer_plain(t_raw, t_static, t_kp, tke, tve, *tlw,  # noqa: E731
                                     n_head=tops.n_head, causal=True,
                                     out_dtype=torch.bfloat16)
    out_k1c = k1c()
    err_causal = hid_err(
        fused_layer(t_raw, t_static, t_kp, tke, tve, *tlw, n_head=tops.n_head,
                    causal=True),
        fused_layer_plain(t_raw, t_static, t_kp, tke, tve, *tlw,
                          n_head=tops.n_head, causal=True))
    t_real = int((~t_kp).sum())
    record("fused_layer[causal]", err_causal, HID_TOL, cuda_ms(k1c),
           cuda_ms(k1cp, iters=5), layer_flops(t_real, t_real, n, le, h, inter), nb)

    # K2, the first sparse step's width (K = 24)
    k_slots = 24
    mask_ind = (torch.rand(n, l, generator=g) < 0.6).to(dev) & ~kp
    mask_ind[:, 0] = True
    qidx = query_index(mask_ind, k_slots)
    masked = torch.where(mask_ind, C.MASK, tokens).to(torch.int32)
    m_raw, m_kp = ops.word16[masked.long()], masked == C.PAD
    mrow = ops.word16[C.MASK].contiguous()
    k2 = lambda: fused_layer_qsub(qidx, mrow, m_raw, static, m_kp, ke, ve,  # noqa: E731
                                  *lw, n_head=ops.n_head,
                                  out_dtype=torch.bfloat16)
    k2p = lambda: fused_layer_qsub_plain(qidx, mrow, m_raw, static, m_kp, ke,  # noqa: E731
                                         ve, *lw, n_head=ops.n_head,
                                         out_dtype=torch.bfloat16)
    out_k2 = fused_layer_qsub(qidx, mrow, m_raw, static, m_kp, ke, ve, *lw,
                              n_head=ops.n_head)
    err_k2 = hid_err(out_k2, fused_layer_qsub_plain(
        qidx, mrow, m_raw, static, m_kp, ke, ve, *lw, n_head=ops.n_head))
    dense_rows = fused_layer(m_raw, static, m_kp, ke, ve, *lw, n_head=ops.n_head)
    used = qidx >= 0
    rows = torch.gather(dense_rows, 1,
                        qidx.clamp(min=0).long()[..., None].expand(-1, -1, h))
    k2_vs_k1 = float((out_k2 - rows)[used].abs().max())
    n_used = int(used.sum())
    fl2 = layer_flops(n_used, int((~m_kp).sum()), n, le, h, inter)
    nb2 = layer_bytes(n, l, le, h, inter, n * k_slots, extra=n * k_slots * 4)
    rec_k2 = record("fused_layer_qsub", err_k2, HID_TOL, cuda_ms(k2),
                    cuda_ms(k2p, iters=5), fl2, nb2,
                    note="  rows vs K1 rows %.3e, %d of %d slots used"
                    % (k2_vs_k1, n_used, n * k_slots))
    if not k2_vs_k1 <= HID_TOL:
        die("K2 rows differ from K1 rows at the same positions: %.3e" % k2_vs_k1)

    # K1u, the unfolded form (float32 embedded rows, cross K/V projected in
    # the kernel) at K1's shape; no path of navc_tpu or of the port calls it
    x_u = torch.randn(n, l, h, generator=g).to(dev)
    enc_u = torch.repeat_interleave(enc, cfg.length_beam_size, 0)
    err_u = 0.0
    for causal in (False, True):
        out_u = fused_layer_unfolded(x_u, enc_u, kp, ops.layer, ops.n_head, causal,
                                     torch.bfloat16)
        want_u = fused_layer_unfolded_plain(x_u, enc_u, kp, ops.layer, ops.n_head,
                                            causal, torch.bfloat16)
        torch.cuda.synchronize()
        e, sc, re, rs = scaled_err(out_u, want_u)
        if not (e <= TRAIN_TOL * sc and re <= TRAIN_RMS_TOL * rs):
            die("fused_layer_unfolded (%s) disagrees with its plain version: max err "
                "%.3e (scale %.3e), rms err %.3e (rms %.3e)"
                % ("causal" if causal else "nar", e, sc, re, rs))
        err_u = max(err_u, e)
    weights_b = (8 * h * h + 2 * h * inter) * 2 + (8 * h + inter + h) * 4
    rec_k1u = record(
        "fused_layer_unfolded", err_u, None,
        cuda_ms(lambda: fused_layer_unfolded(x_u, enc_u, kp, ops.layer, ops.n_head,
                                             False, torch.bfloat16)),
        cuda_ms(lambda: fused_layer_unfolded_plain(x_u, enc_u, kp, ops.layer,
                                                   ops.n_head, False, torch.bfloat16),
                iters=5),
        layer_flops(real, real, n, le, h, inter) + 2 * 2 * n * le * h * h,
        n * l * h * 4 + n * le * h * 4 + n * l + weights_b + n * l * h * 2,
        note="  (max_err: absolute, NAR and causal; tolerance %.0e of the largest "
        "|value| and %.0e of the rms; no path of navc_tpu reaches it: launches 0)"
        % (TRAIN_TOL, TRAIN_RMS_TOL))

    # K3 / K4 on the dense layer output (R = N * L rows)
    hid = out_k1.view(n * l, h)
    w16, wb = ops.proj_w, ops.proj_b
    r = hid.shape[0]
    ids_k, maxp_k = project_argmax(hid, w16, wb)
    ids_p, maxp_p = project_argmax_plain(hid, w16, wb)
    scores = hid.float() @ w16.float().t()
    top2 = scores.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    id_mismatch = int(((ids_k != ids_p) & clear).sum())
    p_err = float(((maxp_k - maxp_p).abs() / maxp_p).max())
    log("project_argmax ids: %d of %d rows differ where the top-2 margin > 1e-3 "
        "(%d rows within 1e-3)" % (id_mismatch, r, int((~clear).sum())))
    if id_mismatch:
        die("project_argmax ids disagree with the plain version")
    # the tied-projection form (bias operand) on the same rows
    bias = torch.randn(v, generator=g).to(dev) * 0.1
    ids_b, maxp_b = project_argmax(hid, w16, bias)
    ids_bp, maxp_bp = project_argmax_plain(hid, w16, bias)
    sb = scores + bias
    t2 = sb.topk(2, dim=-1).values
    clear_b = (t2[:, 0] - t2[:, 1]) > 1e-3
    if int(((ids_b != ids_bp) & clear_b).sum()):
        die("project_argmax (bias) ids disagree with the plain version")
    p_err = max(p_err, float(((maxp_b - maxp_bp).abs() / maxp_bp).max()))
    fl3 = 2 * r * h * v
    nb3 = r * h * 2 + v * h * 2 + r * 8
    lib3 = cuda_ms(lambda: torch.matmul(hid, w16.t()))
    rec_k3 = record("project_argmax", p_err, 1e-4,
                    cuda_ms(lambda: project_argmax(hid, w16, wb)),
                    cuda_ms(lambda: project_argmax_plain(hid, w16, wb), iters=5),
                    fl3, nb3, lib_ms=lib3, note="  (max_err: max prob, relative)")

    t_hid = out_k1c.view(n * l, h)
    targets = torch.randint(0, v, (r,), generator=g).to(dev, torch.int32)
    prob_k = project_gather_prob(t_hid, tops.proj_w, targets, tops.proj_b)
    prob_p = project_gather_prob_plain(t_hid, tops.proj_w, targets, tops.proj_b)
    g_err = float(((prob_k - prob_p).abs() / prob_p).max())
    rec_k4 = record("project_gather_prob", g_err, 1e-4,
                    cuda_ms(lambda: project_gather_prob(t_hid, tops.proj_w,
                                                        targets, tops.proj_b)),
                    cuda_ms(lambda: project_gather_prob_plain(
                        t_hid, tops.proj_w, targets, tops.proj_b), iters=5),
                    fl3, nb3 + r * 4,
                    lib_ms=cuda_ms(lambda: torch.matmul(t_hid, tops.proj_w.t())),
                    note="  (max_err: prob, relative)")
    rec_nar["max_abs_err"] = max(err_nar, err_causal)
    torch.cuda.synchronize()

    # -- 4. the main path: StreamingCaptioner, 4 requests of 64 videos -------
    rng = np.random.RandomState(7)

    def request():
        feats = [rng.randn(N_VIDEOS, cfg.n_frames, d).astype(np.float32)
                 for d in cfg.modality_dims]
        return feats, rng.randint(0, cfg.num_category, (N_VIDEOS, 1)).astype(np.int64)

    warm = request()
    reqs = [request() for _ in range(N_REQUESTS)]
    cap = StreamingCaptioner(cfg, model, (tcfg, teacher), depth=2)
    list(cap.map_stream([warm]))  # first use: cuBLAS handles, allocator
    torch.cuda.synchronize()
    _build.reset_launches()
    outs, per_request = cap.timed_stream(reqs)
    launches = dict(_build.LAUNCHES)
    log("main path: %d requests x %d videos, %.2f ms per request (%.1f "
        "captions/s, host clock, depth 2); launches %s" % (
            N_REQUESTS, N_VIDEOS, per_request * 1e3,
            N_VIDEOS / per_request, launches))
    for name, per in PER_DECODE.items():
        if launches[name] != per * N_REQUESTS:
            die("%s launched %d times, expected %d (%d per decode)"
                % (name, launches[name], per * N_REQUESTS, per))

    for hyp in outs:
        if hyp.shape != (N_VIDEOS, cfg.max_len) or hyp.dtype != np.int32:
            die("hypotheses of shape %s %s" % (hyp.shape, hyp.dtype))
        if hyp.min() < 0 or hyp.max() >= v:
            die("token ids out of range")
        nonpad = hyp != C.PAD
        length = np.where(nonpad.any(1), cfg.max_len - np.argmax(nonpad[:, ::-1], 1), 0)
        if length.min() < 4 or length.max() > cfg.max_len - 1:
            die("caption lengths outside [4, %d]: %s" % (cfg.max_len - 1, length))
        tail = np.arange(cfg.max_len)[None] >= length[:, None]
        if np.any(hyp[tail] != C.PAD):
            die("non-PAD token after a caption's end")

    # where one request's time goes on the card (not counted above)
    extra = request()
    print_profile(device_breakdown(lambda: list(cap.map_stream([extra]))))

    # the first request's first videos again, on the CPU, plain versions
    cpu_model = build_model(cfg, device="cpu", generator=seeded(0))
    cpu_teacher = build_model(tcfg, device="cpu", generator=seeded(1))
    feats, cats = reqs[0]
    cpu_cap = StreamingCaptioner(cfg, cpu_model, (tcfg, cpu_teacher), depth=0,
                                 device="cpu")
    t0 = time.perf_counter()
    (cpu_hyp,) = cpu_cap.map_stream([([f[:CPU_VIDEOS] for f in feats],
                                      cats[:CPU_VIDEOS])])
    agree = float((cpu_hyp == outs[0][:CPU_VIDEOS]).mean())
    log("CPU plain decode of %d videos (%.1f s): token agreement %.4f"
        % (CPU_VIDEOS, time.perf_counter() - t0, agree))
    if agree < 0.99:
        die("token agreement with the CPU plain path %.4f < 0.99" % agree)

    # -- 5. ARB beam search ----------------------------------------------------
    arb_recs, arb_launches = arb_phases(tcfg, teacher, cpu_teacher, record)

    # -- 6. the training step ----------------------------------------------------
    t0 = time.perf_counter()
    train_recs, train_launches = train_phases(record, seeded)
    log("training phases: %.1f s" % (time.perf_counter() - t0))

    # -- 7. the entry point: train_network_all at full width -------------------
    t0 = time.perf_counter()
    entry_point_phase()
    log("entry point phase: %.1f s" % (time.perf_counter() - t0))

    # -- 8. results -----------------------------------------------------------
    def entry(name, source, replaces, rec, counts=launches):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counts[name], **rec)

    kernels = [
        entry("fused_layer", "navc_tpu_torch/csrc/fused_layer.cu",
              "navc_tpu/ops/fused_layer.py:289", rec_nar),
        entry("fused_layer_qsub", "navc_tpu_torch/csrc/fused_layer.cu",
              "navc_tpu/ops/fused_layer.py:461", rec_k2),
        entry("project_argmax", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_fused.py:128", rec_k3),
        entry("project_gather_prob", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_fused.py:229", rec_k4),
        entry("project_topk", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_fused.py:350", arb_recs["project_topk"],
              arb_launches),
        entry("beam_attend_step", "navc_tpu_torch/csrc/beam_attend.cu",
              "navc_tpu/ops/beam_attend.py:371", arb_recs["beam_attend_step"],
              arb_launches),
        entry("cross_attend", "navc_tpu_torch/csrc/beam_attend.cu",
              "navc_tpu/ops/beam_attend.py:301", arb_recs["cross_attend"],
              arb_launches),
        entry("permute_beam_caches", "navc_tpu_torch/csrc/beam_permute.cu",
              "navc_tpu/ops/beam_permute.py:101",
              arb_recs["permute_beam_caches"], arb_launches),
        entry("train_fwd", "navc_tpu_torch/csrc/fused_layer_train.cu",
              "navc_tpu/ops/fused_layer_train.py:411", train_recs["train_fwd"],
              train_launches),
        entry("train_ffn_bwd", "navc_tpu_torch/csrc/fused_layer_train.cu",
              "navc_tpu/ops/fused_layer_train.py:447", train_recs["train_ffn_bwd"],
              train_launches),
        entry("train_attn_bwd", "navc_tpu_torch/csrc/fused_layer_train.cu",
              "navc_tpu/ops/fused_layer_train.py:499", train_recs["train_attn_bwd"],
              train_launches),
        entry("train_wgrad", "navc_tpu_torch/csrc/fused_layer_train.cu",
              "navc_tpu/ops/fused_layer_train.py:447,:499 (their weight-gradient "
              "accumulation)", train_recs["train_wgrad"], train_launches),
        entry("ce_fwd", "navc_tpu_torch/csrc/vocab_ce.cu",
              "navc_tpu/ops/vocab_ce.py:118", train_recs["ce_fwd"], train_launches),
        entry("ce_bwd_dh", "navc_tpu_torch/csrc/vocab_ce.cu",
              "navc_tpu/ops/vocab_ce.py:152", train_recs["ce_bwd_dh"], train_launches),
        entry("ce_bwd_dw", "navc_tpu_torch/csrc/vocab_ce.cu",
              "navc_tpu/ops/vocab_ce.py:152", train_recs["ce_bwd_dw"], train_launches),
        dict(entry("fused_layer_unfolded", "navc_tpu_torch/csrc/fused_layer.cu",
                   "navc_tpu/ops/fused_layer.py:303", rec_k1u),
             note="no path of navc_tpu reaches the unfolded form (its decodes pass "
             "static=, which selects :289); held against its plain version only"),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
