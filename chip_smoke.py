#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (navc_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from navc_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch version on the card at the NACF main
path's shapes and times both, then serves four 64-video requests through
StreamingCaptioner with a full-width NACF student and ARB teacher (random
weights from a seed), checks the launch counts and the outputs, profiles
one more request with torch.profiler (device time by kernel, idle share),
and decodes part of the first request again on the CPU through the plain
versions. It exits non-zero on any failure, without a CUDA device, and
outside a checkout. Imports nothing of JAX or navc_tpu.

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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
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
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
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
                                                fused_layer_qsub_plain)
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

    def record(name, err, tol, ms, plain_ms, flops, nbytes, lib_ms=None, note=""):
        b_ms, b_by = bound(flops, nbytes)
        log("%-20s max_err %.3e (tol %.1e)  kernel_ms %.4f  plain_ms %.4f  "
            "library_ms %s  bound_ms %.4f (%s)%s" % (
                name, err, tol, ms, plain_ms,
                "null" if lib_ms is None else "%.4f" % lib_ms, b_ms, b_by, note))
        if not err <= tol:
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
    prof = device_breakdown(lambda: list(cap.map_stream([extra])))
    if prof is None:
        log("profiler: no device activity recorded (breakdown not measured)")
    else:
        window, busy, by_name = prof
        log("profile of one request: window %.3f ms, device busy %.3f ms, "
            "idle share %.3f" % (window, busy, 1.0 - busy / window))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for name, (ms, count) in top[:14]:
            log("  %8.3f ms %4d x  %s" % (ms, count, name[:90]))
        rest = sum(ms for _, (ms, _) in top[14:])
        log("  %8.3f ms        (%d other kernels)" % (rest, max(0, len(top) - 14)))

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

    # -- 5. results -----------------------------------------------------------
    def entry(name, source, replaces, rec):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], **rec)

    kernels = [
        entry("fused_layer", "navc_tpu_torch/csrc/fused_layer.cu",
              "navc_tpu/ops/fused_layer.py:289", rec_nar),
        entry("fused_layer_qsub", "navc_tpu_torch/csrc/fused_layer.cu",
              "navc_tpu/ops/fused_layer.py:461", rec_k2),
        entry("project_argmax", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_fused.py:128", rec_k3),
        entry("project_gather_prob", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_fused.py:229", rec_k4),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
