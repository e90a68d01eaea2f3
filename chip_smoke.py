#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (navc_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--parent DIR]

It builds the port's CUDA kernels from navc_tpu_torch/csrc with nvcc and
drives the two ported serving paths at full width (random weights from a
seed). NACF: each of K1-K4 held against its plain PyTorch version at the
NACF main path's shapes and timed (K1 NAR and causal, and K2, also beside
bf16 torch.matmul of their products at their shapes, `matmul_ms`, and
given --parent the parent's K1 and K2 in turns; K1 bit for bit the same in
two calls, its PAD rows zero); K3 also at the decode's sparse row
counts (9216, 6144, 3072), K3/K4 untied, tied and with a bias ten times the
scores' scale, and timed beside torch.matmul on the same operands and,
given --parent (a checkout of an earlier commit, e.g. a `git archive` of
the parent), beside that checkout's K3/K4 in turns, called through its own
wrappers in a second process (this script with --worker DIR, which imports
DIR's navc_tpu_torch); four 64-video requests through
StreamingCaptioner with an NACF student and ARB teacher, with the launch
counts and outputs checked; one more request profiled with torch.profiler
(device time by kernel, idle share) and, given --parent, timed in turns
with the parent's request and a fresh worker's; part of the first request decoded
again on the CPU through the plain versions. ARB beam search: each of K5-K8
held against its plain version at the ARB main path's shapes and timed (K5
at 320, 300 and 5120 rows, k 1, 5 and 8, untied, tied and with a large
bias; timed at k 5 beside torch.matmul and the parent's K5, with the host's
cost of one wrapper call on both sides; K6 at 320 and 5120 rows, single
steps and a chained decode, timed at tpos 14 beside the parent's K6 in
turns; K7 at 320 and 5120 rows with bf16 and float32 K/V, bit for bit the
same in two calls, timed beside bf16 SDPA, in each head group it takes and
beside the parent's K7 in turns); four 64-video requests (K5, K6, K7
once per beam step) and one 60-video request (K8 instead of K6) through
StreamingCaptioner; decodes at B=1024 under bench.py's protocol (with
--parent, in turns with the parent's own decode), then one more profiled
(K5's, K6's and K7's shares of the device time); one request profiled; 16 videos decoded
again on the CPU. Training: K11, K12a, K12b and the weight-gradient
reduction held against their plain versions at full width (B=64, dropout
0.5) and timed (K11 in turns with the parent's), and again at B=2048 (all
four checked against their plain versions there too and bit for bit the
same in two calls; K11/K12a/K12b timed beside bf16 torch.matmul of the
products they compute on the same operands, `matmul_ms`, and the parent's
kernels in turns; the reduction beside torch.matmul and the parent's
reduction); the fused projection + cross-entropy K9 and K10 (both
launches) held against their plain versions at the B=64 NACF pass, untied,
tied and with a large bias, with K9's ties inside one thread and across
vocab splits and labels at V - 1, K10 bit for bit the same in two calls at
B=2048, timed at B=64 and B=2048 (the backward per launch) beside the
logits route on the same operands and the parent's K9/K10 in turns; 5 NACF
steps of 64 videos through run_train_epoch (launch counts, ms per step,
peak memory, one step profiled); bench.py's train protocol at B=2048
(profiled: K9/K10's share; with --parent, in turns with the parent's own
step: synchronised ms, idle share, peak memory); one bf16 step of
16 videos against the CPU plain path; 20 steps on one batch at dropout 0.1
must lower the loss; these steps, the B=64 epochs and the B=2048 protocol
are the compiled step (make_train_step's default jit=True: one CUDA graph
per batch signature, navc_tpu's jitted step), the kernels taking their
dropout seed as a (1,) int32 on the card. The train graphs phase: the
NACF step at B=64 and B=2048, dropout 0.5, replayed against the eager
route (jit=False) from the same weights, batches and CPU generator state
(loss and every gradient bit for bit, B=64 over 5 steps under a warm-up
lr, then every parameter and buffer; at lr 0 two replays' losses differ,
each the eager step's with the same draws), ms per step on both routes
(median of 10 epochs, in turns), first call and capture seconds, pool
MiB, peak GB, launches per replayed step, idle share of one profiled
step on each route. K1u (the unfolded eval layer, which no path calls;
K11's launches at p = 0) is held against its plain version at K1's shape,
NAR and causal, bit for bit the same in two calls, and timed beside bf16
torch.matmul of its products and the parent's K1u in turns. The entry point:
train_network_all at full width on a synthetic 320-video corpus, ARB for
one epoch, then NACF for two with that teacher (validation decodes through
K1-K7, steps through K9-K12). The inference entry points: an NACF and an
ARB model saved as .ckpt files, the 64-video test split of that corpus
captioned and scored through cli.translate's body on the card (mp + CT
with the ARB teacher and --record, l2r, ef, mp with -collect, ARB beam 5;
the launches of each, no <mask> in a caption, the collect pickle's last
iteration the caption), CaptionPipeline against Evaluator.decode_batch,
l2r and ef on 8 videos against the CPU plain path, and each decode timed.
The serving paths, the translate runs and CaptionPipeline replay CUDA
graphs (jit=True, navc_tpu's jax.jit; first use captures); the main path
lines print the eager route (jit=False) beside the replayed one and die
unless their tokens are equal; translate's and the Evaluator's l2r and ef
decodes replay graphs too. The graphs phase: NACF with the ARB teacher at
64 videos (mp + CT; l2r without and with CT and ef, q 1, their rounds
under CUDA graph IF nodes, ef in blocks of 4 rounds ended by a lagged
flag read), ARB at 64 (K6/K7), 60 (K8) and 1024 videos, and ARB's
full-prefix step (navc_tpu's NAVC_NO_KVCACHE switch: K1 causal once a
step) at 64 videos; then, through StreamingCaptioner on random weights,
NAB (the ARB teacher's rescoring, no CT pass) in mp (K1-K4, the launches
of mp without CT), l2r and ef at 64 videos, and ARB2's KV-cached beam at
64 (K5, K6, K7) and 60 videos (K5, K8) and its full-prefix step (K1);
each decode eager and replayed (tokens bit for bit equal on two
requests, launches of a replayed decode the eager decode's and the
case's own: PER_DECODE, mp's without CT, the beam steps or the rounds
that ran, ef's blocks and flag reads, ms per decode on both routes in
turns, the first call's and the capture's seconds, the graph pool's
bytes, and both routes profiled: idle share and where it falls; the
full-prefix routes also against the CPU on 16 videos and teacher-forced
against K1's plain version, the NAB and ARB2 decodes against the CPU
plain path). The methods phase: for NAB and ARB2, one bf16 step at p = 0
of 16 videos against the CPU plain path and the compiled step at B=64
replayed bit for bit the eager one (ARB2: two decoder passes a step, each
with its own device seed), on batches from the data pipeline. The
inference phase also translates from a NAB and an ARB2 .ckpt. The
learning phase: make_flagship_synthetic at full width (256 videos of 32
classes), ARB, then NACF and NAB with its best.ckpt as teacher, then ARB2
trained through train_network_all (10 epochs of batch 64 each): the train
loss falls and each test CIDEr clears its floor (LEARN_FLOOR); on the
trained weights the ARB beam stops before step 29 on 64 held-out videos
(replayed bit for bit, launches once a step that ran, >= 0.99 with the CPU
plain path), NACF's l2r and ef (with and without CT) replay their eager
decodes, mp keeps one graph for three requests, and the trained ARB's and
ARB2's full-prefix routes hold K1's teacher-forced log-probs within 5e-2
of its plain version's and their beams agree >= 0.99 with the CPU beam
through K1's plain version and through the model's own forward. The
switches phase: each of navc_tpu's A/B route switches (NAVC_DENSE_REFINE,
NAVC_NO_ATTEND_KERNEL alone and with NAVC_NO_PERMUTE_KERNEL,
NAVC_NO_TOPK_KERNEL, NAVC_NO_FUSED_TRAIN, NAVC_NO_FUSED_CE) in a fresh
process of its own (this script with --switch NAME, the switch in its
environment before anything is built), on the 64-video NACF mp decode, the
64-video ARB decode or the B=64 NACF compiled step, against the default
route run here: launches per replay (K2 gone, K1 the refinements; K6 and
K7 gone, K8 once a step, or none; K5 gone; K9-K12 or K9/K10 gone), tokens
against the default route's or the CPU's, the p = 0 step against the CPU
plain path and the compiled step bit for bit the eager one, replayed ms
beside the default's. The selfmask phase: an ARB configuration with
decoding_type SelfMask (parallel_mlm): the p = 0 step against the CPU, the
compiled B=64 step bit for bit the eager one (the module route: no
kernel), a 64-video beam through K5-K7 replayed bit for bit, against the
CPU, timed. The remat phase: the NACF step at B=2048, dropout 0.1, remat
off and on, eager and replayed, on the fused route and (in a --switch
process under NAVC_NO_FUSED_TRAIN) the module route: every loss and
gradient bit for bit remat off's, launches a step (K11 and K9 twice a pass
with remat), peak GB, ms per step. The offline phase: the native scorer
built with the host's C++ compiler, the inference phase's captions scored
natively and in Python (equal within 1e-10, timed), and prepare_corpora on
an MSR-VTT-shaped annotation at its published size (10,000 videos x 20
captions, cut only if a 1000-video run projects more than 30 s). The
parallel phase: NACF at full width, global batch 64, dropout 0, against
the single-process step on the whole batch, each rank a fresh process of
tests/torch_port_dist_worker.py: two ranks on the card over gloo, eager, 3
steps (losses, each parameter's global gradient and the BatchNorm
statistics within their gates, the ranks bit for bit alike, ms per step);
NCCL's refusal of two ranks on one device, printed; one rank on NCCL, the
step captured with its collectives (bit for bit its eager run, a replay's
launches the single-process replay's, no collective issued from the host)
and train_network_all_multihost for one epoch; cli.train.main with
--distributed on two gloo ranks (rank 0 alone validates and writes
best.ckpt, which then decodes here); data 1 x model 2 (each rank half of
every TP parameter, held to the same gates). The extract phase: a seeded random ResNet-101 through
make_backbone on 224 x 224 frames, on the card against the CPU forward
(TF32 off), frames/s at batch 32, and two videos' features through an NACF
encode and decode. It exits non-zero on any failure, without a CUDA
device, and outside a checkout.
Imports nothing of JAX or navc_tpu.

Standard output ends with two JSON lines: {"kernels": [...]} and
{"ok": true, "device": {...}}.
"""

import atexit
import contextlib
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
SPARSE_ROWS = (9216, 6144, 3072)  # K3's sparse calls in a decode: k_bound 24, 16, 8 of N = 384
TOPK_ROWS = (320, 300, 5120)  # K5's beam rows: 64- and 60-video requests, the B=1024 decode
OVER = dict(dataset="MSRVTT", vocab_size=10048, use_pallas=True)  # bench.py's models


class Worker:
    """A checkout's navc_tpu_torch in a second process: this script again
    with --worker DIR, which imports DIR's navc_tpu_torch and builds DIR's
    kernels with DIR's own _build. --parent DIR runs the parent commit's
    wrappers so; DIR = this checkout gives this tree's in a process as
    fresh as the parent's. Operands go over as a torch.save file in DIR's
    build directory; each request is a JSON line on the worker's stdin, each
    reply a JSON line on its stdout. The worker runs only while this process
    waits for its reply, so the two time in turns."""

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self.file = worker_file(self.root)
        os.makedirs(os.path.dirname(self.file), exist_ok=True)
        self.ready = False
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", self.root],
            cwd=self.root, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        atexit.register(self.close)

    def _reply(self):
        line = self.proc.stdout.readline()
        if not line:
            die("the worker for %s exited with code %s" % (self.root, self.proc.wait()))
        rep = json.loads(line)
        if "error" in rep:
            die("the worker for %s: %s" % (self.root, rep["error"]))
        return rep

    def ask(self, **req):
        if not self.ready:  # the worker's first line: its kernels are built
            log("worker for %s: kernels built by its own _build in %.1f s"
                % (self.root, self._reply()["build_s"]))
            self.ready = True
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        return self._reply()

    def load(self, kind, operands, **args):
        """Hand the worker a case: ``kind`` (see ``worker_case``) on
        ``operands`` (a dict of tensors); it runs the case once and its
        outputs (a dict of tensors) come back on the card."""
        import torch

        torch.save(operands, self.file)
        self.ask(cmd="load", kind=kind, args=args)
        out = torch.load(self.file, map_location="cuda")
        os.remove(self.file)
        return out

    def time(self, timer):
        """The loaded case timed in the worker by TIMERS[timer]."""
        return self.ask(cmd="time", timer=timer)["t"]

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def worker_file(root):
    return os.path.join(root, "navc_tpu_torch", "build", "chip_smoke_operands.pt")


def worker_case(kind, ops, args):
    """A callable of the worker's (DIR's) wrapper for one case; it returns a
    dict of tensors."""
    import torch

    from navc_tpu_torch.ops import vocab_fused as VF

    if kind == "project_argmax":
        return lambda: dict(zip(("ids", "p"), VF.project_argmax(ops["h"], ops["w"], ops["bias"])))
    if kind == "project_gather_prob":
        return lambda: dict(p=VF.project_gather_prob(ops["h"], ops["w"], ops["targets"],
                                                     ops["bias"]))
    if kind == "project_topk":
        return lambda: dict(zip(("lp", "ids"), VF.project_topk(ops["h"], ops["w"], args["k"],
                                                                ops["bias"])))
    if kind == "vocab_ce_fwd":
        from navc_tpu_torch.ops import vocab_ce as VC

        return lambda: dict(zip(("g", "pred", "z"), VC.vocab_ce_fwd(
            ops["h"], ops["w"], ops["bias"], ops["labels"])))
    if kind == "vocab_ce_bwd":
        from navc_tpu_torch.ops import vocab_ce as VC

        return lambda: dict(zip(("dh", "dw", "db"), VC.vocab_ce_bwd(
            ops["h"], ops["w"], ops["bias"], ops["labels"], ops["z"], ops["dg"],
            dh_dtype=torch.bfloat16)))
    if kind == "train_step":
        step, batch, gen = bench_train_step(args["seed"])
        return lambda: dict(loss=torch.tensor(float(step(batch, gen)["total_loss"])))
    if kind == "train_epoch":
        run = nacf_epoch(args["seed"])
        return lambda: dict(loss=torch.tensor(run()["total_loss"]))
    if kind == "weight_grads":
        from navc_tpu_torch.ops.fused_layer_train import Product, weight_grads

        calls = [[Product(**pr) for pr in call] for call in ops["calls"]]
        return lambda: {k: v for call in calls for k, v in weight_grads(call).items()}
    if kind == "fused_layer":
        from navc_tpu_torch.ops import fused_layer as FL

        return lambda: dict(out=FL.fused_layer(
            ops["raw"], ops["static"], ops["kp"], ops["ke"], ops["ve"], FL.LayerWeights(**ops["w"]),
            ops["lns"], ops["lnb"], n_head=args["n_head"], causal=args["causal"],
            out_dtype=torch.bfloat16))
    if kind == "beam_attend_step":
        from navc_tpu_torch.ops.beam_attend import beam_attend_step

        return lambda: dict(zip(("kc", "vc", "att"), beam_attend_step(
            ops["kc"], ops["vc"], ops["q"], ops["kt"], ops["vt"], ops["prev_k"], ops["amask"],
            args["tpos"], args["nh"])))
    if kind == "cross_attend":
        from navc_tpu_torch.ops.beam_attend import cross_attend

        return lambda: dict(att=cross_attend(ops["q"], ops["ke"], ops["ve"], args["nh"]))
    if kind == "fused_layer_unfolded":
        from navc_tpu_torch.ops import fused_layer as FL

        return lambda: dict(out=FL.fused_layer_unfolded(
            ops["x"], ops["enc"], ops["kp"], FL.LayerWeights(**ops["w"]), args["n_head"],
            args["causal"], torch.bfloat16))
    if kind == "fused_layer_qsub":
        from navc_tpu_torch.ops import fused_layer as FL

        return lambda: dict(out=FL.fused_layer_qsub(
            ops["qidx"], ops["mrow"], ops["raw"], ops["static"], ops["kp"], ops["ke"], ops["ve"],
            FL.LayerWeights(**ops["w"]), ops["lns"], ops["lnb"], n_head=args["n_head"],
            out_dtype=torch.bfloat16))
    if kind in ("train_fwd", "ffn_bwd", "attn_bwd"):
        from navc_tpu_torch.ops import fused_layer_train as FT

        if kind == "train_fwd":
            return lambda: dict(zip(("out", "r2"), FT.train_fwd(
                ops["x"], ops["enc"], ops["kp"], ops["w"], args["seed"],
                out_dtype=torch.bfloat16, **args["kw"])))
        if kind == "ffn_bwd":
            return lambda: dict(out=FT.ffn_bwd_operands(ops["r2"], ops["dy"], ops["kp"], ops["w"],
                                                        args["seed"], p=args["kw"]["p"])[0])
        return lambda: dict(out=FT.attn_bwd_operands(ops["x"], ops["enc"], ops["dr2"], ops["kp"],
                                                     ops["w"], args["seed"], **args["kw"])[0])
    if kind == "nacf_decode":
        from navc_tpu_torch.config import default_config
        from navc_tpu_torch.models import build_model
        from navc_tpu_torch.runtime.serving import StreamingCaptioner

        cfg, tcfg = (default_config(m, **args["over"]) for m in ("NACF", "ARB"))
        model, teacher = (build_model(c, device="cuda", generator=torch.Generator().manual_seed(s))
                          for c, s in ((cfg, args["seed"]), (tcfg, args["seed"] + 1)))
        cap = StreamingCaptioner(cfg, model, (tcfg, teacher), depth=2)
        req = ([f.cpu().numpy() for f in ops["feats"]], ops["cat"].cpu().numpy())
        return lambda: dict(hyp=torch.as_tensor(list(cap.map_stream([req]))[0]))
    if kind == "arb_decode":
        from navc_tpu_torch.config import default_config
        from navc_tpu_torch.models import build_model
        from navc_tpu_torch.runtime.serving import StreamingCaptioner

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        cfg = default_config("ARB", **args["over"])
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator().manual_seed(args["seed"]))
        cap = StreamingCaptioner(cfg, model, depth=2)
        with torch.no_grad():
            enc = model.encode(ops["feats"])
        return lambda: dict(hyp=cap.generate(enc, ops["cat"])[0].cpu())
    raise ValueError("no worker case %r" % kind)


def serve_worker(root):
    """--worker DIR: serve a Worker's requests with DIR's own
    navc_tpu_torch, until stdin closes."""
    replies = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # what DIR's code prints goes to stderr
    sys.stdout = sys.stderr
    root = os.path.abspath(root)
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or os.curdir) != ROOT]

    def reply(**rep):
        replies.write(json.dumps(rep) + "\n")
        replies.flush()

    import torch

    import navc_tpu_torch
    from navc_tpu_torch.ops import _build

    if not os.path.abspath(navc_tpu_torch.__file__).startswith(root + os.sep):
        reply(error="navc_tpu_torch came from %s, not %s" % (navc_tpu_torch.__file__, root))
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    reply(build_s=time.perf_counter() - t0)
    call = None
    for line in sys.stdin:
        req = json.loads(line)
        try:
            if req["cmd"] == "load":
                call = None
                torch.cuda.empty_cache()
                file = worker_file(root)
                call = worker_case(req["kind"], torch.load(file, map_location="cuda"),
                                   req["args"])
                out = call()
                torch.cuda.synchronize()
                torch.save(out, file)
                reply(ok=True)
            else:
                reply(t=TIMERS[req["timer"]](call))
        except Exception as e:  # the reply carries it to the main process, which fails
            reply(error="%s: %r" % (req, e))
    return 0


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


def host_ms(fn, iters=3):
    """Mean host-clock milliseconds per call of ``fn``, which synchronises."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def host_us(fn, iters=50):
    """Host microseconds to issue one call of ``fn`` while a device-side
    sleep holds the card, so that the calls only queue: the wrapper's own
    cost on the host, apart from the kernel's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def launch_ms(fn, name, calls=5):
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    names contain ``name`` (a launch and its second pass), from a profile of
    ``calls`` calls."""
    for _ in range(3):  # as device_breakdown, should a profile come back without them
        prof = device_breakdown(lambda: [fn() for _ in range(calls)])
        hits = [] if prof is None else [v for k, v in prof[2].items() if name in k]
        if hits:
            return sum(v[0] for v in hits) / calls
    die("the profiler recorded no device time for %s" % name)


def host_breakdown(fn, calls=50, top=10):
    """Where ``fn``'s host time goes: the functions and operators with the
    most host time of their own, from cProfile over ``calls`` calls queued
    while a device-side sleep holds the card, as [(name, us per call)]."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(((v[2], "%s:%d(%s)" % (os.path.basename(k[0]), k[1], k[2]))
                   for k, v in pstats.Stats(prof).stats.items()), reverse=True)
    return [(name, round(t / calls * 1e6, 1)) for t, name in rows[:top]]


def idle_share(fn):
    """The device's idle share over one profiled call of ``fn``."""
    prof = device_breakdown(fn)
    if prof is None:
        die("the profiler recorded no device activity")
    return 1.0 - prof[1] / prof[0]


def peak_gb(fn):
    """Peak device memory (GB) one call of ``fn`` allocates above what the
    process held before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 1e9


# the timers both this process and a worker (Worker.time) use
TIMERS = {"device": device_ms, "cuda5": lambda fn: cuda_ms(fn, iters=5),
          "host3": host_ms, "host_us": host_us,
          "ce_bwd_dh": lambda fn: launch_ms(fn, "ce_bwd_dh"),
          "ce_bwd_dw": lambda fn: launch_ms(fn, "ce_bwd_dw"),
          "train_sync": lambda fn: host_ms(fn, iters=TRAIN_BENCH_ITERS),
          "epoch_step": lambda fn: host_ms(fn) / TRAIN_STEPS,
          "host_ops": lambda fn: sum(host_ops(fn).values()),
          "idle": idle_share, "peak_gb": peak_gb}


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


def device_breakdown(run, tries=3):
    """Profile ``run`` with torch.profiler: (window ms, device-busy ms,
    {kernel name: [device ms, launches]}, {"lead": ms from the window's
    start to the first device event, "gaps": idle ms between the first
    and the last, "tail": ms after the last, "events": device events}), or
    None if the profiler saw no device activity in ``tries`` profiles of it
    (one profile beside a worker process's came back empty once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = list(prof.events())
        # device events, without the spans of user annotations (torch.optim's
        # "Optimizer.step#Adam.step" marks its kernels on the device timeline)
        kern = [e for e in events if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("Optimizer.")]
        if kern:
            break
    else:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    first, last = spans[0][0], max(e for _, e in spans)
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    by_name = {}
    for e in kern:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    timeline = {"lead": (first - start) / 1e3, "gaps": (last - first - busy) / 1e3,
                "tail": (end - last) / 1e3, "events": len(kern)}
    return (end - start) / 1e3, busy / 1e3, by_name, timeline


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
    window, busy, by_name, tl = prof
    log("profile of one %s: window %.3f ms, device busy %.3f ms, "
        "idle share %.3f (before the first device event %.3f ms, between device "
        "events %.3f, after the last %.3f; %d device events)" % (
            what, window, busy, 1.0 - busy / window, tl["lead"], tl["gaps"], tl["tail"],
            tl["events"]))
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


def cross_layouts(k, te, h, nh, sms, gen, instances=(16, 64, 128, 256, 512, 1024)):
    """K7 in each head group and thread layout it takes, through its C entry
    (the wrapper takes ``cross_groups``' plan), at beam k and bf16 K/V over
    ``instances``: each held against the plain version, timed, and the
    plan's time set beside the fastest. Returns {instances: {"plan": [g,
    layout], "ms": {"g layout": ms}}}."""
    import ctypes
    import math

    import torch

    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops.beam_attend import (_SIGNATURES, cross_attend_plain,
                                                cross_group_ok, cross_groups)

    lib = _build.load("beam_attend", _SIGNATURES)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for b in instances:
        q = torch.randn(b * k, h, generator=gen).to("cuda")
        ke, ve = (torch.randn(b, te, h, generator=gen).to("cuda", torch.bfloat16)
                  for _ in range(2))
        att = torch.empty_like(q)
        want = cross_attend_plain(q, ke, ve, nh)
        times = {}
        for gg in range(1, nh + 1):
            for reuse in (0, 1) if cross_group_ok(gg, k, te, h, nh, 2) else ():
                def run():
                    _build.check(lib, lib.navc_cross_attend(
                        q.data_ptr(), ke.data_ptr(), ve.data_ptr(), att.data_ptr(), b * k, k,
                        te, h, nh, 1.0 / math.sqrt(h // nh), 0, gg, reuse, stream),
                        "cross_attend")
                run()
                if float((att - want).abs().max()) > 1e-4:
                    die("cross_attend with %d heads a block, reuse %d, disagrees with its "
                        "plain version at %d instances" % (gg, reuse, b))
                times["%d %s" % (gg, ("narrow", "reuse")[reuse])] = device_ms(run)
        gg, reuse = cross_groups(b, k, te, h, nh, 2, sms)
        plan = "%d %s" % (gg, ("narrow", "reuse")[reuse])
        best = min(times, key=times.get)
        out[str(b)] = {"plan": plan, "ms": times}
        log("cross_attend layouts at %d instances (%d blocks planned): planned %s %.4f ms, "
            "fastest %s %.4f ms; %s" % (
                b, b * nh // gg, plan, times[plan], best, times[best],
                ", ".join("%s %.4f" % kv for kv in times.items())))
    return out


def arb_phases(cfg, model, cpu_model, record, parent):
    """K5-K8 against their plain versions at the ARB main path's shapes, then
    ARB serving through StreamingCaptioner. ``parent``: a Worker or None.
    Returns ({kernel: record}, {kernel: launches on the ARB main path})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.decoding import make_ar_generator
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops.beam_attend import (beam_attend_step,
                                                beam_attend_step_plain,
                                                cross_attend,
                                                cross_attend_plain,
                                                cross_groups)
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

    # K5: projection + top-k at the beam step's row counts (the 64- and
    # 60-video requests, the B=1024 decode), k 1, 5 and 8, untied, tied and
    # with a bias ten times the scores' scale
    w16, _ = projection_weights(model)
    hid_all = (torch.randn(max(TOPK_ROWS), h, generator=g) * 2).to(dev, torch.bfloat16)
    scores = hid_all.float() @ w16.float().t()
    scale = float(scores[:1024].std())
    cases = {"untied": None, "tied": (torch.randn(v, generator=g) * 0.1).to(dev),
             "large bias": (torch.randn(v, generator=g) * 10 * scale).to(dev)}
    err, near = 0.0, 0
    for case, bb in cases.items():
        srt = (scores if bb is None else scores + bb).topk(9, dim=-1).values
        for rows in TOPK_ROWS:
            for kk in (1, 5, 8):
                lp, ids = project_topk(hid_all[:rows], w16, kk, bb)
                lp_p, ids_p = project_topk_plain(hid_all[:rows], w16, kk, bb)
                clear = (srt[:rows, :kk] - srt[:rows, 1:kk + 1]) > 1e-3
                bad = int(((ids != ids_p) & clear).sum())
                if bad:
                    die("project_topk (%s, %d rows, k %d): %d ids disagree with the plain "
                        "version where the gap to the next candidate > 1e-3"
                        % (case, rows, kk, bad))
                err = max(err, float((lp - lp_p).abs().max()))
                near += int((~clear).sum())
    log("project_topk: ids equal where the gap to the next candidate > 1e-3 at %s rows, "
        "k 1 / 5 / 8, untied, tied and large bias (%d pairs within 1e-3)"
        % ("/".join(map(str, TOPK_ROWS)), near))
    # times at k = 5 beside torch.matmul on the same bf16 operands and,
    # given --parent, the parent commit's K5 in turns (parent, this, this,
    # parent); the host's cost of one wrapper call, both sides
    by_rows = {}
    for rows in TOPK_ROWS:
        hh = hid_all[:rows]
        run = lambda: project_topk(hh, w16, k)  # noqa: E731
        t = dict(library_ms=device_ms(lambda: torch.matmul(hh, w16.t())))
        if parent is None:
            t["ms"] = device_ms(run)
            t["host_us"] = host_us(run)
        else:
            got = parent.load("project_topk", dict(h=hh, w=w16, bias=None), k=k)
            lp, ids = run()
            torch.cuda.synchronize()
            top = scores[:rows].topk(k + 1, dim=-1).values
            clear = (top[:, :-1] - top[:, 1:]) > 1e-3
            if (float((got["lp"] - lp).abs().max()) > 1e-4
                    or bool(((got["ids"] != ids) & clear).any())):
                die("the parent's project_topk disagrees with this one at %d rows" % rows)
            p1, k1, k2, p2 = (parent.time("device"), device_ms(run), device_ms(run),
                              parent.time("device"))
            u1, ku1, ku2, u2 = (parent.time("host_us"), host_us(run), host_us(run),
                                parent.time("host_us"))
            t.update(ms=(k1 + k2) / 2, parent_ms=(p1 + p2) / 2, host_us=(ku1 + ku2) / 2,
                     parent_host_us=(u1 + u2) / 2)
        t["bound_ms"] = bound(2 * rows * h * v, rows * h * 2 + v * h * 2 + rows * k * 8)[0]
        by_rows[str(rows)] = t
        log("project_topk at %d x %d x %d, k %d: kernel %.4f ms, torch.matmul %.4f ms "
            "(%.2fx), parent %s, bound %.4f ms; host %.1f us per call (parent %s)" % (
                rows, h, v, k, t["ms"], t["library_ms"], t["ms"] / t["library_ms"],
                "%.4f ms (%.2fx faster)" % (t["parent_ms"], t["parent_ms"] / t["ms"])
                if "parent_ms" in t else "not run", t["bound_ms"], t["host_us"],
                "%.1f us" % t["parent_host_us"] if "parent_host_us" in t else "not run"))
    n_main = str(n)
    hid = hid_all[:n]
    recs["project_topk"] = record(
        "project_topk", err, 1e-4, by_rows[n_main]["ms"],
        device_ms(lambda: project_topk_plain(hid, w16, k), iters=5),
        2 * n * h * v, n * h * 2 + v * h * 2 + n * k * 8,
        lib_ms=by_rows[n_main]["library_ms"],
        note="  (max_err: log-prob, absolute, over %s rows, k 1 / 5 / 8, untied, tied, "
             "large bias)" % "/".join(map(str, TOPK_ROWS)))
    recs["project_topk"]["by_rows"] = by_rows
    if "parent_ms" in by_rows[n_main]:
        recs["project_topk"]["parent_ms"] = by_rows[n_main]["parent_ms"]

    # K6: single steps at tpos 0, 14, 29, then every step of a decode, at
    # the 64-video request's rows and the B=1024 decode's
    def step_inputs(bb, tpos):
        q, kt, vt = (torch.randn(bb * k, h, generator=g).to(dev) for _ in range(3))
        prev_k = torch.randint(0, k, (bb, k), generator=g).to(dev, torch.int32)
        mask = torch.arange(l)[None, :] > tpos
        mask = mask | ((torch.rand(bb * k, l, generator=g) < 0.1) & (torch.arange(l) > 0))
        mask[:, tpos] = False
        return q, kt, vt, prev_k, torch.where(mask, -1e7, 0.0).to(dev)

    def caches(rows):
        return tuple(torch.randn(rows, l * h, generator=g).to(dev, torch.bfloat16)
                     for _ in range(2))

    def step_err(kc, vc, args, tpos):
        rk, rv = kc.clone(), vc.clone()
        ok, ov, att = beam_attend_step(kc, vc, *args, tpos, nh)
        rk, rv, ratt = beam_attend_step_plain(rk, rv, *args, tpos, nh)
        lim = (tpos + 1) * h
        if not (torch.equal(ok[:, :lim], rk[:, :lim])
                and torch.equal(ov[:, :lim], rv[:, :lim])):
            die("beam_attend_step caches differ from the plain version at "
                "%d rows, tpos %d" % (kc.shape[0], tpos))
        return float((att - ratt).abs().max())

    err = 0.0
    step_rows = (b, ARB_BENCH)  # instances: 320 and 5120 beam rows
    for bb in step_rows:
        for tpos in (0, 14, 29):
            err = max(err, step_err(*caches(bb * k), step_inputs(bb, tpos), tpos))
        kc = torch.zeros(bb * k, l * h, dtype=torch.bfloat16, device=dev)
        vc = torch.zeros_like(kc)
        for tpos in range(l - 1):
            args = step_inputs(bb, tpos)
            if tpos == 0:
                args[3].zero_()
            err = max(err, step_err(kc, vc, args, tpos))
        del kc, vc
    log("beam_attend_step: single steps at tpos 0, 14, 29 and a chained %d-step decode "
        "agree with the plain version at %s rows (attention max err %.3e)"
        % (l - 1, " and ".join(str(bb * k) for bb in step_rows), err))
    # times at tpos 14, both row counts, and given --parent the parent's K6
    # on the same operands in turns (parent, this, this, parent)
    tpos = 14
    steps_by_rows = {}
    for bb in step_rows:
        rows = bb * k
        kc, vc = caches(rows)
        args = step_inputs(bb, tpos)
        run = lambda: beam_attend_step(kc, vc, *args, tpos, nh)  # noqa: E731
        t = {}
        if parent is None:
            t["ms"] = device_ms(run)
        else:
            got = parent.load("beam_attend_step", dict(kc=kc, vc=vc, q=args[0], kt=args[1],
                                                       vt=args[2], prev_k=args[3],
                                                       amask=args[4]), tpos=tpos, nh=nh)
            ok, ov, att = beam_attend_step(kc.clone(), vc.clone(), *args, tpos, nh)
            torch.cuda.synchronize()
            lim = (tpos + 1) * h
            if not (torch.equal(got["kc"][:, :lim], ok[:, :lim])
                    and torch.equal(got["vc"][:, :lim], ov[:, :lim])
                    and float((got["att"] - att).abs().max()) <= 1e-4):
                die("the parent's beam_attend_step disagrees with this one at %d rows" % rows)
            del got, ok, ov, att
            p1, a1, a2, p2 = (parent.time("device"), device_ms(run), device_ms(run),
                              parent.time("device"))
            t.update(ms=(a1 + a2) / 2, parent_ms=(p1 + p2) / 2)
        t["bytes"] = (2 * rows * tpos * h * 2 + 3 * rows * h * 4 + rows * 4
                      + rows * (tpos + 1) * 4 + 2 * rows * (tpos + 1) * h * 2 + rows * h * 4)
        t["bound_ms"] = bound(4 * rows * (tpos + 1) * h, t["bytes"], PEAK_F32_FLOPS)[0]
        steps_by_rows[str(rows)] = t
        log("beam_attend_step at %d rows, tpos %d: kernel %.4f ms, parent %s, bound %.4f ms"
            % (rows, tpos, t["ms"], "%.4f ms (%.2fx faster)" % (
                t["parent_ms"], t["parent_ms"] / t["ms"]) if "parent_ms" in t else "not run",
               t["bound_ms"]))
        del kc, vc
    kc, vc = caches(n)
    args = step_inputs(b, tpos)
    t = steps_by_rows[str(n)]
    recs["beam_attend_step"] = record(
        "beam_attend_step", err, 1e-4, t["ms"],
        device_ms(lambda: beam_attend_step_plain(kc, vc, *args, tpos, nh), iters=5),
        4 * n * (tpos + 1) * h, t["bytes"], peak=PEAK_F32_FLOPS,
        note="  (tpos %d; max_err: attention, absolute, at %s rows; library_ms null: no "
             "one PyTorch call permutes, appends and attends)"
        % (tpos, " and ".join(steps_by_rows)))
    recs["beam_attend_step"]["by_rows"] = steps_by_rows
    if "parent_ms" in t:
        recs["beam_attend_step"]["parent_ms"] = t["parent_ms"]
    del kc, vc

    # K7: cross-attention over the Te encoder positions at the 64-video
    # request's rows and the B=1024 decode's, float32 and bf16 K/V (the
    # decode's) against the plain version; timed with bf16 K/V beside bf16
    # SDPA, and given --parent beside the parent's K7 on the same operands
    # in turns (parent, this, this, parent)
    dh = h // nh
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, cross_by_rows = 0.0, {}
    for bb in step_rows:
        rows = bb * k
        q = torch.randn(rows, h, generator=g).to(dev)
        kv32 = [torch.randn(bb, te, h, generator=g).to(dev) for _ in range(2)]
        for dt in (torch.float32, torch.bfloat16):
            ke, ve = (t.to(dt) for t in kv32)
            att = cross_attend(q, ke, ve, nh)
            err = max(err, float((att - cross_attend_plain(q, ke, ve, nh)).abs().max()))
            if not torch.equal(cross_attend(q, ke, ve, nh), att):
                die("cross_attend: two calls differ at %d rows" % rows)
        run = lambda: cross_attend(q, ke, ve, nh)  # noqa: E731
        q4 = q.to(torch.bfloat16).view(bb, k, nh, dh).transpose(1, 2)
        k4 = ke.view(bb, te, nh, dh).transpose(1, 2)
        v4 = ve.view(bb, te, nh, dh).transpose(1, 2)
        t = dict(library_ms=device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
                 plan=cross_groups(bb, k, te, h, nh, 2, sms))
        if parent is None:
            t["ms"] = device_ms(run)
        else:
            got = parent.load("cross_attend", dict(q=q, ke=ke, ve=ve), nh=nh)["att"]
            if float((got - att).abs().max()) > 1e-4:
                die("the parent's cross_attend disagrees with this one at %d rows" % rows)
            p1, a1, a2, p2 = (parent.time("device"), device_ms(run), device_ms(run),
                              parent.time("device"))
            t.update(ms=(a1 + a2) / 2, parent_ms=(p1 + p2) / 2)
        t["bytes"] = rows * h * 4 + 2 * bb * te * h * 2 + rows * h * 4
        t["bound_ms"] = bound(4 * rows * te * h, t["bytes"], PEAK_F32_FLOPS)[0]
        cross_by_rows[str(rows)] = t
        log("cross_attend at %d rows, Te %d: kernel %.4f ms (%d heads a block, %s), bf16 "
            "SDPA %.4f ms, parent %s, bound %.4f ms" % (
                rows, te, t["ms"], t["plan"][0], "reuse" if t["plan"][1] else "narrow",
                t["library_ms"],
                "%.4f ms (%.2fx faster)" % (t["parent_ms"], t["parent_ms"] / t["ms"])
                if "parent_ms" in t else "not run", t["bound_ms"]))
    t = cross_by_rows[str(n)]
    q = torch.randn(n, h, generator=g).to(dev)
    ke, ve = (torch.randn(b, te, h, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    recs["cross_attend"] = record(
        "cross_attend", err, 1e-4, t["ms"],
        device_ms(lambda: cross_attend_plain(q, ke, ve, nh), iters=5),
        4 * n * te * h, t["bytes"], lib_ms=t["library_ms"], peak=PEAK_F32_FLOPS,
        note="  (max_err: absolute, bf16 and float32 K/V at %s rows; library: bf16 SDPA)"
        % " and ".join(cross_by_rows))
    recs["cross_attend"]["by_rows"] = cross_by_rows
    if "parent_ms" in t:
        recs["cross_attend"]["parent_ms"] = t["parent_ms"]
    recs["cross_attend"]["by_layout"] = cross_layouts(k, te, h, nh, sms, g)

    # K8: the cache permute
    kc, vc = caches(n)
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
    eager_cap = StreamingCaptioner(cfg, model, depth=2, jit=False)
    list(eager_cap.map_stream([reqs[0]]))
    eager_outs, eager_request = eager_cap.timed_stream(reqs)
    del eager_cap
    steps0 = cap.generate.steps_run
    _build.reset_launches()
    outs, per_request = cap.timed_stream(reqs)
    launches = {name: _build.LAUNCHES[name] for name in ARB_KERNELS}
    steps = cap.generate.steps_run - steps0
    log("ARB main path: %d requests x %d videos, %.2f ms per request (%.1f "
        "captions/s, host clock, depth 2; replayed CUDA graphs, eager route %.2f ms); "
        "%d beam steps (%.2f per decode); launches %s" % (
            N_REQUESTS, b, per_request * 1e3, b / per_request, eager_request * 1e3,
            steps, steps / N_REQUESTS, launches))
    if not all(np.array_equal(x, y) for x, y in zip(outs, eager_outs)):
        die("ARB main path: the replayed requests' tokens differ from the eager route's")
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
    eager = make_ar_generator(cfg, model, jit=False)
    eager(enc, cat)[0].cpu()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        eager_hyp = eager(enc, cat)[0].cpu()
    eager_dt = time.perf_counter() - t0
    del eager
    steps0 = cap.generate.steps_run
    t0 = time.perf_counter()
    for _ in range(iters):
        hyp = cap.generate(enc, cat)[0].cpu()
    dt = time.perf_counter() - t0
    log("ARB decode at B=%d (bench.py protocol, %d decodes, %.1f beam steps "
        "each): %.2f ms per decode, %.1f captions/s (replayed CUDA graphs; eager route "
        "%.2f ms, %.1f captions/s), peak memory %.2f GB" % (
            ARB_BENCH, iters, (cap.generate.steps_run - steps0) / iters,
            dt / iters * 1e3, ARB_BENCH * iters / dt, eager_dt / iters * 1e3,
            ARB_BENCH * iters / eager_dt, torch.cuda.max_memory_allocated() / 1e9))
    if not torch.equal(hyp, eager_hyp):
        die("ARB decode at B=%d: the replayed tokens differ from the eager route's" % ARB_BENCH)
    check_captions(hyp.numpy(), ARB_BENCH, l, v, C.EOS, C.PAD)
    if parent is not None:
        # the parent commit's decode (its own model from the same seed, its
        # own wrappers), this tree's in a worker as fresh as the parent's,
        # and this one in turns: parent, fresh, this, this, fresh, parent,
        # three times, 3 decodes each
        fresh = Worker(ROOT)
        case = dict(feats=[torch.as_tensor(f) for f in big[0]], cat=cat.cpu())
        got = {w: w.load("arb_decode", case, over=OVER, seed=1)["hyp"].cpu()
               for w in (parent, fresh)}
        decode = lambda: cap.generate(enc, cat)[0].cpu()  # noqa: E731
        ms = {"this": [], "this, fresh process": [], "parent": []}
        for _ in range(3):
            ms["parent"].append(parent.time("host3"))
            ms["this, fresh process"].append(fresh.time("host3"))
            ms["this"] += [host_ms(decode), host_ms(decode)]
            ms["this, fresh process"].append(fresh.time("host3"))
            ms["parent"].append(parent.time("host3"))
        fresh.close()
        log("ARB decode at B=%d in turns: %s ms per decode; token agreement with this "
            "process's decode: parent %.4f, fresh process %.4f" % (
                ARB_BENCH, "; ".join("%s %s (mean %.2f)" % (
                    who, " ".join("%.2f" % x for x in t), np.mean(t)) for who, t in ms.items()),
                float((got[parent] == hyp).float().mean()),
                float((got[fresh] == hyp).float().mean())))
    prof = device_breakdown(lambda: cap.generate(enc, cat)[0].cpu())
    print_profile(prof, "B=%d decode" % ARB_BENCH)
    if prof is not None:
        k5 = [(ms, count) for name, (ms, count) in prof[2].items()
              if "argmax_kernel<2," in name or "argmax_merge_kernel<2," in name]
        log("K5 in the B=%d decode: %.3f ms of %.3f device-busy ms (share %.3f), %d "
            "launches (walk + merge)" % (ARB_BENCH, sum(ms for ms, _ in k5), prof[1],
                                         sum(ms for ms, _ in k5) / prof[1],
                                         sum(c for _, c in k5)))
        k6 = [(ms, count) for name, (ms, count) in prof[2].items()
              if "step_run_kernel" in name or "step_merge_kernel" in name]
        log("K6 in the B=%d decode: %.3f ms of %.3f device-busy ms (share %.3f), %d "
            "launches (runs + merges)" % (ARB_BENCH, sum(ms for ms, _ in k6), prof[1],
                                          sum(ms for ms, _ in k6) / prof[1],
                                          sum(c for _, c in k6)))
        k7 = [(ms, count) for name, (ms, count) in prof[2].items() if "cross_kernel" in name]
        log("K7 in the B=%d decode: %.3f ms of %.3f device-busy ms (share %.3f), %d "
            "launches" % (ARB_BENCH, sum(ms for ms, _ in k7), prof[1],
                          sum(ms for ms, _ in k7) / prof[1], sum(c for _, c in k7)))

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


GRAPH_ROUNDS = 5  # rounds of (eager, replayed, replayed, eager) decodes per case


@contextlib.contextmanager
def swapped(owner, attr, value):
    """``owner.attr`` replaced by ``value`` inside the block."""
    before = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, before)


def captured_graphs(gen):
    """The ``runtime.graphs.Graph``s a generator captured: one per
    signature (the mp and l2r decodes), or a loop's head, block(s) and
    tail per signature (the beam search's, ef's)."""
    out = []
    for c in gen.graphs.values():
        out += c.parts() if hasattr(c, "parts") else [c.graph]
    return out


@contextlib.contextmanager
def no_kvcache():
    """navc_tpu's NAVC_NO_KVCACHE switch on around a beam generator's
    construction (the full-prefix step), then as it was."""
    before = os.environ.get("NAVC_NO_KVCACHE")
    os.environ["NAVC_NO_KVCACHE"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["NAVC_NO_KVCACHE"]
        else:
            os.environ["NAVC_NO_KVCACHE"] = before


# the graphs phase's cases: (name, method, videos, config replacements
# (None: the full-prefix step, NAVC_NO_KVCACHE), served). The l2r case
# without CT, since random weights leave nothing masked after CT, so only
# it runs l2r's reveal rounds. NAB has no CT pass: every slot of its first
# canvas starts masked. ``served``: the decode through StreamingCaptioner
# (features staged, encoded inside the request), its tokens also against
# the CPU plain path on the first videos of a request; else the generator
# on encoded requests
GRAPH_CASES = (
    ("NACF 64 videos", "NACF", N_VIDEOS, {}, False),
    ("NACF l2r 64 videos", "NACF", N_VIDEOS,
     dict(paradigm="l2r", use_ct=False, q=1, q_iterations=1), False),
    ("NACF l2r + CT 64 videos", "NACF", N_VIDEOS,
     dict(paradigm="l2r", use_ct=True, q=1, q_iterations=1), False),
    ("NACF ef 64 videos", "NACF", N_VIDEOS,
     dict(paradigm="ef", use_ct=False, q=1, q_iterations=1), False),
    ("ARB 64 videos", "ARB", ARB_VIDEOS, {}, False),
    ("ARB 60 videos", "ARB", ARB_RAGGED, {}, False),
    ("ARB 1024 videos", "ARB", ARB_BENCH, {}, False),
    ("ARB full prefix 64 videos", "ARB", ARB_VIDEOS, None, False),
    ("NAB mp 64 videos", "NAB", N_VIDEOS, {}, True),
    ("NAB l2r 64 videos", "NAB", N_VIDEOS, dict(paradigm="l2r", q=1, q_iterations=1), True),
    ("NAB ef 64 videos", "NAB", N_VIDEOS, dict(paradigm="ef", q=1, q_iterations=1), True),
    ("ARB2 64 videos", "ARB2", ARB_VIDEOS, {}, True),
    ("ARB2 60 videos", "ARB2", ARB_RAGGED, {}, True),
    ("ARB2 full prefix 64 videos", "ARB2", ARB_VIDEOS, None, True),
)
METHOD_SEEDS = {"NAB": 2, "ARB2": 3}  # the random weights' seeds (NACF 0, ARB 1)
# mp without CT (NAB): one dense pass on the all-mask canvas and 4 sparse
# refinements (PER_DECODE's CT pass and its dense completion step are gone),
# then the teacher's causal K1 and K4
MP_NO_CT = {"fused_layer": 2, "fused_layer_qsub": 4, "project_argmax": 5,
            "project_gather_prob": 1}
COND_KERNELS = ("fused_layer", "project_argmax", "project_gather_prob")  # l2r / ef


PREFIX_LOGP_TOL = 5e-2  # K1's bf16 roundings against the forward's, through the projection


def teacher_forced_hidden(cfg, model, enc, cat, seqs, ops=None):
    """The decoder's hidden states (N, L, D) at every prefix position of
    ``seqs`` (N = videos x beam), the full-prefix beam step's layer: K1
    over the whole prefix with ``static=`` (``prefix_hidden``, operands
    ``ops``: K1 on the card, its plain version on the CPU) or, with ``ops``
    None, the model's own forward."""
    import torch

    from navc_tpu_torch.decoding.beam import prefix_hidden, prefix_static
    from navc_tpu_torch.decoding.length_beam import enlarge

    k = seqs.shape[0] // enc.shape[0]
    cat_tiled = enlarge(cat, k)
    with torch.no_grad():
        if ops is None:
            return model.decode(seqs, enlarge(enc, k), cat_tiled, "ARFormer")[0]
        static = prefix_static(ops, seqs.shape[0], seqs.shape[1],
                               cat_tiled if cfg.with_category else None)
        return prefix_hidden(ops, seqs, static, *ops.cross_kv(enc, k))


def prefix_logp(model, hidden, exact=False):
    """Log-probs of ``hidden`` on the CPU: through the step's own
    ``model.project`` (bf16 logits) or, ``exact``, float32 products of the
    bf16 hidden and weights (the logits unrounded)."""
    import torch

    from navc_tpu_torch.ops.vocab_fused import projection_weights

    with torch.no_grad():
        if not exact:
            return torch.log_softmax(model.project(hidden).float(), -1).cpu()
        w, bias = projection_weights(model)
        logits = hidden.to(torch.bfloat16).float() @ w.float().t()
        return torch.log_softmax(logits if bias is None else logits + bias, -1).cpu()


def k1_plain_decode(cfg, model):
    """A stand-in for ``model.decode`` in the full-prefix beam step on the
    CPU: the layer through K1's plain version (the card route's
    arithmetic) instead of the model's own forward."""
    from navc_tpu_torch.decoding.beam import prefix_hidden, prefix_static
    from navc_tpu_torch.decoding.operands import KernelOperands

    ops = KernelOperands.of(model)

    def decode(seqs, enc_tiled, cat_tiled, mode):
        static = prefix_static(ops, seqs.shape[0], seqs.shape[1],
                               cat_tiled if cfg.with_category else None)
        return prefix_hidden(ops, seqs, static, *ops.cross_kv(enc_tiled, 1)), None
    return decode


def full_prefix_checks(tcfg, teacher, cpu_teacher, req, replay, where, trained=False):
    """The full-prefix ARB route (NAVC_NO_KVCACHE) on the card against the
    CPU: K1's plain version (the same bf16 roundings) and the model's own
    forward, navc_tpu's CPU route.

    Teacher-forced, on one prefix set at the request's videos x beam (each
    video's replayed hypothesis and beam - 1 random prefixes, PAD after a
    random length), at every position a beam step projects: K1 on the card
    against K1's plain version on the CPU, both through a float32
    projection (``exact``), gated within PREFIX_LOGP_TOL, and K1 with its
    static lacking the position rows, or the category rows, beyond it;
    also, through the step's own bf16 logits, K1 on the card against the
    CPU forward, gated within PREFIX_LOGP_TOL on random weights and printed
    on ``trained`` ones (logits of tens of nats, where one bf16 step is
    0.125-0.5: the step at the largest |logit| is printed beside it), and K1
    on the card against K1's plain version. Beam tokens on ARB_CPU videos:
    the card replay against the CPU beam with the layer through K1's plain
    version (``k1_plain_decode``), >= 0.99, and, on ``trained`` weights,
    against the CPU beam through the forward, >= 0.99 (ROADMAP Queue C;
    printed on random weights, whose beams turn on rounding points, as the
    CPU's own full-prefix and KV-cached beams' agreement and the forward's
    median gap between its two most likely words are). ``where`` names the
    phase in its lines."""
    import dataclasses

    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.decoding import make_ar_generator
    from navc_tpu_torch.decoding.operands import KernelOperands

    enc, cat = req
    enc_cpu, cat_cpu = {k: v.cpu() for k, v in enc.items()}, cat.cpu()
    hyp = replay(enc, cat)[0].cpu()
    k, l = tcfg.beam_size, tcfg.max_len
    rng = np.random.RandomState(37)
    seqs = np.full((hyp.shape[0] * k, l), C.PAD, np.int32)
    seqs[:, 1:] = rng.randint(C.NUM_SPECIAL_TOKENS, tcfg.vocab_size, (len(seqs), l - 1))
    seqs[::k, 1:] = hyp.numpy()
    seqs[:, 0] = C.BOS
    seqs[np.arange(l)[None, :] >= rng.randint(2, l + 1, len(seqs))[:, None]] = C.PAD
    seqs = torch.from_numpy(seqs)
    valid = seqs != C.PAD  # the positions a beam step projects
    enc_out = enc["enc_output"]
    plain = teacher_forced_hidden(tcfg, cpu_teacher, enc_cpu["enc_output"], cat_cpu, seqs,
                                  KernelOperands.of(cpu_teacher))
    refs = {exact: prefix_logp(cpu_teacher, plain, exact) for exact in (True, False)}
    forward = prefix_logp(cpu_teacher, teacher_forced_hidden(
        tcfg, cpu_teacher, enc_cpu["enc_output"], cat_cpu, seqs))
    ops = KernelOperands.of(teacher)

    def gap(ref, exact=True, **edit):
        got = prefix_logp(teacher, teacher_forced_hidden(
            tcfg, teacher, enc_out, cat, seqs.cuda(), dataclasses.replace(ops, **edit)), exact)
        return float((got - ref).abs()[valid].max())
    out = dict(logp_gap_plain=gap(refs[True]),
               logp_gap_no_positions=gap(refs[True], pos_table=torch.zeros_like(ops.pos_table)))
    if tcfg.with_category:
        out["logp_gap_no_category"] = gap(refs[True], cat_table=torch.zeros_like(ops.cat_table))
    out.update(logp_gap=gap(forward, False), logp_gap_plain_bf16=gap(refs[False], False))
    with torch.no_grad():
        top_logit = float(cpu_teacher.project(plain[valid]).abs().max())
    out["bf16_step_at_top_logit"] = float(2.0 ** (np.floor(np.log2(top_logit)) - 7))
    top2 = forward[valid].topk(2, -1).values
    out["median_top2_margin"] = float((top2[:, 0] - top2[:, 1]).median())
    log(where + ": full prefix, teacher-forced at %d videos x beam %d, %d positions, max "
        "|log p| of K1 on the card: against K1's plain version on the CPU, float32 logits "
        "%.5f (limit %.3f), with static lacking the position rows %.5f%s (limit: beyond "
        "%.3f); through the step's bf16 logits against K1's plain version %.5f, against "
        "the CPU forward %.5f (%s; the bf16 step at the largest |logit|, %.3f: %.4f); "
        "median top-2 margin of the forward %.4f" % (
            hyp.shape[0], k, int(valid.sum()), out["logp_gap_plain"], PREFIX_LOGP_TOL,
            out["logp_gap_no_positions"],
            ", lacking the category rows %.5f" % out["logp_gap_no_category"]
            if "logp_gap_no_category" in out else "", PREFIX_LOGP_TOL,
            out["logp_gap_plain_bf16"], out["logp_gap"],
            "no gate: trained weights" if trained else "limit %.3f" % PREFIX_LOGP_TOL,
            top_logit, out["bf16_step_at_top_logit"], out["median_top2_margin"]))
    if out["logp_gap_plain"] > PREFIX_LOGP_TOL:
        die(where + ": full prefix: K1's log-probs %.5f from its plain version's > %.3f"
            % (out["logp_gap_plain"], PREFIX_LOGP_TOL))
    if not trained and out["logp_gap"] > PREFIX_LOGP_TOL:
        die(where + ": full prefix: K1's log-probs %.5f from the CPU forward's > %.3f"
            % (out["logp_gap"], PREFIX_LOGP_TOL))
    broken = {key: v for key, v in out.items() if key.startswith("logp_gap_no")}
    if min(broken.values()) <= PREFIX_LOGP_TOL:
        die(where + ": full prefix: a broken static stays within %.3f: %s"
            % (PREFIX_LOGP_TOL, broken))

    small = ({key: v[:ARB_CPU] for key, v in enc_cpu.items()}, cat_cpu[:ARB_CPU])
    dev_hyp = replay({key: v[:ARB_CPU] for key, v in enc.items()}, cat[:ARB_CPU])[0].cpu()
    with no_kvcache():
        cpu_gen = make_ar_generator(tcfg, cpu_teacher)
    cached_hyp = make_ar_generator(tcfg, cpu_teacher)(*small)[0]
    forward_hyp = cpu_gen(*small)[0]
    with swapped(cpu_teacher, "decode", k1_plain_decode(tcfg, cpu_teacher)):
        plain_hyp = cpu_gen(*small)[0]
    del cpu_teacher.decode  # swapped set an instance attribute: back to the class's
    same = lambda a, b: float((a == b).float().mean())  # noqa: E731
    out.update(agree_k1_plain=same(plain_hyp, dev_hyp), agree_forward=same(forward_hyp, dev_hyp),
               cpu_full_prefix_vs_cached=same(forward_hyp, cached_hyp))
    log(where + ": full prefix, beam tokens on %d videos: the card replay against the CPU "
        "beam through K1's plain version %.4f (gate 0.99), through the model's own forward "
        "%.4f (%s); the CPU's full-prefix and KV-cached beams %.4f (no gate)" % (
            ARB_CPU, out["agree_k1_plain"], out["agree_forward"],
            "gate 0.99" if trained else "no gate", out["cpu_full_prefix_vs_cached"]))
    if out["agree_k1_plain"] < 0.99:
        die(where + ": full prefix: token agreement with the CPU plain path %.4f < 0.99"
            % out["agree_k1_plain"])
    if trained and out["agree_forward"] < 0.99:
        die(where + ": full prefix: token agreement with the CPU forward %.4f < 0.99"
            % out["agree_forward"])
    return out


def graphs_phase(cfg, model, tcfg, teacher, cpu_teacher, card):
    """The captured decodes (jit=True) against the eager route (jit=False)
    at full width, GRAPH_CASES: NACF with the ARB teacher at 64 videos (mp
    + CT, l2r without and with CT, ef; q 1), ARB at 64 (K6 + K7), 60 (K8)
    and 1024 videos and its full-prefix step (NAVC_NO_KVCACHE: K1 causal a
    step) at 64; then, through StreamingCaptioner, NAB (random weights from
    METHOD_SEEDS, the ARB teacher's rescoring, no CT pass) in mp (K1-K4),
    l2r and ef (K1, K3, K4) and ARB2 at 64 (K5, K6, K7), 60 (K5, K8) and its
    full-prefix step. For each: the replayed tokens (and the beam's scores)
    bit for bit the eager ones, on the capture's request and on a second
    one; the launches of one replayed decode the eager decode's and the
    case's own: PER_DECODE (mp + CT), MP_NO_CT (mp without CT), each of
    COND_KERNELS (l2r, ef: the rounds that ran), once a beam step; ef's
    flag reads one fewer than its blocks; the hypotheses' shape and ids; ms
    per decode on both routes (median of 2 x GRAPH_ROUNDS each, in turns,
    host clock, each ending in the tokens' copy); the first call's seconds
    (the eager warm-up and the capture), the captures' seconds and the
    bytes their pools hold; the device idle share of one profiled decode on
    each route. The full-prefix routes also against the CPU
    (``full_prefix_checks``); the other served cases at a width the CPU
    takes (a multiple of 16) against the CPU plain path on CPU_VIDEOS (NAR)
    or ARB_CPU (beam) videos, >= 0.99. Returns {case: figures}."""
    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    cfgs = dict(NACF=cfg, ARB=tcfg, **{m: default_config(m, **OVER) for m in METHOD_SEEDS})
    if cfgs["NAB"].use_ct or cfgs["NAB"].visual_word_generation:
        die("graphs: NAB's default config takes a CT pass")
    models, cpu_models = dict(NACF=model, ARB=teacher), dict(ARB=cpu_teacher)
    for m, seed in METHOD_SEEDS.items():
        models[m], cpu_models[m] = (
            build_model(cfgs[m], device=where, generator=torch.Generator().manual_seed(seed))
            for where in ("cuda", "cpu"))
    rngs = {False: np.random.RandomState(29), True: np.random.RandomState(43)}
    results = {}
    for name, method, videos, over, served in GRAPH_CASES:
        c = cfgs[method].replace(**(over or {}))
        m = models[method]
        nar = c.decoding_type == "NARFormer"
        rng = rngs[served]
        reqs = []
        for _ in range(2):
            feats = [rng.randn(videos, c.n_frames, d).astype(np.float32)
                     for d in c.modality_dims]
            cat = rng.randint(0, c.num_category, (videos, 1)).astype(np.int64)
            if not served:
                feats, cat = [torch.as_tensor(f).cuda() for f in feats], \
                    torch.as_tensor(cat).cuda()
                with torch.no_grad():
                    enc = m.encode(feats)
                    reqs.append((enc, cat, teacher.encode(feats)) if nar else (enc, cat))
            else:
                reqs.append((feats, cat))
        with no_kvcache() if over is None else contextlib.nullcontext():
            if served:
                routes = {jit: StreamingCaptioner(c, m, (tcfg, teacher) if nar else None,
                                                  depth=0, jit=jit) for jit in (False, True)}
            elif nar:
                routes = {jit: make_nar_generator(c, m, teacher, jit) for jit in (False, True)}
            else:
                routes = {jit: make_ar_generator(c, m, jit) for jit in (False, True)}
        replay = routes[True].generate if served else routes[True]
        if not replay.graphed:
            die("graphs: the %s decode takes no captured route" % name)

        def call(route, req):
            """The decode's outputs as a list of tensors: the tokens (and the
            beam's scores, from a generator)."""
            if served:
                (hyp,) = route.map_stream([req])
                return [torch.from_numpy(hyp)]
            out = route(*req)
            return [out] if nar else list(out)

        want = []
        for r in reqs:
            _build.reset_launches()
            want.append(call(routes[False], r))
            eager_launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [call(routes[True], reqs[0])]  # the first call: warm-up and capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graphs = captured_graphs(replay)
        got += [call(routes[True], r) for r in reqs + reqs[:1]]
        for g, w in zip(got, [want[0], want[0], want[1], want[0]]):
            if not all(torch.equal(x, y) for x, y in zip(g, w)):
                die("graphs: %s: replayed tokens differ from the eager route's" % name)
        steps0 = getattr(replay, "steps_run", 0)
        blocks0, reads0 = getattr(replay, "blocks_run", 0), getattr(replay, "flag_reads", 0)
        _build.reset_launches()
        call(routes[True], reqs[1])
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        steps = getattr(replay, "steps_run", 0) - steps0
        ef = dict(blocks=replay.blocks_run - blocks0, flag_reads=replay.flag_reads - reads0,
                  rounds=int(replay.rounds)) if hasattr(replay, "blocks_run") else None
        if nar and c.paradigm == "mp":
            expect = dict(PER_DECODE if c.use_ct else MP_NO_CT)
        elif nar:
            expect = eager_launches
            if any(not launches.get(k) for k in COND_KERNELS):
                die("graphs: %s: a replayed decode launched %s, not each of %s"
                    % (name, launches, COND_KERNELS))
        elif over is None:
            expect = dict(fused_layer=steps)
        elif videos % 16 == 0:
            expect = dict(project_topk=steps, beam_attend_step=steps, cross_attend=steps)
        else:
            expect = dict(project_topk=steps, permute_beam_caches=steps)
        if launches != expect or eager_launches != expect:
            die("graphs: %s: a replayed decode launched %s, the eager one %s, expected %s"
                % (name, launches, eager_launches, expect))
        if ef is not None and ef["flag_reads"] != ef["blocks"] - 1:
            die("graphs: %s: %d flag reads for %d blocks" % (name, ef["flag_reads"],
                                                              ef["blocks"]))
        for g in got:
            hyp = g[0].cpu().numpy()
            if not nar:
                check_captions(hyp, videos, c.max_len, c.vocab_size, C.EOS, C.PAD)
            elif hyp.shape != (videos, c.max_len) or hyp.min() < 0 or hyp.max() >= c.vocab_size:
                die("graphs: %s: hypotheses of shape %s, ids %d..%d" % (
                    name, hyp.shape, hyp.min(), hyp.max()))
        run = {jit: (lambda r=r: call(r, reqs[1])[0].cpu()) for jit, r in routes.items()}
        ms = {False: [], True: []}
        for _ in range(GRAPH_ROUNDS):
            for jit in (False, True, True, False):
                ms[jit].append(host_ms(run[jit], iters=1))
        idle = {}
        for jit in (False, True):
            prof = device_breakdown(run[jit])
            idle[jit] = None if prof is None else 1.0 - prof[1] / prof[0]
            print_profile(prof, "%s decode, %s" % (name, "replayed" if jit else "eager"))
        agree = prefix = None
        n_cpu = CPU_VIDEOS if nar else ARB_CPU
        if over is None:
            enc, cat = reqs[1][:2]
            if served:
                with torch.no_grad():
                    enc = m.encode([torch.as_tensor(f).cuda() for f in enc])
                cat = torch.as_tensor(cat).cuda()
            prefix = full_prefix_checks(c, m, cpu_models[method], (enc, cat), replay,
                                        "graphs: " + name)
            agree, n_cpu = prefix["agree_k1_plain"], ARB_CPU
        elif served and videos % 16 == 0:  # the K8 width has no K6 / K7 at 16 videos
            cpu_cap = StreamingCaptioner(c, cpu_models[method],
                                         (tcfg, cpu_teacher) if nar else None, depth=0,
                                         device="cpu")
            small = ([f[:n_cpu] for f in reqs[0][0]], reqs[0][1][:n_cpu])
            (cpu_hyp,) = cpu_cap.map_stream([small])
            agree = float((cpu_hyp == want[0][0][:n_cpu].numpy()).mean())
            if agree < 0.99:
                die("graphs: %s: token agreement with the CPU plain path %.4f < 0.99"
                    % (name, agree))
        results[name] = dict(
            eager_ms=float(np.median(ms[False])), replay_ms=float(np.median(ms[True])),
            first_call_s=first_s, capture_s=sum(g.capture_s for g in graphs),
            graphs=len(graphs), pool_mb=sum(g.pool_bytes for g in graphs) / 2 ** 20,
            launches=launches, steps=steps or None, ef=ef, cpu_agreement=agree,
            full_prefix=prefix, eager_idle=idle[False], replay_idle=idle[True])
        r = results[name]
        log("graphs: %s [%s]: eager %.3f ms, replayed %.3f ms per decode (median of %d, "
            "host clock, %sends in the tokens' copy; %.2fx); tokens bit for bit the eager "
            "route's; first call %.3f s (warm-up + capture of %d graph(s): %.3f s), pool "
            "%.1f MiB; launches per replayed decode %s (the eager decode's)%s%s%s; idle "
            "share eager %s, replayed %s" % (
                name, card, r["eager_ms"], r["replay_ms"], 2 * GRAPH_ROUNDS,
                "a request through StreamingCaptioner at depth 0, " if served else "",
                r["eager_ms"] / r["replay_ms"], first_s, len(graphs), r["capture_s"],
                r["pool_mb"], launches, "; %d beam steps" % steps if steps else "",
                "" if ef is None else "; ef: %d reveal rounds, %d blocks, %d flag reads" % (
                    ef["rounds"], ef["blocks"], ef["flag_reads"]),
                "" if agree is None else "; CPU plain path agreement on %d videos %.4f" % (
                    n_cpu, agree),
                *("%.3f" % x if x is not None else "not measured" for x in (
                    idle[False], idle[True]))))
        del routes, replay, run, reqs, got, want
        torch.cuda.empty_cache()
    return results


def loader_batches(cfg, b, n, videos=160, seed=0):
    """``n`` training batches of ``b`` videos from the data pipeline (the
    loader of ``cfg``'s method: AR or NAR sources and targets, the
    visual-word pass's tokens_1 / labels_1 from the POS tags) over a seeded
    synthetic corpus at ``cfg``'s vocab, 2 captions a video."""
    import numpy as np

    from navc_tpu_torch.data.loader import get_loader
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats

    corpus, _ = make_synthetic_corpus(cfg, n_videos=videos, n_caps=2,
                                      vocab_size=cfg.vocab_size, seed=seed)
    feats = make_synthetic_feats(cfg, n_videos=videos, n_total_frames=ENTRY_FRAMES,
                                 seed=seed + 1)
    loader = get_loader(cfg, "train", info_corpus=corpus, in_memory_feats=feats,
                        batch_size=b, prefetch=0)
    assert int(videos * 0.6) >= b, (videos, b)  # a full batch each epoch
    out = []
    while len(out) < n:  # the arrays of the full batches, as run_train_epoch passes them
        out += [{k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
                for batch in loader if batch["num_valid"] == b]
    return out[:n]


def cpu_step_check(cfg, batch, seed, what):
    """One bf16 step at p = 0 of ``cfg``'s model (weights from ``seed``) on
    the card against the same step on the CPU (the plain versions): the
    loss within 1e-2 relative, every gradient within 5e-2 of the CPU's
    norm. Dies past them; returns the figures."""
    import numpy as np
    import torch

    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    sides = {}
    for where in ("cuda", "cpu"):
        m = build_model(cfg, device=where, generator=torch.Generator().manual_seed(seed),
                        train=True)
        st = create_train_state(cfg, m)
        met = make_train_step(cfg, m, st.optimizer)(batch, torch.Generator().manual_seed(1))
        sides[where] = (float(met["total_loss"]),
                        {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()})
    (loss_g, grad_g), (loss_c, grad_c) = sides["cuda"], sides["cpu"]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    key_bias = ("attention.self.key.bias", "attend_to_enc_output.self.key.bias")
    rel = {k: float((grad_g[k] - v).norm() / max(float(v.norm()), 1e-12))
           for k, v in grad_c.items() if not k.endswith(key_bias)}
    worst = max(rel, key=rel.get)
    log("%sbf16 step at p = 0, %d videos, card vs CPU plain path: loss %.5f vs %.5f "
        "(relative %.2e, tolerance 1e-2); gradient norm-relative error worst %.2e "
        "(%s), median %.2e over %d parameters (tolerance 5e-2; the two key biases, "
        "zero in exact arithmetic, left out)" % (
            what, batch["tokens"].shape[0], loss_g, loss_c, loss_rel, rel[worst], worst,
            float(np.median(list(rel.values()))), len(rel)))
    if not (loss_rel <= 1e-2 and rel[worst] <= 5e-2):
        die("%sthe card's bf16 training step disagrees with the CPU plain path" % what)
    return dict(loss_rel=loss_rel, worst_grad=rel[worst])


def step_launches(cfg, routes):
    """The kernel launches of one training step of ``cfg`` on ``routes``
    (``TrainRoutes``): each decoder pass's K11, K12a, K12b once and the
    reduction twice on the fused layer's route, K9 and K10 once on the fused
    loss's; with ``cfg.remat`` the forward's K11 and K9 again in the
    backward's recompute."""
    passes = 2 if cfg.visual_word_generation else 1
    kernels = (LAYER_KERNELS if routes.layer else ()) + (CE_KERNELS if routes.ce else ())
    again = ("train_fwd", "ce_fwd") if cfg.remat else ()
    return {k: passes * (2 if k == "train_wgrad" or k in again else 1) for k in kernels}


def captured_step_check(cfg, batches, seed, what):
    """The compiled step (jit=True: a CUDA graph) against the eager one
    from the same weights (``seed``), batches and CPU generator state, at
    ``cfg``'s dropout: each step's loss and every gradient bit for bit, a
    replay's launches the eager step's and ``step_launches``'s (on the
    default routes each decoder pass's K11, K12a, K12b, K9 and K10 once,
    the reduction twice), then every parameter and buffer. Returns the
    figures."""
    import torch

    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    sides, gens = {}, {}
    for jit in (False, True):
        m = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed),
                        train=True)
        st = create_train_state(cfg, m)
        sides[jit] = (m, make_train_step(cfg, m, st.optimizer, jit=jit))
        gens[jit] = torch.Generator().manual_seed(0)
    passes = 2 if cfg.visual_word_generation else 1
    want = step_launches(cfg, sides[True][1].routes)
    losses = []
    for i, batch in enumerate(batches):
        out = {}
        for jit, (m, step) in sides.items():
            _build.reset_launches()
            loss = float(step(batch, gens[jit])["total_loss"])
            torch.cuda.synchronize()
            out[jit] = (loss, {k: p.grad.clone() for k, p in m.named_parameters()},
                        {k: n for k, n in _build.LAUNCHES.items() if n})
        if out[True][0] != out[False][0]:
            die("%scaptured step %d: replayed loss %r, eager %r"
                % (what, i, out[True][0], out[False][0]))
        bad = [k for k, g in out[True][1].items() if not torch.equal(g, out[False][1][k])]
        if bad:
            die("%scaptured step %d: %d gradients differ from the eager step's (%s)"
                % (what, i, len(bad), bad[:3]))
        if out[True][2] != out[False][2] or out[True][2] != want:
            die("%scaptured step %d launched %s, the eager step %s, expected %s"
                % (what, i, out[True][2], out[False][2], want))
        losses.append(out[True][0])
    ref = sides[False][0].state_dict()
    bad = [k for k, t in sides[True][0].state_dict().items() if not torch.equal(t, ref[k])]
    if bad:
        die("%scaptured steps: %d parameters or buffers differ from the eager route's (%s)"
            % (what, len(bad), bad[:3]))
    jitted = sides[True][1].jitted
    if jitted is None or len(jitted.graphs) != 1:
        die("%scaptured steps: %s graphs, expected 1"
            % (what, None if jitted is None else len(jitted.graphs)))
    log("%scompiled step at B=%d, dropout %.2f: %d steps replayed bit for bit the eager ones "
        "(loss and %d gradients, then %d parameters and buffers); launches per step %s "
        "(%d decoder pass(es), each its own device seed); losses %s" % (
            what, batches[0]["tokens"].shape[0], cfg.hidden_dropout_prob, len(batches),
            len(out[True][1]), len(ref), want, passes, ["%.4f" % x for x in losses]))
    return dict(steps=len(batches), launches=want)


def methods_phase():
    """NAB's and ARB2's training at full width on random weights (seeds
    METHOD_SEEDS; their serving is in GRAPH_CASES): one bf16 step at p = 0
    of TRAIN_CPU videos against the CPU plain path (``cpu_step_check``),
    and the compiled step at B=TRAIN_B, 3 steps at dropout 0.5, replayed
    bit for bit the eager one (``captured_step_check``: ARB2's two passes
    each launch K11, K12a, K12b, K9 and K10 with a device seed of its own),
    on batches from the data pipeline. Returns {check: figures}."""
    import torch

    from navc_tpu_torch.config import default_config

    results = {}
    for method, seed in METHOD_SEEDS.items():
        c = default_config(method, **OVER)
        ccfg = c.replace(batch_size=TRAIN_CPU, hidden_dropout_prob=0.0, encoder_dropout=0.0)
        (small,) = loader_batches(ccfg, TRAIN_CPU, 1, seed=seed)
        results["%s p = 0 step" % method] = cpu_step_check(ccfg, small, seed + 10,
                                                           "%s: " % method)
        bcfg = c.replace(batch_size=TRAIN_B)
        results["%s compiled step" % method] = captured_step_check(
            bcfg, loader_batches(bcfg, TRAIN_B, 3, seed=seed), seed + 20, "%s: " % method)
        torch.cuda.empty_cache()
    return results


TRAIN_B, TRAIN_STEPS, TRAIN_BENCH, TRAIN_BENCH_ITERS, TRAIN_CPU = 64, 5, 2048, 5, 16
EPOCH_ROUNDS = 10  # rounds of the B=64 epoch in turns with the parent: its host clock varies
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


def bench_train_step(seed):
    """(step, batch, generator) of bench.py's NACF train protocol at B=2048
    (bench.py:365-436) on this process's navc_tpu_torch, weights from
    ``seed``: the same model, batch and dropout seed in either checkout."""
    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    cfg = default_config("NACF", batch_size=TRAIN_BENCH, **OVER)
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed),
                        train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    return step, train_batch(cfg, TRAIN_BENCH, np.random.RandomState(0)), \
        torch.Generator().manual_seed(0)


def nacf_epoch(seed):
    """A callable that runs TRAIN_STEPS NACF steps of TRAIN_B videos through
    run_train_epoch, the entry point's path, on this process's
    navc_tpu_torch (weights from ``seed``, the same batches in either
    checkout) and returns its info, read on the host at the end."""
    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.runtime.loop import run_train_epoch
    from navc_tpu_torch.runtime.optim import LrSchedule
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    cfg = default_config("NACF", batch_size=TRAIN_B, **OVER)
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed),
                        train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, state.optimizer)
    sched = LrSchedule.from_config(cfg)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(5)
    batches = [train_batch(cfg, TRAIN_B, rng) for _ in range(TRAIN_STEPS)]
    return lambda: run_train_epoch(cfg, step, state, batches, sched, gen)[1]


def ce_checks(cfg, model, g, record, parent):
    """K9 and K10 against their plain versions at the B=64 NACF pass (N = B
    x 30 rows), untied, tied and tied with a bias ten times the scores'
    scale; K9's ties inside one thread and across vocab splits and a label
    at V - 1; K10 bit for bit the same in two calls at N = 61440; each timed
    at N = 1920 and N = 61440 (B=2048), the backward per launch (with its
    second pass), beside the logits route on the same operands (torch.matmul
    + runtime.crit's loss) and, given ``parent``, the parent's wrappers in
    turns (parent, this, this, parent); at N = 61440 also against the plain
    versions (untied and tied: the dW launch's row split and its second
    pass, dh's scatter over the rows with dg != 0); the dW launch at N =
    1920 also with other row splits."""
    import torch

    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops import vocab_ce as VC
    from navc_tpu_torch.ops.vocab_fused import argmax_splits, split_ranges
    from navc_tpu_torch.runtime.crit import _label_logprob

    dev = torch.device("cuda")
    h, v = cfg.dim_hidden, cfg.vocab_size
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w_master = model.projection_weight().detach()        # (V, D) float32
    w16 = w_master.to(torch.bfloat16).contiguous()

    def operands(rows):
        hh = torch.randn(rows, h, generator=g).to(dev, torch.bfloat16)
        lab = torch.randint(0, v, (rows,), generator=g, dtype=torch.int32).to(dev)
        keep = (torch.rand(rows, generator=g) > 0.4).float()   # PAD / dropped rows
        return hh, lab, (torch.randn(rows, generator=g) * keep).to(dev)

    def agree(name, what, a, b, tol, rms_tol, case):
        err, sc, rms_err, rms = scaled_err(a, b)
        if not (err <= tol * sc and rms_err <= rms_tol * rms):
            die("%s %s (%s) disagrees: max err %.3e (scale %.3e), rms err %.3e (rms %.3e)"
                % (name, what, case, err, sc, rms_err, rms))
        return err, rms_err / rms

    def clear_rows(hh, ww, bias):
        top2 = (hh.float() @ ww.float().t() + (0 if bias is None else bias)).topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]) > 1e-3

    def check_all(hh, ww, bias, lab, dg, case, errs=None, worst_rms=None):
        """K9 and K10 against their plain versions on these operands."""
        g_k, pred_k, z_k = VC.vocab_ce_fwd(hh, ww, bias, lab)
        g_p, pred_p, z_p = VC.vocab_ce_fwd_plain(hh, ww, bias, lab)
        dh_k, dw_k, db_k = VC.vocab_ce_bwd(hh, ww, bias, lab, z_k, dg, dh_dtype=torch.bfloat16)
        dh_p, dw_p, db_p = VC.vocab_ce_bwd_plain(hh, ww, bias, lab, z_p, dg)
        torch.cuda.synchronize()
        if int(((pred_k != pred_p) & clear_rows(hh, ww, bias)).sum()):
            die("ce_fwd (%s) argmax differs from the plain version where the top-2 margin "
                "> 1e-3" % case)
        if not torch.all(dh_k[dg == 0] == 0):
            die("ce_bwd_dh (%s): a row with dg = 0 has a non-zero gradient" % case)
        checks = [("ce_fwd", "g", g_k, g_p, CE_TOL, CE_RMS_TOL),
                  ("ce_fwd", "z", z_k, z_p, CE_TOL, CE_RMS_TOL),
                  ("ce_bwd_dh", "dh", dh_k, dh_p, TRAIN_TOL, TRAIN_RMS_TOL),
                  ("ce_bwd_dw", "dW", dw_k, dw_p, TRAIN_TOL, TRAIN_RMS_TOL)]
        if bias is not None:
            checks.append(("ce_bwd_dw", "db", db_k, db_p, TRAIN_TOL, TRAIN_RMS_TOL))
        for name, what, a, b, tol, rms_tol in checks:
            err, ratio = agree(name, what, a, b, tol, rms_tol, case)
            if errs is not None:
                errs[name] = max(errs[name], err)
                worst_rms[name] = max(worst_rms[name], ratio)
        return pred_k

    n = TRAIN_B * cfg.max_len
    hh, lab, dg = operands(n)
    scale = float((hh[:256].float() @ w16.float().t()).std())
    cases = {"untied": None,
             "tied": (torch.randn(v, generator=g) * 0.1).to(dev),
             "large bias": (torch.randn(v, generator=g) * 10 * scale).to(dev)}
    errs = {k: 0.0 for k in CE_KERNELS}
    worst_rms = {k: 0.0 for k in CE_KERNELS}
    for case, bias in cases.items():
        check_all(hh, w16, bias, lab, dg, case, errs, worst_rms)
    log("vocab CE kernels agree with their plain versions at N=%d, D=%d, V=%d "
        "(untied, tied, large bias; ids equal where the top-2 margin > 1e-3; "
        "g, z within %.0e of the largest |value| and %.0e of the rms; dh, dW, "
        "db within %.0e and %.0e; worst rms ratios %s)" % (
            n, h, v, CE_TOL, CE_RMS_TOL, TRAIN_TOL, TRAIN_RMS_TOL,
            {k: "%.3g" % r for k, r in worst_rms.items()}))

    # ties and edges: columns 1, 9, 17, 121 of a 128-column tile fall to one
    # thread of K9's epilogue (129 to the next tile); equal maxima in two
    # vocab splits at 3072 rows; labels at V - 1, the last column of a
    # ragged last vocab tile in every launch's tiling (10048 = 78 x 128 + 64)
    ones = torch.ones(300, h, dtype=torch.bfloat16, device=dev)
    wt = torch.zeros(1001, h, dtype=torch.bfloat16, device=dev)
    wt[[121, 17, 129, 9, 1]] = 1.0
    pred = check_all(ones, wt, None, torch.full((300,), 9, dtype=torch.int32, device=dev),
                     torch.ones(300, device=dev), "ties inside one thread")
    if pred.tolist() != [1] * 300:
        die("ce_fwd: a tie inside one thread did not go to the lowest id")
    rt = 3072
    ranges = split_ranges(v, *argmax_splits(rt, v, sms))
    if len(ranges) < 3:
        die("ce_fwd: the tie case needs three vocab splits, got %d" % len(ranges))
    ties = [ranges[2][0] + 5, ranges[2][0] + 6, ranges[1][1] - 1]
    one = hh[:1].expand(rt, h).contiguous()
    wt = w16.clone()
    wt[ties] = (one[0].float() / one[0].float().norm() * 40).to(torch.bfloat16)
    tie_lab = torch.tensor(ties * (rt // 3), dtype=torch.int32, device=dev)
    pred = check_all(one, wt, None, tie_lab, torch.ones(rt, device=dev), "ties across splits")
    if pred.tolist() != [ties[2]] * rt:
        die("ce_fwd: a tie across vocab splits did not go to the lowest id")
    edge = torch.full((n,), v - 1, dtype=torch.int32, device=dev)
    edge[::3] = 0
    check_all(hh, w16, cases["tied"], edge, dg, "labels at V - 1")
    log("vocab CE ties and edges: ties inside one thread and across %d vocab splits go to "
        "the lowest id; labels at V - 1 and 0 agree with the plain versions" % len(ranges))

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

    def turns(timer, mine):
        """(this tree's mean, the parent's mean) of TIMERS[timer] in turns:
        parent, this, this, parent; the parent's case is loaded."""
        p1, k1, k2, p2 = (parent.time(timer), TIMERS[timer](mine), TIMERS[timer](mine),
                          parent.time(timer))
        return (k1 + k2) / 2, (p1 + p2) / 2

    times = {}
    lib = _build.load("vocab_ce", VC._BWD)
    for rows in (n, TRAIN_BENCH * cfg.max_len):
        hr, lr, dr = (hh, lab, dg) if rows == n else operands(rows)
        z = VC.vocab_ce_fwd(hr, w16, b_main, lr)[2]
        fwd = lambda: VC.vocab_ce_fwd(hr, w16, b_main, lr)  # noqa: E731
        bwd = lambda: VC.vocab_ce_bwd(hr, w16, b_main, lr, z, dr,  # noqa: E731
                                      dh_dtype=torch.bfloat16)
        t = dict(route_fwd=cuda_ms(lambda: logits_route(hr, lr, dr, False), iters=5),
                 route_both=cuda_ms(lambda: logits_route(hr, lr, dr, True), iters=5))
        if rows > n:  # the main path's B=2048 shape against the plain versions
            big_errs = {k: 0.0 for k in CE_KERNELS}
            big_rms = {k: 0.0 for k in CE_KERNELS}
            for case in ("untied", "tied"):
                check_all(hr, w16, cases[case], lr, dr, "%s, N=%d" % (case, rows), big_errs,
                          big_rms)
            torch.cuda.empty_cache()
            log("vocab CE kernels agree with their plain versions at N=%d (untied, tied; dW "
                "row splits %d, dh vocab splits %d; %d rows with dg != 0): worst max errors %s, "
                "worst rms ratios %s" % (
                    rows, VC.dw_plan(rows, v, h, sms), VC.dh_plan(rows, v, h, sms)[0],
                    int((dr != 0).sum()), {k: "%.3g" % x for k, x in big_errs.items()},
                    {k: "%.3g" % x for k, x in big_rms.items()}))
            # K10 bit for bit the same in two calls
            one_, two_ = bwd(), bwd()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(one_, two_) if a is not None):
                die("ce_bwd: two calls at N=%d gave different bits" % rows)
            del one_, two_
        if parent is None:
            t.update(fwd=device_ms(fwd), bwd=device_ms(bwd),
                     dh=launch_ms(bwd, "ce_bwd_dh"), dw=launch_ms(bwd, "ce_bwd_dw"))
        else:
            ops = dict(h=hr, w=w16, bias=b_main, labels=lr, z=z, dg=dr)
            got, mine = parent.load("vocab_ce_fwd", ops), fwd()
            for what, i, tol in (("g", 0, CE_TOL), ("z", 2, CE_TOL)):
                agree("ce_fwd", what, got[what], mine[i], tol, CE_RMS_TOL, "parent, N=%d" % rows)
            if int(((got["pred"] != mine[1]) & clear_rows(hr, w16, b_main)).sum()):
                die("the parent's ce_fwd argmax differs from this one at N=%d" % rows)
            t["fwd"], t["parent_fwd"] = turns("device", fwd)
            if rows == n:  # the wrapper's own cost on the host, which bounds the B=64 step
                t["host_fwd"], t["parent_host_fwd"] = turns("host_us", fwd)
            got, mine = parent.load("vocab_ce_bwd", ops), bwd()
            for what, i in (("dh", 0), ("dw", 1), ("db", 2)):
                if mine[i] is not None:
                    agree("ce_bwd", what, got[what], mine[i], TRAIN_TOL, TRAIN_RMS_TOL,
                          "parent, N=%d" % rows)
            del got, mine
            t["bwd"], t["parent_bwd"] = turns("device", bwd)
            if rows == n:
                t["host_bwd"], t["parent_host_bwd"] = turns("host_us", bwd)
                log("vocab CE wrappers' host cost at N=%d (us per call, the card held by a "
                    "sleep, in turns): K9 %.1f (parent %.1f), K10 %.1f (parent %.1f); this "
                    "tree's K9 by function (us of its own per call): %s; K10: %s" % (
                        rows, t["host_fwd"], t["parent_host_fwd"], t["host_bwd"],
                        t["parent_host_bwd"], host_breakdown(fwd), host_breakdown(bwd)))
            t["dh"], t["parent_dh"] = turns("ce_bwd_dh", bwd)
            t["dw"], t["parent_dw"] = turns("ce_bwd_dw", bwd)
        if rows == n:  # the dW launch's row split at N = 1920: the plan against others
            dw_, db_ = torch.empty_like(w_master), torch.empty(v, device=dev)
            hl, meta = VC.live_first(hr, lr, z, dr)
            ops = [VC._ptr(hl), VC._ptr(w16), VC._ptr(b_main), *VC._meta_ptrs(meta)[1:]]
            t["dw_splits"] = {}
            for splits in sorted({VC.dw_plan(rows, v, h, sms), 2, 3, 5}):
                part = torch.empty((splits, v, h), device=dev) if splits > 1 else None
                dbp = torch.empty((splits, v), device=dev) if splits > 1 else None
                ptrs = ops + [VC._ptr(x) for x in (dw_, db_, part, dbp)]
                t["dw_splits"][splits] = device_ms(lambda: _build.check(lib, lib.navc_ce_bwd_dw(
                    *ptrs, rows, h, v, splits, VC._stream(hr)), "ce_bwd_dw"))
                del part, dbp
        nd_v = rows * h * v
        live = int((dr != 0).sum())  # the rows K10 runs: the others add exactly nothing
        nd_v_live = live * h * v
        vt = -(-v // VC.CE_TILE)
        l2 = {"dh": -(-live // VC.CE_TILE) * vt * VC.CE_TILE * h * 2, "dw": vt * live * h * 2}
        t["plans"] = dict(dh=VC.dh_plan(rows, v, h, sms), dw=VC.dw_plan(rows, v, h, sms))
        # K10's bounds count the rows with dg != 0: the others need no work
        t["live"] = live
        t["bounds"] = dict(fwd=bound(2 * nd_v, 0), dh=bound(4 * nd_v_live, 0),
                           dw=bound(2 * nd_v_live, 0))
        t["bounds_all"] = dict(dh=bound(4 * nd_v, 0)[0], dw=bound(2 * nd_v, 0)[0])
        times[rows] = t
        par = lambda k: ("%.4f" % t["parent_" + k]) if "parent_" + k in t else "not run"  # noqa: E731
        log("vocab CE at N=%d (B=%d): K9 %.4f ms (parent %s; bound %.4f by %s); K10 %.4f ms "
            "(parent %s), %d of %d rows with dg != 0: dh %.4f (parent %s; plan %s; bound %.4f by %s for its 4NDV over the rows with dg != 0, %.4f over "
            "all rows, the port's own work the same), dW %.4f (parent %s; plan %s; bound %.4f "
            "by %s for its 2NDV over the rows with dg != 0, %.4f over all rows, the port's own "
            "4NDV with the score recompute %.4f); streamed through L2 over the rows with dg "
            "!= 0: dh %.2f GB (%.2f TB/s), dW %.2f GB (%.2f TB/s); logits route on the same "
            "operands: forward %.4f ms, forward + backward %.4f ms (K9 + K10 %.4f ms)%s" % (
                rows, rows // cfg.max_len, t["fwd"], par("fwd"), *t["bounds"]["fwd"], t["bwd"],
                par("bwd"), live, rows, t["dh"], par("dh"), t["plans"]["dh"],
                *t["bounds"]["dh"], t["bounds_all"]["dh"], t["dw"], par("dw"),
                t["plans"]["dw"], *t["bounds"]["dw"], t["bounds_all"]["dw"],
                bound(4 * nd_v_live, 0)[0], l2["dh"] / 1e9, l2["dh"] / t["dh"] / 1e9,
                l2["dw"] / 1e9, l2["dw"] / t["dw"] / 1e9, t["route_fwd"], t["route_both"],
                t["fwd"] + t["bwd"],
                "; dW at other row splits: %s" % {k: round(x, 4) for k, x in
                                                  t["dw_splits"].items()}
                if "dw_splits" in t else ""))
        del hr, lr, dr, z
    torch.cuda.empty_cache()

    t = times[n]
    plain_fwd = cuda_ms(lambda: VC.vocab_ce_fwd_plain(hh, w16, b_main, lab), iters=3)
    z = VC.vocab_ce_fwd(hh, w16, b_main, lab)[2]
    plain_bwd = cuda_ms(lambda: VC.vocab_ce_bwd_plain(hh, w16, b_main, lab, z, dg), iters=3)
    nd_v = n * h * v
    in_bytes = n * h * 2 + v * h * 2 + (0 if b_main is None else v * 4) + n * 4
    big_n = TRAIN_BENCH * cfg.max_len
    big = times[big_n]
    note = ("  (max_err: absolute, over the untied, tied and large-bias cases; "
            "N=%d (B=%d): %.4f ms; logits route on the same operands: B=64 "
            "forward %.4f, forward+backward %.4f ms, B=2048 %.4f, %.4f ms; "
            "library_ms null: no one PyTorch call)")

    def rec(name, key, plain_ms, flops, nbytes, extra=""):
        r = record(name, errs[name], None, t[key], plain_ms, flops, nbytes,
                   note=note % (big_n, TRAIN_BENCH, big[key], t["route_fwd"], t["route_both"],
                                big["route_fwd"], big["route_both"]) + extra)
        r["by_rows"] = {str(rows): {k: tt[k] for k in (key, "parent_" + key) if k in tt}
                        for rows, tt in times.items()}
        for rows, tt in times.items():
            r["by_rows"][str(rows)].update(zip(("bound_ms", "bound_by"),
                                               tt["bounds"][key]))
        if "parent_" + key in t:
            r["parent_ms"] = t["parent_" + key]
        return r

    return {
        "ce_fwd": rec("ce_fwd", "fwd", plain_fwd, 2 * nd_v, in_bytes + 3 * n * 4),
        "ce_bwd_dh": rec("ce_bwd_dh", "dh", plain_bwd, 4 * t["live"] * h * v,
                         in_bytes + 2 * n * 4 + n * h * 2,
                         " [K10's score recompute and dh = ds W over the %d of %d rows with "
                         "dg != 0, with its second pass; plain_ms: the whole plain backward]"
                         % (t["live"], n)),
        "ce_bwd_dw": rec("ce_bwd_dw", "dw", plain_bwd, 2 * t["live"] * h * v,
                         v * h * 4 + (0 if b_main is None else v * 4),
                         " [dW = ds^T h and db over the %d of %d rows with dg != 0, with its "
                         "second pass; its own score recompute is the port's cost, not in the "
                         "bound; plain_ms: the whole plain backward]" % (t["live"], n)),
    }


def bwd_checks(got, want):
    """{kernel: [(tensor, scaled_err stats)]} of K12a and K12b: ``got`` and
    ``want`` are (dr2, FFN Products, dx, denc, attention Products) of the
    kernels and of their plain versions."""
    dr2, fprods, dx, denc, aprods = got
    dr2_p, fprods_p, dx_p, denc_p, aprods_p = want
    return {
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
    }


def hold(checks, where, errs, rms_ratio):
    """Fail unless every check of ``checks`` (bwd_checks' form) is within
    TRAIN_TOL / TRAIN_RMS_TOL (the reduction's: WGRAD_TOL / WGRAD_RMS_TOL);
    keep each kernel's largest error in errs and worst rms ratio in
    rms_ratio."""
    for name, stats in checks.items():
        tol, rms_tol = ((WGRAD_TOL, WGRAD_RMS_TOL) if name == "train_wgrad"
                        else (TRAIN_TOL, TRAIN_RMS_TOL))
        for what, (err, scale, rms_err, rms) in stats:
            if not err <= tol * scale:
                die("%s (%s) %s disagrees with its plain version: max err %.3e > "
                    "%.1e x %.3e" % (name, where, what, err, tol, scale))
            if rms is not None and not rms_err <= rms_tol * rms:
                die("%s (%s) %s disagrees with its plain version: rms err %.3e > "
                    "%.1e x %.3e" % (name, where, what, rms_err, rms_tol, rms))
            errs[name] = max(errs.get(name, 0.0), err)
            if rms is not None and rms_err / rms > rms_ratio.get(name, (0.0, ""))[0]:
                rms_ratio[name] = (rms_err / rms, what)


def layer_matmuls(fprods, aprods, w):
    """The products K11, K12a and K12b compute, as bf16 torch.matmul calls on
    the same operand rows and weights (K11's are K12b's recompute of them):
    (K11's, K12a's, K12b's), each a callable."""
    import torch

    wi, wo2 = w["wi"], w["wo2"]
    xs, c1, r1, enc, c2 = aprods[0].Q, aprods[3].Q, aprods[4].Q, aprods[5].Q, aprods[7].Q
    dq1, dk1, dv1, do1, dq2, dk2, dv2, do2 = (pr.P for pr in aprods)
    m = {k: w[k] for k in ("wq_s", "wk_s", "wv_s", "wo_s", "wq_c", "wk_c", "wv_c", "wo_c")}
    fwd = ([(xs, m[k].t()) for k in ("wq_s", "wk_s", "wv_s")]
           + [(enc, m["wk_c"].t()), (enc, m["wv_c"].t()), (c1, m["wo_s"].t()),
              (r1, m["wq_c"].t()), (c2, m["wo_c"].t()), (fprods[0].Q, wi.t()),
              (fprods[1].Q, wo2.t())])
    ffn = [(fprods[0].Q, wi.t()), (fprods[1].P, wo2), (fprods[0].P, wi)]
    attn = ([(xs, m[k].t()) for k in ("wq_s", "wk_s", "wv_s")]
            + [(c1, m["wo_s"].t()), (r1, m["wq_c"].t()), (enc, m["wk_c"].t()),
               (enc, m["wv_c"].t()), (do2, m["wo_c"]), (dq2, m["wq_c"]), (dk2, m["wk_c"]),
               (dv2, m["wv_c"]), (do1, m["wo_s"]), (dq1, m["wq_s"]), (dk1, m["wk_s"]),
               (dv1, m["wv_s"])])
    return (lambda: [torch.matmul(a, b) for a, b in fwd],
            lambda: [torch.matmul(a, b) for a, b in ffn],
            lambda: [torch.matmul(a, b) for a, b in attn])


def train_phases(record, seeded, parent):
    """K11, K12a, K12b and the weight-gradient reduction against their plain
    versions at full width and timed at B=64 and B=2048 (the reduction beside
    torch.matmul and, given ``parent`` (a Worker), the parent's kernel),
    then NACF training through run_train_epoch. Returns ({kernel: record},
    {kernel: launches on the training main path})."""
    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.ops import fused_layer_train as FT
    from navc_tpu_torch.runtime.loop import run_train_epoch
    from navc_tpu_torch.runtime.optim import LrSchedule
    from navc_tpu_torch.runtime.train_step import (create_train_state,
                                                   make_train_step)

    dev = torch.device("cuda")
    over = OVER
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
    # the dropout seed as the kernels take it, a (1,) int32 on the card (the
    # plain versions read it; the parent's kernels take the int)
    seed_int = 1234567
    seed = torch.tensor([seed_int], dtype=torch.int32, device=dev)
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
        checks = bwd_checks((dr2, fprods, dx, denc, aprods),
                            (dr2_p, fprods_p, dx_p, denc_p, aprods_p))
        checks.update({  # kernel: [(tensor, stats)]
            "train_fwd": [("out", scaled_err(out, out_p)), ("r2", scaled_err(r2, r2_p))],
            "train_wgrad": [(k, scaled_err(grads[k], want[k])) for k in FT.WEIGHT_KEYS],
        })
        hold(checks, "causal" if causal else "nar", errs, rms_ratio)
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
    # reduction's, which must read its operands' real rows (PAD rows are
    # zero: they add nothing to a sum) and partials and write dW and db. The
    # weight-gradient products count in the reduction's operations, over
    # the same real rows.
    def costs(kp, prods):
        """{kernel: (FLOPs, bytes)} of this batch's data."""
        n, l = kp.shape
        rr = int((~kp).sum())
        pairs = int(sum(int(m) * (int(m) + 1) // 2 for m in (~kp).sum(1)))
        act, enc_b = n * l * h * 4, n * te * h * 4          # f32 (N, L, H), (N, Te, H)
        attn_w = 8 * h * h * 2 + 8 * h * 4
        ffn_w = 2 * h * inter * 2 + (inter + h) * 4
        attn_fwd = (2 * rr * h * h * 6 + 2 * 2 * n * te * h * h
                    + 2 * 2 * pairs * h + 2 * 2 * rr * te * h)
        real_rows = {"wk_c": n * te, "wv_c": n * te}
        return {
            "train_fwd": (attn_fwd + 2 * 2 * rr * h * inter,
                          act + enc_b + n * l + attn_w + ffn_w + 2 * (n * l * h * 2)),
            "train_ffn_bwd": (3 * 2 * rr * h * inter,   # r2, dy -> dr2
                              n * l * h * 2 + act + n * l + 2 * h * inter * 2 + inter * 4 + act),
            "train_attn_bwd": (attn_fwd + 2 * rr * h * h * 6 + 2 * 2 * n * te * h * h
                               + 4 * 2 * rr * te * h + 4 * 2 * pairs * h,
                               # x, dr2 -> dx, denc
                               2 * act + enc_b + n * l + attn_w + act + enc_b),
            "train_wgrad": (
                sum(2 * real_rows.get(pr.w, rr) * pr.P.shape[1] * pr.Q.shape[1] for pr in prods),
                sum(real_rows.get(pr.w, rr) * (pr.P.shape[1] + pr.Q.shape[1]) * 2
                    + pr.part.numel() * 4
                    + (pr.P.shape[1] * pr.Q.shape[1] + pr.P.shape[1]) * 4 for pr in prods)),
        }

    def wgrad_times(fprods, aprods, timer):
        """The reduction's two launches of one backward: checks that two calls
        give the same bits, then times them (TIMERS[timer]) beside
        torch.matmul of the same operands and, given --parent, the parent's
        kernel in turns (parent, this, this, parent)."""
        run = lambda: (FT.weight_grads(fprods), FT.weight_grads(aprods))  # noqa: E731
        (f1, a1), (f2, a2) = run(), run()
        torch.cuda.synchronize()
        if not all(torch.equal(x[k], y[k]) for x, y in ((f1, f2), (a1, a2)) for k in x):
            die("train_wgrad: two calls on the same operands gave different bits")
        prods = fprods + aprods
        t = dict(library_ms=TIMERS[timer](
            lambda: [torch.matmul(pr.P.t(), pr.Q) for pr in prods]))
        if parent is None:
            t["ms"] = TIMERS[timer](run)
            return t
        got = parent.load("weight_grads", dict(calls=[[pr._asdict() for pr in ps]
                                                      for ps in (fprods, aprods)]))
        for k, mine in {**f1, **a1}.items():
            err, scale, rms_err, rms = scaled_err(mine, got[k])
            if not (err <= WGRAD_TOL * scale and rms_err <= WGRAD_RMS_TOL * rms):
                die("train_wgrad %s disagrees with the parent's kernel" % k)
        del got
        p1, k1, k2, p2 = (parent.time(timer), TIMERS[timer](run), TIMERS[timer](run),
                          parent.time(timer))
        t.update(ms=(k1 + k2) / 2, parent_ms=(p1 + p2) / 2)
        return t

    cost = costs(kp, prods)
    note = ("  (max_err: absolute; tolerance %.0e of each tensor's largest |value| "
            "and %.0e of its rms for the error's rms")
    for name, run, plain in (
            ("train_fwd",
             lambda: FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw),
             lambda: FT.train_fwd_plain(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)),
            ("train_ffn_bwd", lambda: FT.ffn_bwd_operands(r2, dy, kp, w, seed, p=0.5),
             lambda: FT.ffn_bwd_operands_plain(r2, dy, kp, w, seed, p=0.5)),
            ("train_attn_bwd", lambda: FT.attn_bwd_operands(x, enc, dr2, kp, w, seed, **kw),
             lambda: FT.attn_bwd_operands_plain(x, enc, dr2, kp, w, seed, **kw))):
        recs[name] = record(name, errs[name], None, device_ms(run), cuda_ms(plain, iters=3),
                            *cost[name], note=note % (TRAIN_TOL, TRAIN_RMS_TOL)
                            + "; library_ms null: no one PyTorch call)")
    # K11 / K12a / K12b's products as bf16 torch.matmul on the same operands: how
    # far the row walk is from cuBLAS (not the library column: no one call
    # computes them)
    for name, mm in zip(LAYER_KERNELS, layer_matmuls(fprods, aprods, w)):
        recs[name]["matmul_ms"] = device_ms(mm)
    del mm
    if parent is not None:  # K11 beside the parent's through its own wrappers, in turns
        k11 = lambda: FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16,  # noqa: E731
                                   **kw)
        theirs = parent.load("train_fwd", dict(x=x, enc=enc, kp=kp, w=w), seed=seed_int,
                             kw=kw)
        for key, mine in zip(("out", "r2"), k11()):
            err, scale, rms_err, rms = scaled_err(mine, theirs[key])
            if not (err <= TRAIN_TOL * scale and rms_err <= TRAIN_RMS_TOL * rms):
                die("train_fwd %s at B=%d disagrees with the parent's kernel" % (key, TRAIN_B))
        del theirs
        p1, k1, k2, p2 = (parent.time("device"), device_ms(k11), device_ms(k11),
                          parent.time("device"))
        recs["train_fwd"].update(ms=(k1 + k2) / 2, parent_ms=(p1 + p2) / 2)
        log("K11 at B=%d in turns with the parent: %.4f ms, parent %.4f ms" % (
            TRAIN_B, recs["train_fwd"]["ms"], recs["train_fwd"]["parent_ms"]))
        del k11
    # the wrappers' host cost, which the host-bound B=64 step pays: us per call
    # queued while a device-side sleep holds the card, in turns with the
    # parent's and with this tree's in a worker as fresh as the parent's
    # (this process's host clock is slower than a fresh one's: PERF.md)
    fresh = Worker(ROOT) if parent is not None else None
    for name, kind, ops, run in (
            ("train_fwd", "train_fwd", dict(x=x, enc=enc, kp=kp, w=w),
             lambda: FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16, **kw)),
            ("train_ffn_bwd", "ffn_bwd", dict(r2=r2, dy=dy, kp=kp, w=w),
             lambda: FT.ffn_bwd_operands(r2, dy, kp, w, seed, p=0.5)),
            ("train_attn_bwd", "attn_bwd", dict(x=x, enc=enc, dr2=dr2, kp=kp, w=w),
             lambda: FT.attn_bwd_operands(x, enc, dr2, kp, w, seed, **kw))):
        if parent is None:
            recs[name]["host_us"] = host_us(run)
            continue
        for side in (parent, fresh):
            side.load(kind, ops, seed=seed_int, kw=kw)
        p1, f1, k1, k2, f2, p2 = (parent.time("host_us"), fresh.time("host_us"), host_us(run),
                                  host_us(run), fresh.time("host_us"), parent.time("host_us"))
        recs[name].update(host_us=(k1 + k2) / 2, fresh_host_us=(f1 + f2) / 2,
                          parent_host_us=(p1 + p2) / 2)
    log("K11 / K12a / K12b wrappers' host cost at B=%d (us per call, the card held by a "
        "sleep%s): %s; this tree's K11 and K12b by function (us of its own per call): %s, %s"
        % (TRAIN_B, ", in turns with the parent and a fresh process of this tree" if parent
           else "", {k: {f: round(recs[k][f], 1) for f in (
               "host_us", "fresh_host_us", "parent_host_us") if f in recs[k]}
            for k in LAYER_KERNELS[:3]},
           host_breakdown(lambda: FT.train_fwd(x, enc, kp, w, seed, out_dtype=torch.bfloat16,
                                               **kw), top=6),
           host_breakdown(run, top=6)))
    del run
    log("K11 / K12a / K12b at B=%d: matmul_ms %.4f / %.4f / %.4f (bf16 torch.matmul of "
        "their products on the same operands)" % (TRAIN_B, *(recs[k]["matmul_ms"] for k in (
            "train_fwd", "train_ffn_bwd", "train_attn_bwd"))))
    tw = wgrad_times(fprods, aprods, "device")
    recs["train_wgrad"] = record(
        "train_wgrad", errs["train_wgrad"], None, tw["ms"],
        cuda_ms(lambda: FT.weight_grads_plain(prods), iters=3), *cost["train_wgrad"],
        lib_ms=tw["library_ms"],
        note=note % (WGRAD_TOL, WGRAD_RMS_TOL) + "; the two launches of one backward, bit "
        "for bit the same in two calls; library: torch.matmul of the same bf16 operands; "
        "parent %s)" % ("%.4f ms" % tw["parent_ms"] if "parent_ms" in tw else "not run"))
    if "parent_ms" in tw:
        recs["train_wgrad"]["parent_ms"] = tw["parent_ms"]
    del out, r2, dr2, dx, denc, prods, fprods, aprods, grads, want
    del out_p, r2_p, dr2_p, dx_p, denc_p, fprods_p, aprods_p

    # -- (a2) the four kernels at B=2048 on the NACF pass's shape (L 30) -----
    n2 = TRAIN_BENCH
    l2 = cfg.max_len
    lengths = torch.randint(5, l2 + 1, (n2,), generator=g)
    kp2 = (torch.arange(l2)[None] >= lengths[:, None]).to(dev)
    x2 = torch.randn(n2, l2, h, generator=g).to(dev)
    enc2 = torch.randn(n2, te, h, generator=g).to(dev)
    dy2 = torch.randn(n2, l2, h, generator=g).to(dev)
    kw2 = dict(n_head=nh, causal=False, p=0.5, p_input=0.5)
    fwd2 = lambda: FT.train_fwd(x2, enc2, kp2, w, seed,  # noqa: E731
                                out_dtype=torch.bfloat16, **kw2)
    out2, r2b = fwd2()
    # K11 against its plain version at B=2048, and bit for bit in two calls
    errs2, ratio2 = {}, {}
    hold({"train_fwd": [(k, scaled_err(a, b)) for k, a, b in zip(
        ("out", "r2"), (out2, r2b), FT.train_fwd_plain(x2, enc2, kp2, w, seed,
                                                       out_dtype=torch.bfloat16, **kw2))]},
         "B=%d" % n2, errs2, ratio2)
    if not all(torch.equal(a, b) for a, b in zip((out2, r2b), fwd2())):
        die("K11 at B=%d: two calls on the same inputs gave different bits" % n2)
    ffn2 = lambda: FT.ffn_bwd_operands(r2b, dy2, kp2, w, seed, p=0.5)  # noqa: E731
    dr2b, fprods2 = ffn2()
    attn2 = lambda: FT.attn_bwd_operands(x2, enc2, dr2b, kp2, w, seed, **kw2)  # noqa: E731
    dx2, denc2, aprods2 = attn2()
    # K12a and K12b against their plain versions, and bit for bit in two calls
    hold(bwd_checks((dr2b, fprods2, dx2, denc2, aprods2),
                    (*FT.ffn_bwd_operands_plain(r2b, dy2, kp2, w, seed, p=0.5),
                     *FT.attn_bwd_operands_plain(x2, enc2, dr2b, kp2, w, seed, **kw2))),
         "B=%d" % n2, errs2, ratio2)

    def outputs(dr2, fp, dx, denc, ap):
        return [dr2, dx, denc] + [t for pr in fp + ap for t in (pr.P, pr.Q, pr.part)]

    again = outputs(*ffn2(), *attn2())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            outputs(dr2b, fprods2, dx2, denc2, aprods2), again)):
        die("K12a/K12b at B=%d: two calls on the same inputs gave different bits" % n2)
    del again
    prods2 = fprods2 + aprods2
    got2 = FT.weight_grads(fprods2)
    got2.update(FT.weight_grads(aprods2))
    want2 = FT.weight_grads_plain(prods2)
    torch.cuda.synchronize()
    for k in FT.WEIGHT_KEYS:
        err, scale, rms_err, rms = scaled_err(got2[k], want2[k])
        if not (err <= WGRAD_TOL * scale and rms_err <= WGRAD_RMS_TOL * rms):
            die("train_wgrad %s at B=%d disagrees with its plain version: max err %.3e "
                "(scale %.3e), rms err %.3e (rms %.3e)" % (k, n2, err, scale, rms_err, rms))
    del got2, want2
    cost2 = costs(kp2, prods2)
    t2 = {}
    # K11 / K12a / K12b: beside bf16 torch.matmul of the products they compute,
    # on the same operands (no one PyTorch call computes any), and given
    # --parent, the parent's kernels through its own wrappers, in turns
    mm_fwd, mm_ffn, mm_attn = layer_matmuls(fprods2, aprods2, w)
    for name, run, mm, kind, ops, mine in (
            ("train_fwd", fwd2, mm_fwd, "train_fwd",
             dict(x=x2, enc=enc2, kp=kp2, w=w), out2),
            ("train_ffn_bwd", ffn2, mm_ffn, "ffn_bwd",
             dict(r2=r2b, dy=dy2, kp=kp2, w=w), dr2b),
            ("train_attn_bwd", attn2, mm_attn, "attn_bwd",
             dict(x=x2, enc=enc2, dr2=dr2b, kp=kp2, w=w), dx2)):
        t = dict(matmul_ms=TIMERS["cuda5"](mm))
        if parent is None:
            t["ms"] = TIMERS["cuda5"](run)
        else:
            theirs = parent.load(kind, ops, seed=seed_int, kw=kw2)["out"]
            err, scale, rms_err, rms = scaled_err(mine, theirs)
            if not (err <= TRAIN_TOL * scale and rms_err <= TRAIN_RMS_TOL * rms):
                die("%s at B=%d disagrees with the parent's kernel" % (name, n2))
            del theirs
            p1, k1, k2, p2 = (parent.time("cuda5"), TIMERS["cuda5"](run),
                              TIMERS["cuda5"](run), parent.time("cuda5"))
            t.update(ms=(k1 + k2) / 2, parent_ms=(p1 + p2) / 2)
        t2[name] = t
    del mm_fwd, mm_ffn, mm_attn, run, mm, ops, mine  # they hold the operands
    t2["train_wgrad"] = wgrad_times(fprods2, aprods2, "cuda5")
    for name, t in t2.items():
        t["bound_ms"], t["bound_by"] = bound(*cost2[name])
        recs[name]["by_batch"] = {str(n2): t}

    def parent_of(name):
        return "%.4f ms" % t2[name]["parent_ms"] if "parent_ms" in t2[name] else "not run"

    log("training kernels at B=%d (L %d NAR, %d real rows, p = 0.5): K11 %.4f ms, K12a %.4f "
        "ms, K12b %.4f ms (bounds %.4f / %.4f / %.4f, by %s; matmul_ms, bf16 torch.matmul of "
        "their products on the same operands, %.4f / %.4f / %.4f; parent %s / %s / %s); "
        "K11, K12a and K12b agree with their plain versions (%.0e / %.0e; worst rms ratios %s) "
        "and repeat bit for bit; reduction %.4f ms for both launches of one backward (bound "
        "%.4f by %s, torch.matmul %.4f, parent %s); the reduction agrees with its plain "
        "version (%.0e / %.0e) and repeats bit for bit" % (
            n2, l2, int((~kp2).sum()), t2["train_fwd"]["ms"], t2["train_ffn_bwd"]["ms"],
            t2["train_attn_bwd"]["ms"], t2["train_fwd"]["bound_ms"],
            t2["train_ffn_bwd"]["bound_ms"], t2["train_attn_bwd"]["bound_ms"],
            " / ".join(t2[k]["bound_by"] for k in ("train_fwd", "train_ffn_bwd",
                                                  "train_attn_bwd")),
            t2["train_fwd"]["matmul_ms"], t2["train_ffn_bwd"]["matmul_ms"],
            t2["train_attn_bwd"]["matmul_ms"], parent_of("train_fwd"),
            parent_of("train_ffn_bwd"), parent_of("train_attn_bwd"), TRAIN_TOL,
            TRAIN_RMS_TOL, {k: "%.3g (%s)" % v for k, v in ratio2.items()},
            t2["train_wgrad"]["ms"], t2["train_wgrad"]["bound_ms"],
            t2["train_wgrad"]["bound_by"], t2["train_wgrad"]["library_ms"],
            parent_of("train_wgrad"), WGRAD_TOL, WGRAD_RMS_TOL))
    del x2, enc2, dy2, out2, r2b, dr2b, dx2, denc2, fprods2, aprods2, prods2
    torch.cuda.empty_cache()

    recs.update(ce_checks(cfg, model, g, record, parent))

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
    if parent is not None:  # the same epoch on the parent's checkout, in turns
        for side in (parent, fresh):
            side.load("train_epoch", {}, seed=0)
        epoch = nacf_epoch(0)
        epoch()  # first use
        for side in (parent, fresh):  # warm every side
            side.time("epoch_step")
        TIMERS["epoch_step"](epoch)
        sides = {"this": [], "this, fresh process": [], "parent": []}
        for _ in range(EPOCH_ROUNDS):
            p1, f1, k1, k2, f2, p2 = (
                parent.time("epoch_step"), fresh.time("epoch_step"),
                TIMERS["epoch_step"](epoch), TIMERS["epoch_step"](epoch),
                fresh.time("epoch_step"), parent.time("epoch_step"))
            sides["this"] += [k1, k2]
            sides["this, fresh process"] += [f1, f2]
            sides["parent"] += [p1, p2]
        wins = {who: sum(k < p for k, p in zip(sides[who], sides["parent"]))
                for who in ("this", "this, fresh process")}
        log("B=%d NACF steps through run_train_epoch in turns with the parent (parent, fresh, "
            "this, this, fresh, parent; %d rounds of 3 epochs of %d steps; ms per step, host "
            "clock): %s; faster than the parent in %s of %d pairs; idle share of one epoch this "
            "%.3f, parent %.3f; top-level host operators per epoch this %d, parent %d"
            % (TRAIN_B, EPOCH_ROUNDS, TRAIN_STEPS, "; ".join(
                "%s %s (median %.3f, mean %.3f)" % (who, [round(x, 3) for x in t],
                                                   np.median(t), np.mean(t))
                for who, t in sides.items()), wins, len(sides["this"]), idle_share(epoch),
               parent.time("idle"), TIMERS["host_ops"](epoch), parent.time("host_ops")))
        del epoch
    if fresh is not None:
        fresh.close()

    # -- (c) bench.py's train protocol at B=2048 ----------------------------
    del state, step, model
    torch.cuda.empty_cache()
    bstep, big, bgen = bench_train_step(0)
    run = lambda: float(bstep(big, bgen)["total_loss"])  # noqa: E731  (host sync each step)
    torch.cuda.reset_peak_memory_stats()
    run()
    t0 = time.perf_counter()
    for _ in range(TRAIN_BENCH_ITERS):
        loss = run()
    dt_sync = (time.perf_counter() - t0) / TRAIN_BENCH_ITERS
    t0 = time.perf_counter()
    ms = [bstep(big, bgen) for _ in range(TRAIN_BENCH_ITERS)]
    loss = float(ms[-1]["total_loss"])
    dt_pipe = (time.perf_counter() - t0) / TRAIN_BENCH_ITERS
    log("NACF train step at B=%d (bench.py protocol, %d steps each): synchronised "
        "%.2f ms, %.1f captions/s; pipelined %.2f ms, %.1f captions/s; loss %.3f; "
        "peak memory %.2f GB" % (
            TRAIN_BENCH, TRAIN_BENCH_ITERS, dt_sync * 1e3, TRAIN_BENCH / dt_sync,
            dt_pipe * 1e3, TRAIN_BENCH / dt_pipe, loss,
            torch.cuda.max_memory_allocated() / 1e9))
    del ms
    if not np.isfinite(loss):
        die("B=%d training loss is not finite" % TRAIN_BENCH)
    log("rows with a non-PAD label, the rows K10 runs, in the B=%d batch's two passes "
        "(labels_1, labels): %.3f, %.3f" % (TRAIN_BENCH, *(
            float((big[k] != C.PAD).mean()) for k in ("labels_1", "labels"))))
    prof = device_breakdown(lambda: bstep(big, bgen))
    print_profile(prof, "training step at B=%d" % TRAIN_BENCH)
    if prof is not None:
        ce_ms = sum(x[0] for k, x in prof[2].items()
                    if "argmax_kernel<3" in k or "argmax_merge_kernel<3" in k or "ce_bwd_" in k)
        log("K9 + K10 in the profiled B=%d step: %.3f ms of %.3f ms device busy (share %.3f)"
            % (TRAIN_BENCH, ce_ms, prof[1], ce_ms / prof[1]))
    if parent is not None:  # the same protocol on the parent's checkout, in turns
        parent.load("train_step", {}, seed=0)
        sides = {"this": [], "parent": []}
        for _ in range(3):
            p1, k1, k2, p2 = (parent.time("train_sync"), host_ms(run, TRAIN_BENCH_ITERS),
                              host_ms(run, TRAIN_BENCH_ITERS), parent.time("train_sync"))
            sides["this"] += [k1, k2]
            sides["parent"] += [p1, p2]
        p_idle, p_peak = parent.time("idle"), parent.time("peak_gb")
        log("B=%d step in turns with the parent (parent, this, this, parent; 3 rounds of %d "
            "synchronised steps each): this %s ms (mean %.2f), parent %s ms (mean %.2f); idle "
            "share this %.3f, parent %.3f; memory one step allocates above what its process "
            "holds: this %.2f GB, parent %.2f GB"
            % (TRAIN_BENCH, TRAIN_BENCH_ITERS, [round(x, 2) for x in sides["this"]],
               np.mean(sides["this"]), [round(x, 2) for x in sides["parent"]],
               np.mean(sides["parent"]), idle_share(run), p_idle, peak_gb(run), p_peak))
    del bstep, big
    torch.cuda.empty_cache()

    # -- (d) one bf16 step at p = 0 on the card against the CPU plain path --
    ccfg = default_config("NACF", batch_size=TRAIN_CPU, hidden_dropout_prob=0.0,
                          encoder_dropout=0.0, **over)
    cpu_step_check(ccfg, train_batch(ccfg, TRAIN_CPU, np.random.RandomState(9)), 3, "")

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


TRAIN_GRAPH_ROUNDS = 5  # rounds of (eager, replayed, replayed, eager) epochs: 10 each


def train_graphs_phase(card):
    """The compiled training step (make_train_step(..., jit=True), navc_tpu's
    jitted step: a CUDA graph per batch signature) against the eager one
    (jit=False) at full width, NACF with its dropout on (0.5), at B=64
    (nacf_epoch's batches) and B=2048 (bench_train_step's batch). Two models
    from one seed, the same batches and CPU generator state: each step's
    loss and every gradient bit for bit the same on both routes (B=64: 5
    steps under a warm-up lr schedule, then every parameter and buffer;
    B=2048: 2 steps); at lr 0 on one batch two replays give different
    losses, each the eager step's with the same draws. Then ms per step on
    both routes (median of 2 x TRAIN_GRAPH_ROUNDS epochs of 5 steps through
    run_train_epoch, in turns, host clock, the epoch's metrics read at its
    end), the first call's seconds (a real step, then the capture), the
    capture's seconds, the pool's MiB, peak GB (the first call; one step
    on each route), the launches of one replayed step and the idle share
    of one profiled step and of one profiled epoch on each route. Returns
    {case: figures}."""
    import gc

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.loop import run_train_epoch
    from navc_tpu_torch.runtime.optim import LrSchedule, set_learning_rate
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    def trainer(b, jit):
        cfg = default_config("NACF", batch_size=b, **OVER)
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                            train=True)
        state = create_train_state(cfg, model)
        return cfg, model, state, make_train_step(cfg, model, state.optimizer, jit=jit)

    def same_step(sides, batch, gens, what):
        """One step on each route; dies unless the loss and every gradient
        agree bit for bit. Returns the jit route's (loss, seconds)."""
        out = {}
        for jit, (_, model, _, step) in sides.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(batch, gens[jit])["total_loss"])
            out[jit] = (loss, time.perf_counter() - t0,
                        {k: p.grad.clone() for k, p in model.named_parameters()})
        if out[True][0] != out[False][0]:
            die("train graphs: %s: replayed loss %r, eager %r" % (what, out[True][0],
                                                                out[False][0]))
        bad = [k for k, g in out[True][2].items() if not torch.equal(g, out[False][2][k])]
        if bad:
            die("train graphs: %s: %d gradients differ from the eager step's (%s)"
                % (what, len(bad), bad[:3]))
        return out[True][0], out[True][1], len(out[True][2])

    results = {}
    for b in (TRAIN_B, TRAIN_BENCH):
        name = "NACF step B=%d" % b
        sides = {jit: trainer(b, jit) for jit in (False, True)}
        cfg = sides[True][0]
        if b == TRAIN_B:
            rng = np.random.RandomState(5)  # nacf_epoch's batches
            batches = [train_batch(cfg, b, rng) for _ in range(TRAIN_STEPS)]
        else:
            batches = [train_batch(cfg, b, np.random.RandomState(0))] * TRAIN_BENCH_ITERS
        # -- replayed against eager: the first call (a real step, then the
        #    capture), then replays under a warm-up lr schedule
        gens = {jit: torch.Generator().manual_seed(0) for jit in sides}
        scheds = {jit: LrSchedule(cfg.learning_rate, cfg.minimum_learning_rate, cfg.decay,
                                  n_warmup_steps=3) for jit in sides}
        n_checked = TRAIN_STEPS if b == TRAIN_B else 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for i in range(n_checked):
            for jit, (_, _, state, _) in sides.items():
                set_learning_rate(state.optimizer, scheds[jit].step_lr())
            loss, sec, n_grads = same_step(sides, batches[i], gens, "%s, step %d" % (name, i))
            if i == 0:
                first_s = sec
                first_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        params_same = None
        if b == TRAIN_B:
            want = sides[False][1].state_dict()
            bad = [k for k, t in sides[True][1].state_dict().items() if not torch.equal(t, want[k])]
            if bad:
                die("train graphs: %s: after %d steps %d parameters or buffers differ from "
                    "the eager route's (%s)" % (name, n_checked, len(bad), bad[:3]))
            params_same = len(want)
            # -- lr 0, one batch: fresh masks per replay, each the eager step's
            for _, _, state, _ in sides.values():
                set_learning_rate(state.optimizer, 0.0)
            g = torch.Generator().manual_seed(11)
            lr0 = []
            for _ in range(2):
                draws = g.get_state()
                got = float(sides[True][3](batches[0], g)["total_loss"])
                eager = float(sides[False][3](batches[0], torch.Generator().set_state(draws))[
                    "total_loss"])
                if got != eager:
                    die("train graphs: at lr 0 a replay's loss %r is not the eager step's %r "
                        "with the same draws" % (got, eager))
                lr0.append(got)
            if lr0[0] == lr0[1]:
                die("train graphs: two replays at lr 0 gave the same loss %r: the masks "
                    "did not change" % lr0[0])
        jitted = sides[True][3].jitted
        if jitted is None or len(jitted.graphs) != 1:
            die("train graphs: %s: %s graphs captured, expected 1" % (
                name, None if jitted is None else len(jitted.graphs)))
        graph = next(iter(jitted.graphs.values())).graph
        # -- launches of one replayed step
        _build.reset_launches()
        sides[True][3](batches[0], gens[True])
        torch.cuda.synchronize()
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        want_launches = {"train_fwd": 2, "train_ffn_bwd": 2, "train_attn_bwd": 2,
                         "train_wgrad": 4, "ce_fwd": 2, "ce_bwd_dh": 2, "ce_bwd_dw": 2}
        if launches != want_launches:
            die("train graphs: %s: a replayed step launched %s, expected %s"
                % (name, launches, want_launches))
        # -- ms per step, in turns
        epoch = {jit: (lambda s=s, g=gens[jit]: run_train_epoch(
            s[0], s[3], s[2], batches, LrSchedule.from_config(s[0]), g))
                 for jit, s in sides.items()}
        ms = {False: [], True: []}
        for _ in range(TRAIN_GRAPH_ROUNDS):
            for jit in (False, True, True, False):
                ms[jit].append(host_ms(epoch[jit], iters=1) / len(batches))
        one = {jit: (lambda s=s, jit=jit: float(s[3](batches[0], gens[jit])["total_loss"]))
               for jit, s in sides.items()}
        peak = {jit: peak_gb(one[jit]) for jit in sides}
        idle, epoch_idle = {}, {}
        for jit in (False, True):
            prof = device_breakdown(one[jit])
            idle[jit] = None if prof is None else 1.0 - prof[1] / prof[0]
            print_profile(prof, "%s, %s" % (name, "replayed" if jit else "eager"))
            prof = device_breakdown(epoch[jit])
            epoch_idle[jit] = None if prof is None else 1.0 - prof[1] / prof[0]
        r = results[name] = dict(
            eager_ms=float(np.median(ms[False])), replay_ms=float(np.median(ms[True])),
            eager_ms_all=[round(x, 3) for x in ms[False]],
            replay_ms_all=[round(x, 3) for x in ms[True]],
            first_call_s=first_s, capture_s=graph.capture_s,
            pool_mb=graph.pool_bytes / 2 ** 20, first_call_peak_gb=first_peak,
            eager_peak_gb=peak[False], replay_peak_gb=peak[True], launches=launches,
            eager_idle=idle[False], replay_idle=idle[True],
            eager_epoch_idle=epoch_idle[False], replay_epoch_idle=epoch_idle[True],
            checked_steps=n_checked,
            lr0_losses=lr0 if b == TRAIN_B else None)
        log("train graphs: %s [%s]: eager %.3f ms, replayed %.3f ms per step (median of %d "
            "epochs of %d steps through run_train_epoch each, in turns, host clock, the "
            "epoch's metrics read at its end; %.2fx); replayed steps bit for bit the eager "
            "ones (loss and %d gradients, %d steps under a warm-up lr%s)%s; first call %.3f s "
            "(a real step, then the capture: %.3f s), pool %.1f MiB; peak GB above what the "
            "process held: first call %.2f, eager step %.2f, replayed step %.2f; launches "
            "per replayed step %s; idle share of one profiled step eager %s, replayed %s; of "
            "one profiled epoch eager %s, replayed %s" % (
                name, card, r["eager_ms"], r["replay_ms"], 2 * TRAIN_GRAPH_ROUNDS, len(batches),
                r["eager_ms"] / r["replay_ms"], n_grads, n_checked,
                "; then %d parameters and buffers" % params_same if params_same else "",
                "; lr 0, one batch: two replays' losses %r, %r, each the eager step's with "
                "the same draws" % tuple(lr0) if b == TRAIN_B else "",
                first_s, graph.capture_s, r["pool_mb"], first_peak, peak[False], peak[True],
                launches, *("%.3f" % x if x is not None else "not measured"
                            for x in (idle[False], idle[True], epoch_idle[False],
                                      epoch_idle[True]))))
        del sides, epoch, one, jitted, graph
        gc.collect()  # a step's graphs sit in a reference cycle (its optimizer's hook)
        torch.cuda.empty_cache()
    return results


ENTRY_VIDEOS, ENTRY_CAPS, ENTRY_FRAMES = 320, 5, 16


def entry_point_phase():
    """train_network_all at full width: make_synthetic_corpus with the
    MSRVTT vocab (10048) and in-memory 2048-d features, modality mi, 320
    videos (192 / 64 / 64), 5 captions each, batch 64. ARB for 1 epoch, then
    NACF for 2 with that best.ckpt as teacher. Validation decodes go through
    K1-K4 (NACF, with the ARB teacher's rescoring) and K5-K7 (ARB), every
    step through K9-K12 on the compiled step (each run's first step a real
    step and the capture, the others replays of its CUDA graph)."""
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


INFER_RUNS = (  # (name, translate options after the checkpoints, kernels it must launch)
    ("mp", ["-use_ct", "--record"],
     ("fused_layer", "fused_layer_qsub", "project_argmax", "project_gather_prob")),
    ("l2r", ["-paradigm", "l2r", "-use_ct", "-q", "1", "-qi", "1"],
     ("fused_layer", "project_argmax", "project_gather_prob")),
    ("ef", ["-paradigm", "ef", "-q", "1"],
     ("fused_layer", "project_argmax", "project_gather_prob")),
    ("mp collect", ["-use_ct", "-collect"],
     ("fused_layer", "project_argmax", "project_gather_prob")),
    ("ARB", ["-bs", "5"], ("project_topk", "beam_attend_step", "cross_attend")),
    ("NAB", [], ("fused_layer", "fused_layer_qsub", "project_argmax", "project_gather_prob")),
    ("ARB2", ["-bs", "5"], ("project_topk", "beam_attend_step", "cross_attend")),
)


def inference_phase(card):
    """The inference entry points at full width (MSRVTT, d=512, vocab
    10048, bf16, random weights from seeds 0-3): an NACF, an ARB, a NAB
    and an ARB2 model saved as .ckpt files, the 64-video test split of the
    entry point's synthetic corpus captioned and scored through
    cli.translate's body (`translate`, in-memory features, batch 64, on the
    card) as mp + CT with the ARB teacher (--record), l2r + CT (q 1, one
    refinement), ef (q 1), mp + CT with -collect, ARB (beam 5), NAB's mp
    with the ARB teacher and ARB2 (beam 5), each with its launch counts;
    CaptionPipeline.from_checkpoints on the NACF and ARB checkpoints against
    Evaluator.decode_batch; l2r and ef on 8 videos against the CPU plain
    path; 64-video decode times and launches per decode. Returns each
    run's printed captions {run: {video: caption}} and the references."""
    import contextlib
    import csv
    import io
    import pickle
    import tempfile

    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.api import CaptionPipeline
    from navc_tpu_torch.cli.translate import build_parser, translate
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.loader import get_loader
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.checkpoint import load_model_and_config, save_checkpoint
    from navc_tpu_torch.runtime.evaluate import Evaluator

    over = dict(OVER, batch_size=N_VIDEOS)
    cfgs = {m: default_config(m, **over) for m in ("NACF", "ARB", "NAB", "ARB2")}
    corpus, refs = make_synthetic_corpus(cfgs["ARB"], n_videos=ENTRY_VIDEOS,
                                         n_caps=ENTRY_CAPS, vocab_size=OVER["vocab_size"])
    feats = make_synthetic_feats(cfgs["ARB"], n_videos=ENTRY_VIDEOS,
                                 n_total_frames=ENTRY_FRAMES)
    n_test = len(corpus["info"]["split"]["test"])
    with tempfile.TemporaryDirectory() as root:
        corpus_path = os.path.join(root, "info_corpus.pkl")
        with open(corpus_path, "wb") as f:
            pickle.dump(corpus, f)
        paths = {}
        for seed, (name, cfg) in enumerate(cfgs.items()):
            model = build_model(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(seed))
            cfg = cfg.replace(info_corpus=corpus_path,
                              checkpoint_path=os.path.join(root, name))
            paths[name] = save_checkpoint({"model": model, "settings": cfg}, root,
                                          name + ".ckpt")
            del model

        # -- translate runs, each from fresh counts ---------------------------
        seconds, launches, captions, results = {}, {}, {}, {}
        peak = 0.0
        for name, extra, kernels in INFER_RUNS:
            method = name if name in cfgs else "NACF"  # the paradigm runs are NACF's
            model_args = ["--model_path", paths[method]] + (
                ["--teacher_path", paths["ARB"]] if method in ("NACF", "NAB") else [])
            opt = build_parser().parse_args(
                model_args + extra + ["-batch_size", str(N_VIDEOS), "-em", "test",
                                      "-print_sent", "-collect_path",
                                      os.path.join(root, "collect")])
            out = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            built = []  # the decodes translate's evaluator builds

            def recording(self, refresh=Evaluator.refresh):
                refresh(self)
                built.append(self.generate)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), swapped(Evaluator, "refresh", recording):
                res = translate(opt, device="cuda", info_corpus=corpus,
                                in_memory_feats=feats, references=refs)["test"]
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            if not built or not all(g.graphed and g.graphs for g in built):
                die("inference: translate %s decoded without replaying a graph" % name)
            launches[name] = {k: c for k, c in _build.LAUNCHES.items() if c}
            peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
            results[name] = res
            for k in kernels:
                if not launches[name].get(k):
                    die("inference: translate %s never launched %s (launches %s)"
                        % (name, k, launches[name]))
            if name in ("l2r", "ef", "mp collect") and launches[name].get("fused_layer_qsub"):
                die("inference: translate %s launched K2, which only mp's sparse steps take"
                    % name)
            sents = dict(line.split(": ", 1) for line in out.getvalue().splitlines()
                         if line.startswith("video") and ": " in line)
            if len(sents) != n_test:
                die("inference: translate %s printed %d captions for %d test videos"
                    % (name, len(sents), n_test))
            if any(C.MASK_WORD in s.split() for s in sents.values()):
                die("inference: a %s caption holds %s: %s" % (
                    name, C.MASK_WORD,
                    [s for s in sents.values() if C.MASK_WORD in s.split()][:3]))
            if not all(np.isfinite(res[k]) for k in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")):
                die("inference: translate %s gave metrics %s" % (name, res))
            captions[name] = sents
        for k, per in PER_DECODE.items():
            if launches["mp"].get(k, 0) != per:
                die("inference: mp launched %s %d times in its one 64-video decode, "
                    "expected %d" % (k, launches["mp"].get(k, 0), per))
        record = os.path.join(root, "NACF", "testing_record.csv")
        with open(record) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != 1 or abs(float(rows[0]["CIDEr"]) - results["mp"]["CIDEr"]) > 1e-9:
            die("inference: --record wrote %s" % rows)
        (pkl,) = os.listdir(os.path.join(root, "collect"))
        with open(os.path.join(root, "collect", pkl), "rb") as f:
            iter_sents, iter_probs = pickle.load(f)
        t_iter = cfgs["NACF"].iterations + 1
        if len(iter_sents) != n_test or any(len(s) != t_iter for s in iter_sents.values()):
            die("inference: the collect pickle holds %s sentences per video, expected %d"
                % (sorted({len(s) for s in iter_sents.values()}), t_iter))
        last = {v: s[-1] for v, s in iter_sents.items()}
        if last != captions["mp collect"]:
            bad = [v for v in last if last[v] != captions["mp collect"].get(v)]
            die("inference: the last collected iteration is not the caption for %d "
                "videos, e.g. %s" % (len(bad), bad[:2]))

        # -- CaptionPipeline against Evaluator.decode_batch -------------------
        pipe = CaptionPipeline.from_checkpoints(paths["NACF"], teacher=paths["ARB"])
        loader = get_loader(pipe.cfg, "test", info_corpus=corpus, in_memory_feats=feats,
                            batch_size=N_VIDEOS, prefetch=0)
        batch = next(iter(loader))
        fb = {"feats_%s" % ch: batch["feats_%s" % ch] for ch in pipe.cfg.modality.lower()}
        ids = pipe.caption_ids(fb, batch["category"])
        ev = pipe.evaluator
        direct = Evaluator(pipe.cfg, ev.model, ev.teacher_model.cfg, ev.teacher_model)
        want = direct.decode_batch(batch)[0]
        if ids.shape != (N_VIDEOS, pipe.cfg.max_len) or not np.array_equal(ids, want):
            die("inference: CaptionPipeline ids differ from Evaluator.decode_batch's "
                "(agreement %.4f)" % float((ids == want).mean()))
        if any(C.MASK_WORD in s.split() for s in pipe.caption(fb, batch["category"])):
            die("inference: a CaptionPipeline caption holds %s" % C.MASK_WORD)

        # -- decode times, launches per decode, agreement with the CPU ------
        tmodel, tcfg = ev.teacher_model, ev.teacher_model.cfg
        arb_model, arb_cfg, _ = load_model_and_config(paths["ARB"], device="cuda")
        cpu_nacf, _, _ = load_model_and_config(paths["NACF"], device="cpu")
        cpu_arb, _, _ = load_model_and_config(paths["ARB"], device="cpu")
        small = {k: (v[:CPU_VIDEOS] if isinstance(v, np.ndarray) else v)
                 for k, v in batch.items()}
        # l2r without CT as well: with random weights the CT pass leaves no
        # slot at <mask>, so l2r + CT reveals nothing and only the reveal
        # rounds of l2r without CT exercise its loop
        variants = {"mp": dict(), "l2r": dict(paradigm="l2r", q=1, q_iterations=1),
                    "l2r no CT": dict(paradigm="l2r", q=1, q_iterations=1, use_ct=False),
                    "ef": dict(paradigm="ef", q=1, q_iterations=1, use_ct=False)}
        decode_ms, per_decode, agree = {}, {}, {}
        for name, kw in list(variants.items()) + [("ARB", None)]:
            if kw is None:
                dev_ev = Evaluator(arb_cfg.replace(beam_size=5), arb_model)
            else:
                c = pipe.cfg.replace(**dict(dict(use_ct=True), **kw))
                dev_ev = Evaluator(c, ev.model, tcfg, tmodel)
            dev_ev.decode_batch(batch)
            if not dev_ev.generate.graphed:
                die("inference: the %s decode takes no captured route" % name)
            _build.reset_launches()
            dev_ev.decode_batch(batch)
            per_decode[name] = {k: n for k, n in _build.LAUNCHES.items() if n}
            decode_ms[name] = float(np.median([dev_ev.decode_batch(batch)[-1] * 1e3
                                               for _ in range(5)]))
            if name.startswith(("l2r", "ef")):
                cpu_ev = Evaluator(c, cpu_nacf, tcfg, cpu_arb)
                agree[name] = float((cpu_ev.decode_batch(small)[0]
                                     == dev_ev.decode_batch(small)[0]).mean())
    log("inference entry points [%s]: translate on the card, %d-video test split of %d "
        "synthetic videos, batch %d, d=512, vocab 10048, random weights; seconds per "
        "translate call (host clock, ends in a synchronise) %s; metrics %s" % (
            card, n_test, ENTRY_VIDEOS, N_VIDEOS,
            {k: round(v, 3) for k, v in seconds.items()},
            {k: {m: round(r[m], 4) for m in ("Bleu_4", "METEOR", "CIDEr")}
             for k, r in results.items()}))
    log("inference launches per translate call [%s]: %s" % (card, launches))
    log("inference decode of %d videos [%s]: ms per decode (median of 5, host clock, "
        "ends in the tokens' copy) %s; launches per decode %s; peak memory of a translate "
        "call %.3f GB; CPU plain path agreement on %d videos %s" % (
            N_VIDEOS, card, {k: round(v, 3) for k, v in decode_ms.items()},
            {k: per_decode[k] for k in agree}, peak, CPU_VIDEOS,
            {k: round(v, 4) for k, v in agree.items()}))
    if per_decode["l2r no CT"].get("fused_layer", 0) <= 3:
        die("inference: l2r without CT ran no reveal round (launches %s)"
            % per_decode["l2r no CT"])
    for name, a in agree.items():
        if a < 0.99:
            die("inference: %s token agreement with the CPU plain path %.4f < 0.99"
                % (name, a))
    return dict(captions=captions, refs=refs)


# the learning phase: make_flagship_synthetic at full width, the four methods
# trained through train_network_all in the order of the two-stage pipeline,
# the CPU learning tests' hyperparameters (tests/test_torch_port_learning.py,
# navc_tpu's tests/test_learning.py: lr 2e-3 down to 5e-4, no dropout)
LEARN_VIDEOS, LEARN_CLASSES, LEARN_EPOCHS, LEARN_EVALS = 256, 32, 10, 2
LEARN_OVER = dict(OVER, batch_size=TRAIN_B, learning_rate=2e-3,
                  minimum_learning_rate=5e-4, hidden_dropout_prob=0.0, encoder_dropout=0.0)
# the test-CIDEr floor of each method: half the lowest of the CPU
# calibration on this corpus and schedule that was written down before the
# first card run (d=128, 10 epochs: ARB 9.54, NACF 8.54, NAB 8.57, ARB2
# 9.63; oracle 10.0, majority caption 0.19), so that a fault that halves a
# method's quality fails
LEARN_FLOOR = {"ARB": 5.0, "ARB2": 5.0, "NAB": 5.0, "NACF": 5.0}
BEAM_STEPS = 29  # max_len - 1: a beam that never stops early


def learning_phase(card):
    """All four methods trained at full width on the card: the port's
    make_flagship_synthetic (LEARN_VIDEOS videos of LEARN_CLASSES latent
    classes, features clustered by class, one caption of 8-18 words from the
    10048-word vocab a class; MSRVTT categories), train_network_all for
    LEARN_EPOCHS epochs each (validation LEARN_EVALS times, the test split
    on the best checkpoint): ARB, then NACF and NAB with that best.ckpt as
    teacher (warm start and rescoring), then ARB2. Gated: each run's train
    loss in its last epoch below its first, and its test CIDEr above
    LEARN_FLOOR. On the trained weights: the ARB beam on a 64-video request
    stops before BEAM_STEPS steps, eager and replayed (tokens and scores bit
    for bit; launches once a step that ran on each route, the eager route
    reading its flag DONE_LAG steps late), agrees >= 0.99 with the CPU plain
    path, and its replay runs as many steps as the CPU's blocked schedule;
    NACF's l2r and ef, with and without CT, eager and replayed (bit for bit,
    the same launches; ef's blocks printed); 3
    NACF requests of different videos through StreamingCaptioner capture
    one graph; the ARB's and ARB2's full-prefix routes against the CPU
    (``full_prefix_checks`` with ``trained``: K1's teacher-forced log-probs
    against its plain version's, the forward's gap printed, the beam
    against K1's plain version and against the model's own forward).
    Returns the figures."""
    import tempfile

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.synthetic import make_flagship_synthetic
    from navc_tpu_torch.runtime import loop

    over = dict(LEARN_OVER, epochs=LEARN_EPOCHS,
                save_checkpoint_every=LEARN_EPOCHS // LEARN_EVALS)
    base = default_config("ARB", **over)
    corpus, refs, feats = make_flagship_synthetic(
        base, n_videos=LEARN_VIDEOS, n_classes=LEARN_CLASSES, vocab_size=base.vocab_size,
        n_total_frames=ENTRY_FRAMES)
    with tempfile.TemporaryDirectory(prefix="learning_") as root:
        results = {}
        for method in ("ARB", "NACF", "NAB", "ARB2"):
            cfg = default_config(method, **over)
            if cfg.decoding_type == "NARFormer":
                cfg = cfg.replace(teacher_path=os.path.join(root, "ARB", "best.ckpt"))
            t0 = time.perf_counter()
            out = loop.train_network_all(cfg, workdir=os.path.join(root, method), verbose=False,
                                         info_corpus=corpus, references=refs,
                                         in_memory_feats=feats)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            with open(os.path.join(root, method, "trainval", "events.jsonl")) as f:
                losses = [e["value"] for e in map(json.loads, f) if e["tag"] == "total_loss"]
            r = results[method] = dict(
                seconds=seconds, train_loss=losses,
                val_cider=[h["CIDEr"] for h in out["history"]],
                test={k: out["test_res"][k] for k in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr")})
            del out
            log("learning: %s [%s], %d videos of %d classes, batch %d, %d epochs: %.1f s; "
                "train loss %s; validation CIDEr %s; test %s (floor: CIDEr > %.1f)" % (
                    method, card, LEARN_VIDEOS, LEARN_CLASSES, cfg.batch_size, LEARN_EPOCHS,
                    r["seconds"], ["%.3f" % x for x in r["train_loss"]],
                    ["%.4f" % x for x in r["val_cider"]],
                    {k: round(v, 4) for k, v in r["test"].items()}, LEARN_FLOOR[method]))
            if not (len(losses) == LEARN_EPOCHS and np.isfinite(losses).all()
                    and losses[-1] < losses[0]):
                die("learning: %s's train loss did not fall: %s" % (method, losses))
            if not r["test"]["CIDEr"] > LEARN_FLOOR[method]:
                die("learning: %s's test CIDEr %.4f is not above its floor %.1f"
                    % (method, r["test"]["CIDEr"], LEARN_FLOOR[method]))
        results.update(trained_checks(root, corpus, feats, base, card))
    return results


def trained_checks(root, corpus, feats, base, card):
    """The learning phase's checks on the weights trained under ``root``
    (``learning_phase`` says which). Returns the figures."""
    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
    from navc_tpu_torch.decoding.beam import DONE_LAG
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.checkpoint import load_model_and_config
    from navc_tpu_torch.runtime.serving import StreamingCaptioner

    results = {}

    def request_of(vids):
        """(features, categories) of the corpus's videos ``vids``."""
        return ([np.stack([feats["feats_%s" % ch]["video%d" % v][:base.n_frames]
                           for v in vids]) for ch in base.modality.lower()],
                np.array([[corpus["info"]["itoc"][v]] for v in vids], np.int64))

    # -- a 64-video request of held-out videos (validation and test) -------
    req_feats, req_cat = request_of(
        (corpus["info"]["split"]["validate"] + corpus["info"]["split"]["test"])[:N_VIDEOS])
    arb, acfg, _ = load_model_and_config(os.path.join(root, "ARB", "best.ckpt"), device="cuda")
    cpu_arb, _, _ = load_model_and_config(os.path.join(root, "ARB", "best.ckpt"), device="cpu")
    nacf, ncfg, _ = load_model_and_config(os.path.join(root, "NACF", "best.ckpt"),
                                          device="cuda")
    with torch.no_grad():
        enc = arb.encode([torch.as_tensor(f).cuda() for f in req_feats])
        nenc = nacf.encode([torch.as_tensor(f).cuda() for f in req_feats])
    cat = torch.as_tensor(req_cat).cuda()

    # -- the trained beam stops early, eager and replayed ---------------------
    eager, replay = (make_ar_generator(acfg, arb, jit) for jit in (False, True))
    _build.reset_launches()
    want = eager(enc, cat)
    eager_launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    eager_steps = eager.steps_run
    got = [replay(enc, cat)]  # warm-up and capture
    steps0 = replay.steps_run
    _build.reset_launches()
    got.append(replay(enc, cat))
    steps = replay.steps_run - steps0
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    for g in got:
        if not all(torch.equal(x, y) for x, y in zip(g, want)):
            die("learning: the trained ARB beam's replayed tokens or scores differ from "
                "the eager route's")
    kernels = ("project_topk", "beam_attend_step", "cross_attend")
    if (launches != {k: steps for k in kernels}
            or eager_launches != {k: eager_steps for k in kernels}):
        die("learning: a replayed trained beam of %d steps launched %s (the eager route's %d "
            "steps %s), expected %s once a step" % (steps, launches, eager_steps,
                                                    eager_launches, kernels))
    cpu_gen = make_ar_generator(acfg, cpu_arb)  # the blocked schedule, eager on the CPU
    cpu_hyp = cpu_gen({k: v.cpu() for k, v in enc.items()}, cat.cpu())[0]
    agree = float((cpu_hyp == want[0].cpu()).float().mean())
    hyp = want[0].cpu().numpy()
    ended = float((hyp == C.EOS).any(1).mean())
    results["ARB early stop"] = dict(steps=steps, eager_steps=eager_steps,
                                     cpu_steps=cpu_gen.steps_run, cpu_agreement=agree,
                                     ended=ended, launches=launches)
    log("learning: trained ARB beam on %d held-out videos [%s]: replayed %d steps of %d in "
        "blocks of %d (the CPU's blocked schedule %d; the eager route, its flag read %d "
        "steps late, %d), %.3f of the captions end in EOS; replayed tokens and scores bit for "
        "bit the eager route's; launches per replayed decode %s; CPU plain path agreement "
        "%.4f" % (N_VIDEOS, card, steps, BEAM_STEPS, DONE_LAG, cpu_gen.steps_run, DONE_LAG,
                  eager_steps, ended, launches, agree))
    if not steps < BEAM_STEPS or steps != cpu_gen.steps_run:
        die("learning: the trained ARB beam's replay ran %d steps (the CPU's blocked schedule "
            "%d), not fewer than %d and as many as the CPU's" % (
                steps, cpu_gen.steps_run, BEAM_STEPS))
    if agree < 0.99:
        die("learning: the trained ARB beam agrees %.4f with the CPU plain path < 0.99" % agree)

    # -- NACF's l2r and ef, with and without CT, on the trained weights ------
    for name, kw in (("l2r + CT", dict(paradigm="l2r", use_ct=True, q=1, q_iterations=1)),
                     ("ef + CT", dict(paradigm="ef", use_ct=True, q=1, q_iterations=1)),
                     ("l2r", dict(paradigm="l2r", use_ct=False, q=1, q_iterations=1)),
                     ("ef", dict(paradigm="ef", use_ct=False, q=1, q_iterations=1))):
        c = ncfg.replace(**kw)
        eager_n, replay_n = (make_nar_generator(c, nacf, arb, jit) for jit in (False, True))
        _build.reset_launches()
        want_n = eager_n(nenc, cat, enc)
        eager_launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        replay_n(nenc, cat, enc)  # warm-up and capture
        blocks0 = getattr(replay_n, "blocks_run", 0)
        reads0 = getattr(replay_n, "flag_reads", 0)
        _build.reset_launches()
        got_n = replay_n(nenc, cat, enc)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        if not torch.equal(got_n, want_n) or launches != eager_launches:
            die("learning: trained NACF %s: replayed tokens or launches %s differ from the "
                "eager route's %s" % (name, launches, eager_launches))
        stop = dict(launches=launches)
        if hasattr(replay_n, "blocks_run"):
            stop.update(rounds=int(replay_n.rounds), blocks=replay_n.blocks_run - blocks0,
                        flag_reads=replay_n.flag_reads - reads0)
        masks = float((got_n.cpu() == C.MASK).float().mean())
        results["NACF " + name] = stop
        log("learning: trained NACF %s on %d held-out videos: replayed bit for bit the eager "
            "route; %s; <mask> share of the output %.4f" % (name, N_VIDEOS, stop, masks))

    # -- mp keeps one graph across requests of trained, varying lengths -------
    cap = StreamingCaptioner(ncfg, nacf, (acfg, arb), depth=2)
    order = np.random.RandomState(3).permutation(LEARN_VIDEOS)
    outs = list(cap.map_stream([request_of(part) for part in
                                np.array_split(order[:3 * N_VIDEOS], 3)]))
    lengths = [sorted(set((o != C.PAD).sum(1).tolist())) for o in outs]
    n_graphs = len(cap.generate.graphs)
    results["NACF graphs"] = n_graphs
    log("learning: 3 trained NACF requests of %d videos: caption lengths %s; the mp "
        "decode holds %d graph(s)" % (N_VIDEOS, lengths, n_graphs))
    if n_graphs != 1:
        die("learning: the mp decode captured %d graphs for 3 requests of one width" % n_graphs)

    # -- the full-prefix beam against the CPU forward, trained ----------------
    for method in ("ARB", "ARB2"):
        path = os.path.join(root, method, "best.ckpt")
        model, mcfg, _ = load_model_and_config(path, device="cuda")
        cpu_model = load_model_and_config(path, device="cpu")[0]
        with torch.no_grad():
            menc = model.encode([torch.as_tensor(f).cuda() for f in req_feats])
        with no_kvcache():
            prefix = make_ar_generator(mcfg, model)
        results["%s full prefix" % method] = full_prefix_checks(
            mcfg, model, cpu_model, (menc, cat), prefix, "learning: trained " + method,
            trained=True)
    return results


# the switches phase: navc_tpu's A/B route switches, each in a process of its
# own started with the switch in its environment (chip_smoke.py --switch
# NAME), against the default route run here. (name, environment, what runs)
SWITCH_CASES = (
    ("NAVC_DENSE_REFINE", {"NAVC_DENSE_REFINE": "1"}, "mp"),
    ("NAVC_NO_ATTEND_KERNEL", {"NAVC_NO_ATTEND_KERNEL": "1"}, "beam"),
    ("NAVC_NO_ATTEND_KERNEL + NAVC_NO_PERMUTE_KERNEL",
     {"NAVC_NO_ATTEND_KERNEL": "1", "NAVC_NO_PERMUTE_KERNEL": "1"}, "beam"),
    ("NAVC_NO_TOPK_KERNEL", {"NAVC_NO_TOPK_KERNEL": "1"}, "beam"),
    ("NAVC_NO_FUSED_TRAIN", {"NAVC_NO_FUSED_TRAIN": "1"}, "step"),
    ("NAVC_NO_FUSED_CE", {"NAVC_NO_FUSED_CE": "1"}, "step"),
)
SWITCH_NAMES = ("NAVC_DENSE_REFINE", "NAVC_NO_ATTEND_KERNEL", "NAVC_NO_PERMUTE_KERNEL",
                "NAVC_NO_TOPK_KERNEL", "NAVC_NO_FUSED_TRAIN", "NAVC_NO_FUSED_CE",
                "NAVC_NO_KVCACHE")
SWITCH_ROUNDS = 10  # timed replays a route


def switch_file(name):
    return os.path.join(ROOT, "navc_tpu_torch", "build",
                        "chip_smoke_switch_%s.pt" % "".join(c for c in name if c.isalnum()))


def switch_run(kind, what, checks):
    """One route of a switch case, in this process's environment: ``mp``
    the NACF mp + CT decode with the ARB teacher at N_VIDEOS videos,
    ``beam`` the ARB beam at ARB_VIDEOS, ``step`` the NACF compiled step at
    TRAIN_B; the decodes and the step replay CUDA graphs (jit=True). With
    ``checks``, the step's p = 0 step against the CPU plain path
    (``cpu_step_check``) and the compiled step against the eager one
    (``captured_step_check``), the beam's tokens against the CPU on
    ARB_CPU videos. Returns (figures, tensors): launches of one replayed
    decode or step, ms of a replay (median of SWITCH_ROUNDS, host clock,
    ending in the tokens' copy or the loss's read)."""
    import dataclasses

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.decoding import make_ar_generator, make_nar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    seeded = lambda s: torch.Generator().manual_seed(s)
    figures, tensors = {}, {}
    if kind == "step":
        c = default_config("NACF", **OVER)
        if checks:
            ccfg = c.replace(batch_size=TRAIN_CPU, hidden_dropout_prob=0.0, encoder_dropout=0.0)
            (small,) = loader_batches(ccfg, TRAIN_CPU, 1, seed=0)
            figures["p = 0 step"] = cpu_step_check(ccfg, small, 10, what)
        bcfg = c.replace(batch_size=TRAIN_B)
        batches = loader_batches(bcfg, TRAIN_B, 3, seed=0)
        if checks:
            figures["compiled step"] = captured_step_check(bcfg, batches, 20, what)
        m = build_model(bcfg, device="cuda", generator=seeded(20), train=True)
        step = make_train_step(bcfg, m, create_train_state(bcfg, m).optimizer)
        gen = seeded(0)
        step(batches[0], gen)  # a real step, then the capture
        torch.cuda.synchronize()
        _build.reset_launches()
        loss = float(step(batches[1], gen)["total_loss"])
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        if launches != step_launches(bcfg, step.routes):
            die("%sa replayed step launched %s, expected %s"
                % (what, launches, step_launches(bcfg, step.routes)))
        ms = [host_ms(lambda i=i: float(step(batches[i % 3], gen)["total_loss"]), iters=1)
              for i in range(SWITCH_ROUNDS)]
        figures.update(routes=step.routes._asdict(), loss=loss)
    else:
        beam = kind == "beam"
        cfg = default_config("ARB" if beam else "NACF", **OVER)
        model = build_model(cfg, device="cuda", generator=seeded(1 if beam else 0))
        b = ARB_VIDEOS if beam else N_VIDEOS
        rng = np.random.RandomState(31)
        feats_np = [rng.randn(b, cfg.n_frames, d).astype(np.float32) for d in cfg.modality_dims]
        cat = torch.as_tensor(rng.randint(0, cfg.num_category, (b, 1))).cuda()
        feats = [torch.as_tensor(f).cuda() for f in feats_np]
        with torch.no_grad():
            enc = model.encode(feats)
        if beam:
            gen = make_ar_generator(cfg, model, jit=True)
            run = lambda: gen(enc, cat)[0]
        else:
            tcfg = default_config("ARB", **OVER)
            teacher = build_model(tcfg, device="cuda", generator=seeded(1))
            with torch.no_grad():
                tenc = teacher.encode(feats)
            gen = make_nar_generator(cfg, model, teacher, jit=True)
            run = lambda: gen(enc, cat, tenc)
        run()  # the warm-up and the capture
        torch.cuda.synchronize()
        steps0 = getattr(gen, "steps_run", 0)
        _build.reset_launches()
        hyp = run().cpu()
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        steps = getattr(gen, "steps_run", 0) - steps0
        ms = [host_ms(lambda: run().cpu(), iters=1) for _ in range(SWITCH_ROUNDS)]
        tensors["hyp"] = hyp
        if beam:
            figures.update(steps=steps, routes=dataclasses.asdict(gen.routes))
            if checks:
                cpu_model = build_model(cfg, device="cpu", generator=seeded(1))
                with torch.no_grad():
                    cpu_enc = cpu_model.encode([torch.as_tensor(f[:ARB_CPU]) for f in feats_np])
                cpu_hyp = make_ar_generator(cfg, cpu_model)(cpu_enc, cat[:ARB_CPU].cpu())[0]
                figures["cpu_agreement"] = float((cpu_hyp == hyp[:ARB_CPU]).float().mean())
    figures.update(launches=launches, ms=float(np.median(ms)))
    return figures, tensors


def switch_worker(name):
    """--switch NAME: run SWITCH_CASES[NAME]'s route with the switch that the
    parent set in this process's environment before anything was built;
    the tensors go to ``switch_file(name)``, the figures as this process's
    last line of standard output."""
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env, kind = next((e, k) for n, e, k in SWITCH_CASES + REMAT_WORKERS if n == name)
    got = {k: os.environ.get(k) for k in SWITCH_NAMES if os.environ.get(k)}
    if got != env:
        die("switch worker %s: the environment holds %s, expected %s" % (name, got, env))
    if kind == "remat":
        figures, tensors = remat_run("%s: " % name), {}
    else:
        figures, tensors = switch_run(kind, "%s: " % name, checks=True)
    torch.save(tensors, switch_file(name))
    print(json.dumps(dict(figures, switches=got)), flush=True)
    return 0


def switch_process(name, env):
    """Run ``--switch name`` in a fresh process with ``env`` added to this
    one's environment (every other switch taken out); its output is logged
    here. Returns (figures, tensors)."""
    import torch

    full = {k: v for k, v in os.environ.items() if k not in SWITCH_NAMES}
    full.update(env)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--switch", name],
                          cwd=ROOT, env=full, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log("  [%s] %s" % (name, line))
    if proc.returncode != 0 or not lines:
        die("switch worker %s exited with %d: %s" % (name, proc.returncode,
                                                     proc.stderr.strip()[-3000:]))
    figures = json.loads(lines[-1])
    figures["process_s"] = time.perf_counter() - t0
    tensors = torch.load(switch_file(name))
    os.remove(switch_file(name))
    return figures, tensors


def switches_phase(card):
    """Each of SWITCH_CASES in its own fresh process (``switch_process``),
    against the default route run here (``switch_run`` without the
    switch): replayed ms beside the default route's, launches of one
    replayed decode or step, and each switch's gate. NAVC_DENSE_REFINE: K2
    0 and K1 the refinements (PER_DECODE's K1 and K2 together), tokens
    >= 0.99 the default route's. NAVC_NO_ATTEND_KERNEL: K6 and K7 0, K8
    and K5 once a beam step; with NAVC_NO_PERMUTE_KERNEL also K8 0.
    NAVC_NO_TOPK_KERNEL: K5 0, K6 and K7 once a step, tokens >= 0.99 the
    CPU's (the CPU beam under the switch too). NAVC_NO_FUSED_TRAIN: no
    K11, K12, reduction, K9 or K10 (navc_tpu fuses the loss only on the
    fused layer's route); NAVC_NO_FUSED_CE: no K9 or K10, K11 and K12 as
    before; each with the p = 0 step against the CPU plain path and the
    compiled step bit for bit the eager one. Returns {case: figures}."""
    import numpy as np

    from navc_tpu_torch.ops.eligibility import fused_sparse_eligible
    from navc_tpu_torch.config import default_config

    if any(os.environ.get(k) for k in SWITCH_NAMES):
        die("switches: a switch is set in this process: %s"
            % {k: os.environ[k] for k in SWITCH_NAMES if os.environ.get(k)})
    if not fused_sparse_eligible(default_config("NACF", **OVER)):
        die("switches: the default NACF route takes no sparse refinement")
    defaults = {kind: switch_run(kind, "switches: default %s: " % kind, checks=False)
                for kind in ("mp", "beam", "step")}
    results = {}
    for name, env, kind in SWITCH_CASES:
        got, tensors = switch_process(name, env)
        base, base_tensors = defaults[kind]
        l = got["launches"]
        steps = got.get("steps")
        agree = None
        if kind == "mp":
            expect = dict(PER_DECODE, fused_layer_qsub=0,
                          fused_layer=PER_DECODE["fused_layer"] + PER_DECODE["fused_layer_qsub"])
            agree = float((tensors["hyp"] == base_tensors["hyp"]).float().mean())
            if agree < 0.99:
                die("switches: %s: tokens agree %.4f < 0.99 with the default route's"
                    % (name, agree))
        elif kind == "beam":
            no_attend = "NAVC_NO_ATTEND_KERNEL" in env
            expect = dict(project_topk=0 if "NAVC_NO_TOPK_KERNEL" in env else steps,
                          beam_attend_step=0 if no_attend else steps,
                          cross_attend=0 if no_attend else steps,
                          permute_beam_caches=steps if no_attend and
                          "NAVC_NO_PERMUTE_KERNEL" not in env else 0)
            agree = float((tensors["hyp"] == base_tensors["hyp"]).float().mean())
            if "NAVC_NO_TOPK_KERNEL" in env and got["cpu_agreement"] < 0.99:
                die("switches: %s: tokens agree %.4f < 0.99 with the CPU's"
                    % (name, got["cpu_agreement"]))
        else:
            expect = {k: n for k, n in base["launches"].items()
                      if not (k in CE_KERNELS or ("NAVC_NO_FUSED_TRAIN" in env
                                                  and k in LAYER_KERNELS))}
        expect = {k: n for k, n in expect.items() if n}
        if l != expect:
            die("switches: %s: a replay launched %s, expected %s" % (name, l, expect))
        results[name] = dict(got, default_ms=base["ms"], default_launches=base["launches"],
                             default_agreement=agree)
        log("switches: %s [%s]: %s replayed %.3f ms (default route %.3f ms, host clock, "
            "median of %d); launches %s (default %s)%s%s; fresh process %.1f s" % (
                name, card, {"mp": "NACF mp decode of %d videos" % N_VIDEOS,
                             "beam": "ARB decode of %d videos" % ARB_VIDEOS,
                             "step": "NACF step at B=%d" % TRAIN_B}[kind],
                got["ms"], base["ms"], SWITCH_ROUNDS, l, base["launches"],
                "" if agree is None else "; tokens %.4f the default route's" % agree,
                "; CPU agreement on %d videos %.4f" % (ARB_CPU, got["cpu_agreement"])
                if "cpu_agreement" in got else "", got["process_s"]))
    return results


def selfmask_phase(card):
    """SelfMask (the parallel-MLM AR variant, parallel_mlm on) in an ARB
    configuration at full width, random weights: one bf16 step at p = 0 of
    TRAIN_CPU videos against the CPU plain path (``cpu_step_check``: the
    module route on both), the compiled step at B=TRAIN_B (dropout 0.5, 3
    steps) bit for bit the eager one, launching no kernel (SelfMask trains
    on the module route), and a ARB_VIDEOS-video beam decode through K5,
    K6 and K7 (once a beam step), replayed bit for bit the eager decode,
    >= 0.99 the CPU's on ARB_CPU videos, ms per decode both routes (median
    of SWITCH_ROUNDS). Returns the figures."""
    import numpy as np
    import torch

    from navc_tpu_torch import constants as C
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.decoding import make_ar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build

    c = default_config("ARB", **OVER).replace(decoding_type="SelfMask", parallel_mlm=True)
    ccfg = c.replace(batch_size=TRAIN_CPU, hidden_dropout_prob=0.0, encoder_dropout=0.0)
    (small,) = loader_batches(ccfg, TRAIN_CPU, 1, seed=4)
    results = {"p = 0 step": cpu_step_check(ccfg, small, 30, "SelfMask: ")}
    bcfg = c.replace(batch_size=TRAIN_B)
    results["compiled step"] = captured_step_check(
        bcfg, loader_batches(bcfg, TRAIN_B, 3, seed=4), 31, "SelfMask: ")
    model = build_model(c, device="cuda", generator=torch.Generator().manual_seed(31))
    rng = np.random.RandomState(37)
    feats_np = [rng.randn(ARB_VIDEOS, c.n_frames, d).astype(np.float32) for d in c.modality_dims]
    cat = torch.as_tensor(rng.randint(0, c.num_category, (ARB_VIDEOS, 1))).cuda()
    with torch.no_grad():
        enc = model.encode([torch.as_tensor(f).cuda() for f in feats_np])
    gens = {jit: make_ar_generator(c, model, jit=jit) for jit in (False, True)}
    out = {}
    for jit, gen in gens.items():
        gen(enc, cat)  # the replayed route's warm-up and capture
        steps0 = gen.steps_run
        _build.reset_launches()
        out[jit] = gen(enc, cat)[0].cpu()
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        steps = gen.steps_run - steps0
        want = dict(project_topk=steps, beam_attend_step=steps, cross_attend=steps)
        if launches != want:
            die("SelfMask: a %s decode launched %s, expected %s"
                % ("replayed" if jit else "eager", launches, want))
    if not torch.equal(out[True], out[False]):
        die("SelfMask: the replayed beam's tokens differ from the eager beam's")
    check_captions(out[True].numpy(), ARB_VIDEOS, c.max_len, c.vocab_size, C.EOS, C.PAD)
    cpu_model = build_model(c, device="cpu", generator=torch.Generator().manual_seed(31))
    with torch.no_grad():
        cpu_enc = cpu_model.encode([torch.as_tensor(f[:ARB_CPU]) for f in feats_np])
    cpu_hyp = make_ar_generator(c, cpu_model)(cpu_enc, cat[:ARB_CPU].cpu())[0]
    agree = float((cpu_hyp == out[True][:ARB_CPU]).float().mean())
    if agree < 0.99:
        die("SelfMask: beam tokens agree %.4f < 0.99 with the CPU plain path" % agree)
    ms = {jit: float(np.median([host_ms(lambda g=g: g(enc, cat)[0].cpu(), iters=1)
                                for _ in range(SWITCH_ROUNDS)])) for jit, g in gens.items()}
    results["beam"] = dict(steps=steps, launches=launches, cpu_agreement=agree,
                           eager_ms=ms[False], replay_ms=ms[True])
    log("SelfMask [%s]: beam of %d videos, eager %.3f ms, replayed %.3f ms per decode "
        "(median of %d, host clock, ends in the tokens' copy), %d steps, launches %s, "
        "replayed bit for bit the eager decode, CPU plain path agreement on %d videos %.4f"
        % (card, ARB_VIDEOS, ms[False], ms[True], SWITCH_ROUNDS, steps, launches, ARB_CPU,
           agree))
    return results


# the remat phase: cfg.remat at B=TRAIN_BENCH, dropout REMAT_P, on the fused
# route here and on the module route in a process started with
# NAVC_NO_FUSED_TRAIN (chip_smoke.py --switch NAME)
REMAT_P, REMAT_STEPS, REMAT_ROUNDS = 0.1, 2, 5
REMAT_WORKERS = (("remat, NAVC_NO_FUSED_TRAIN", {"NAVC_NO_FUSED_TRAIN": "1"}, "remat"),)


def remat_run(what):
    """The NACF step at B=TRAIN_BENCH, dropout REMAT_P, on this process's
    route, remat off and on, eager and replayed, from one seed, batches and
    CPU generator state: REMAT_STEPS steps whose losses and every gradient
    must equal remat off's eager steps bit for bit; each one's launches a
    step (remat: ``step_launches``, K11 and K9 twice a pass), peak GB of the
    last eager step above what was held before it, the pool MiB of the
    replayed step's graph, ms per step (median of REMAT_ROUNDS, host clock,
    the loss read). Returns {"remat off" / "remat on": {route: figures}}."""
    import gc

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.runtime.train_step import (TrainRoutes, create_train_state,
                                                   make_train_step)

    base = default_config("NACF", batch_size=TRAIN_BENCH, **OVER).replace(
        hidden_dropout_prob=REMAT_P, encoder_dropout=REMAT_P)
    rng = np.random.RandomState(0)
    batches = [train_batch(base, TRAIN_BENCH, rng) for _ in range(REMAT_STEPS)]
    ref, results = None, {}
    for remat in (False, True):
        cfg = base.replace(remat=remat)
        for jit in (False, True):
            model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                                train=True)
            step = make_train_step(cfg, model, create_train_state(cfg, model).optimizer,
                                   jit=jit)
            gen = torch.Generator().manual_seed(0)
            out = []
            for b in batches:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                _build.reset_launches()
                loss = float(step(b, gen)["total_loss"])
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - held) / 1e9
                out.append((loss, {k: p.grad.detach().clone() for k, p in model.named_parameters()}))
            launches = {k: n for k, n in _build.LAUNCHES.items() if n}
            if launches != step_launches(cfg, step.routes):
                die("%sremat %s, %s: a step launched %s, expected %s" % (
                    what, remat, "replayed" if jit else "eager", launches,
                    step_launches(cfg, step.routes)))
            if ref is None:
                ref = out
            for i, ((loss, grads), (want_loss, want)) in enumerate(zip(out, ref)):
                bad = [k for k, g in grads.items() if not torch.equal(g, want[k])]
                if loss != want_loss or bad:
                    die("%sremat %s, %s, step %d: loss %r against %r, %d gradients differ "
                        "from remat off's eager step (%s)" % (
                            what, remat, "replayed" if jit else "eager", i, loss, want_loss,
                            len(bad), bad[:3]))
            ms = float(np.median([host_ms(lambda: float(step(batches[0], gen)["total_loss"]),
                                          iters=1) for _ in range(REMAT_ROUNDS)]))
            fig = dict(ms=ms, launches=launches, losses=[o[0] for o in out])
            if jit:
                fig["pool_mb"] = sum(c.graph.pool_bytes for c in step.jitted.graphs.values()) \
                    / 2 ** 20
            else:
                fig["peak_gb"] = peak
            results.setdefault("remat %s" % ("on" if remat else "off"), {})[
                "replayed" if jit else "eager"] = fig
            del model, step, out
            gc.collect()
            torch.cuda.empty_cache()
    return dict(results, routes=TrainRoutes.of(base)._asdict())


def remat_phase(card):
    """``remat_run`` on the fused route here and on the module route in a
    fresh process (REMAT_WORKERS); prints peak GB and ms per step of each.
    Returns {route: figures}."""
    results = {"fused": remat_run("remat, fused route: ")}
    for name, env, _ in REMAT_WORKERS:
        results["modules"], _ = switch_process(name, env)
    for route, r in results.items():
        off, on = r["remat off"], r["remat on"]
        log("remat [%s]: NACF step at B=%d, dropout %.1f, %s route (%s): remat off / on: "
            "peak GB of an eager step %.3f / %.3f, ms per step eager %.3f / %.3f, replayed "
            "%.3f / %.3f (median of %d, host clock, the loss read), graph pool MiB %.1f / "
            "%.1f; launches a step off %s, on %s; %d steps each bit for bit remat off's eager "
            "steps (loss and every gradient), losses %s" % (
                card, TRAIN_BENCH, REMAT_P, route, r["routes"], off["eager"]["peak_gb"],
                on["eager"]["peak_gb"], off["eager"]["ms"], on["eager"]["ms"],
                off["replayed"]["ms"], on["replayed"]["ms"], REMAT_ROUNDS,
                off["replayed"]["pool_mb"], on["replayed"]["pool_mb"],
                off["replayed"]["launches"], on["replayed"]["launches"], REMAT_STEPS,
                ["%.4f" % x for x in on["replayed"]["losses"]]))
    if not results["fused"]["routes"]["layer"] or results["modules"]["routes"]["layer"]:
        die("remat: the routes were %s / %s" % (results["fused"]["routes"],
                                                results["modules"]["routes"]))
    return results


# the offline phase: MSR-VTT's annotation at its published size (10,000
# videos of 20 captions, split 6513 / 497 / 2990), cut only where the
# preparation would pass PREP_LIMIT_S host seconds
PREP_VIDEOS, PREP_CAPS, PREP_SPLIT, PREP_LIMIT_S = 10000, 20, (6513, 497, 2990), 30.0


def msrvtt_annotation(path, n_videos, seed=0):
    """A seeded annotation file in MSR-VTT's videodatainfo.json shape:
    ``videos`` (id, video_id, category of 20, split in PREP_SPLIT's
    proportions) and PREP_CAPS ``sentences`` a video (lengths 4-19 words
    from a Zipf-like law over 20,000 words, some capitals and commas)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n_train = n_videos * PREP_SPLIT[0] // PREP_VIDEOS
    n_val = n_videos * PREP_SPLIT[1] // PREP_VIDEOS
    splits = ["train"] * n_train + ["validate"] * n_val + ["test"] * (n_videos - n_train - n_val)
    words = np.array(["w%d" % i for i in range(20000)])
    p = 1.0 / np.arange(1, len(words) + 1)
    n_caps = n_videos * PREP_CAPS
    lengths = rng.randint(4, 20, n_caps)
    flat = words[rng.choice(len(words), lengths.sum(), p=p / p.sum())]
    cuts = np.cumsum(lengths)[:-1]
    sentences = []
    for i, cap in enumerate(np.split(flat, cuts)):
        text = " ".join(cap)
        sentences.append({"video_id": "video%d" % (i // PREP_CAPS), "sen_id": i,
                          "caption": text.capitalize() if i % 3 == 0 else text + " ,"})
    videos = [{"id": i, "video_id": "video%d" % i, "category": int(rng.randint(20)),
               "split": s} for i, s in enumerate(splits)]
    with open(path, "w") as f:
        json.dump({"videos": videos, "sentences": sentences}, f)


def offline_phase(card, inference):
    """The native scorer and corpus preparation on the card's host: the
    native library built from navc_tpu_torch/native with the host's C++
    compiler; the inference phase's mp captions of its test split scored
    on both routes — the native library (tokenizer, BLEU, CIDEr, ROUGE-L,
    the legacy METEOR) and the Python scorers — equal within 1e-10, ms of
    each (median of 3, host clock); then ``python -m
    navc_tpu_torch.cli.prepare_corpora``'s main on ``msrvtt_annotation`` at
    PREP_VIDEOS videos (a 1000-video run first projects the host seconds;
    past PREP_LIMIT_S the video count is cut and the line says so), its
    pickles read back and checked. Returns the figures."""
    import io
    import pickle
    import tempfile

    import numpy as np

    from navc_tpu_torch.cli.prepare_corpora import main as prepare_main
    from navc_tpu_torch.metrics import (corpus_bleu, corpus_cider, corpus_meteor,
                                        corpus_rouge_l, ptb_tokenize)
    from navc_tpu_torch.native import lib as native

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    caps, refs = inference["captions"]["mp"], inference["refs"]
    vids = sorted(caps)
    # the random-weight captions share nothing with the references (scores
    # 0), so each video's first reference, one of its references, scores too
    gts = {v: [r["caption"] for r in refs[v]] for v in vids}
    sets = {"mp captions": {"res": {v: [caps[v]] for v in vids}, "gts": gts},
            "first references": {"res": {v: gts[v][:1] for v in vids}, "gts": gts}}

    def route(raw, tokenize, bleu, cider, rouge, meteor):
        tok = {k: {v: [" ".join(tokenize(s)) for s in c[v]] for v in vids}
               for k, c in raw.items()}
        h, r = tok["res"], tok["gts"]
        return tok, dict(bleu=list(bleu(h, r)), cider=cider(h, r), rouge=rouge(h, r),
                         meteor=meteor(h, r))

    routes = {"native": (native.tokenize, native.bleu_corpus, native.cider_corpus,
                         native.rouge_corpus, native.meteor_corpus),
              "python": (ptb_tokenize, lambda h, r: corpus_bleu(h, r)[0], corpus_cider,
                         corpus_rouge_l, corpus_meteor)}
    scores = {}
    for name, raw in sets.items():
        if not native._all_ascii(*raw.values()):
            die("offline: the %s are not ASCII: the native route would not run" % name)
        out = {k: route(raw, *fns) for k, fns in routes.items()}
        if out["native"][0] != out["python"][0]:
            die("offline: %s: the native tokenizer's captions differ from the Python "
                "tokenizer's" % name)
        a, b = out["native"][1], out["python"][1]
        worst = max(float(np.max(np.abs(np.array(x, dtype=np.float64).ravel() -
                                        np.array(y, dtype=np.float64).ravel())))
                    for x, y in ((a["bleu"], b["bleu"]), (a["cider"][1], b["cider"][1]),
                                 (a["rouge"][1], b["rouge"][1]),
                                 (a["meteor"][1], b["meteor"][1]),
                                 ([a["cider"][0], a["rouge"][0], a["meteor"][0]],
                                  [b["cider"][0], b["rouge"][0], b["meteor"][0]])))
        if worst > 1e-10:
            die("offline: %s: the native scores differ from the Python scorers' by %.3e"
                % (name, worst))
        ms = {k: float(np.median([host_ms(lambda f=fns: route(raw, *f), iters=1)
                                  for _ in range(3)])) for k, fns in routes.items()}
        scores[name] = dict(ms=ms, worst=worst, cider=a["cider"][0], rouge=a["rouge"][0],
                            bleu4=a["bleu"][3], meteor=a["meteor"][0])
        log("offline [%s]: %d videos' %s scored on both routes: native %.3f ms, Python %.3f "
            "ms (median of 3, host clock: tokenize, BLEU, CIDEr, ROUGE-L, legacy METEOR); "
            "largest difference %.3e (limit 1e-10); CIDEr %.6f, ROUGE-L %.6f, Bleu_4 %.6f, "
            "METEOR %.6f" % (card, len(vids), name, ms["native"], ms["python"], worst,
                             a["cider"][0], a["rouge"][0], a["bleu"][3], a["meteor"][0]))
    log("offline [%s]: native library %s (built at its first use in this run; this call "
        "%.2f s)" % (card, os.path.basename(path), build_s))

    prep = {}
    with tempfile.TemporaryDirectory() as root:
        def prepare(n):
            ann = os.path.join(root, "videodatainfo_%d.json" % n)
            msrvtt_annotation(ann, n)
            out_dir = os.path.join(root, "MSRVTT_%d" % n)
            said = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                prepare_main(["--dataset", "MSRVTT", "--raw_path", ann, "--out_dir", out_dir])
            seconds = time.perf_counter() - t0
            with open(os.path.join(out_dir, "info_corpus.pkl"), "rb") as f:
                info_corpus = pickle.load(f)
            with open(os.path.join(out_dir, "refs.pkl"), "rb") as f:
                prep_refs = pickle.load(f)
            split = info_corpus["info"]["split"]
            sizes = tuple(len(split[k]) for k in ("train", "validate", "test"))
            n_train = n * PREP_SPLIT[0] // PREP_VIDEOS
            n_val = n * PREP_SPLIT[1] // PREP_VIDEOS
            if (sizes != (n_train, n_val, n - n_train - n_val)
                    or len(info_corpus["captions"]) != n or len(prep_refs) != n
                    or sum(map(len, info_corpus["captions"].values())) != n * PREP_CAPS
                    or set(info_corpus["pos_tags"]) != set(info_corpus["captions"])):
                die("offline: prepare_corpora on %d videos wrote splits %s, %d videos, %d refs"
                    % (n, sizes, len(info_corpus["captions"]), len(prep_refs)))
            return dict(videos=n, seconds=seconds, splits=sizes,
                        vocab=len(info_corpus["info"]["itow"]),
                        said=said.getvalue().strip().splitlines()[-1])

        probe = prepare(1000)
        projected = probe["seconds"] * PREP_VIDEOS / 1000
        n = PREP_VIDEOS if projected <= PREP_LIMIT_S else max(
            1000, int(PREP_VIDEOS * PREP_LIMIT_S / projected) // 100 * 100)
        prep = prepare(n)
    cut = "" if n == PREP_VIDEOS else (
        "; CUT from %d videos: the 1000-video run projected %.1f s > %.0f s"
        % (PREP_VIDEOS, projected, PREP_LIMIT_S))
    log("offline [%s]: prepare_corpora on an MSR-VTT-shaped annotation of %d videos x %d "
        "captions (splits %s): %.2f host seconds (the 1000-video run %.2f s)%s; %s" % (
            card, n, PREP_CAPS, prep["splits"], prep["seconds"], probe["seconds"], cut,
            prep["said"]))
    return dict(build_s=build_s, scores=scores, prepare=prep, probe=probe)


# the parallel phase: NACF at full width, dropout 0, global batch PAR_B; its
# ranks are fresh processes of tests/torch_port_dist_worker.py. The gates
# were set from PR 18's first card run of this phase, before these gates
# were: (a)'s losses read 4.1e-6 to 1.0e-5 of the single process, its
# BatchNorm statistics 3.2e-5
PAR_B, PAR_STEPS, PAR_TIMED = 64, 3, 5
PAR_OVER = dict(OVER, batch_size=PAR_B, hidden_dropout_prob=0.0, encoder_dropout=0.0)
PAR_LOSS_TOL = 1e-4   # relative, against the single-process step
PAR_BN_TOL = 1e-3     # BatchNorm running statistics, relative to their largest magnitude
PAR_GRAD_TOL = 5e-2   # a parameter's global gradient, relative to its norm or to 1e-3 of
#                       the largest parameter gradient's norm (tests/test_torch_port_cuda.py's)
PAR_VIDEOS, PAR_CAPS = 160, 2  # the cli and loop corpora (1 epoch, 3 steps of PAR_B)


def par_batches(cfg):
    """NACF batches of PAR_B videos whose second half has features 3x the
    first's: each rank's BatchNorm statistics differ from the global
    batch's."""
    import numpy as np

    out = []
    for s in range(PAR_STEPS + PAR_TIMED):
        b = train_batch(cfg, PAR_B, np.random.RandomState(100 + s))
        for ch in cfg.modality.lower():
            b["feats_%s" % ch][PAR_B // 2:] *= 3.0
        out.append(b)
    return out


def par_gaps(got, want, single_grads):
    """A rank's steps (the worker's ``steps`` results) against the single
    process's (``single_grads`` its gradients, ``want`` its variables after
    the steps): (loss gaps, worst gradient gap, worst weight gap, worst
    BatchNorm statistic gap)."""
    import numpy as np

    from torch_port_dist_worker import leaves

    losses = [m["total_loss"] for m in got["metrics"]]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])]
    grad_gap = 0.0
    for mine, ref in zip(got["grads"], single_grads):
        mine, ref = dict(leaves(mine)), dict(leaves(ref))
        floor = 1e-3 * max(np.linalg.norm(v) for v in ref.values())
        grad_gap = max([grad_gap] + [float(np.linalg.norm(mine[k] - v))
                                     / max(float(np.linalg.norm(v)), floor)
                                     for k, v in ref.items()])
    params = dict(leaves(got["variables"]["params"]))
    weight_gap = max(float(np.abs(params[k] - v).max())
                     for k, v in leaves(want["variables"]["params"]))
    stats = dict(leaves(got["variables"].get("batch_stats", {})))
    bn_gap = max([0.0] + [float(np.abs(stats[k] - v).max()) / max(float(np.abs(v).max()), 1.0)
                          for k, v in leaves(want["variables"].get("batch_stats", {}))])
    return loss_gaps, grad_gap, weight_gap, bn_gap


def parallel_phase(card):
    """Data and tensor parallelism at full width (NACF, d 512, V 10048,
    global batch PAR_B, dropout 0, bf16 kernels), against the single-process
    step on the whole batch run here; every rank a fresh process of
    tests/torch_port_dist_worker.py: (a) 2 ranks on the card over gloo
    (NCCL refuses two ranks on one device: probed), eager, PAR_STEPS steps:
    losses within PAR_LOSS_TOL, each parameter's global gradient within
    PAR_GRAD_TOL, BatchNorm statistics within PAR_BN_TOL, the ranks' weights
    bit for bit alike after every step (the worst weight gap printed: Adam
    moves a weight whose gradient is rounding noise by up to lr a step); (b)
    1 rank on NCCL, the step captured (jit=True) bit for bit its eager run,
    a replay's launches the single-process replay's with no collective
    issued from the host, then train_network_all_multihost for one epoch;
    (c) cli.train.main([... "--distributed"]) on 2 gloo ranks, one epoch:
    rank 0 alone validates and writes best.ckpt, which decodes here, and
    --resume raises; (d) data 1 x model 2 on 2 gloo ranks: each rank holds
    half of every TP parameter, held to the gates of (a). Returns the
    figures."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_port_dist_worker as worker

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.data.loader import get_loader
    from navc_tpu_torch.data.synthetic import make_synthetic_corpus, make_synthetic_feats
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.runtime.checkpoint import load_model_and_config
    from navc_tpu_torch.runtime.evaluate import Evaluator, run_eval

    cfg = default_config("NACF", **PAR_OVER)
    batches = par_batches(cfg)
    steps, timed = batches[:PAR_STEPS], batches[PAR_STEPS:]
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                        train=True)
    single = worker.single_steps(cfg, model, steps, timed=timed)
    want = dict(losses=[m["total_loss"] for m in single["metrics"]],
                variables=single["variables"])
    n_params = sum(p.numel() for p in model.parameters())
    del model
    res = {"single": dict(losses=want["losses"], eager_ms=float(np.median(single["ms"])),
                          launches=single["launches"][0])}
    root = tempfile.mkdtemp(prefix="navc_parallel_")
    try:
        def ranks(name, suites, world, backend, timeout=300, **inputs):
            t0 = time.perf_counter()
            wait = worker.start(suites, world, dict(inputs, device="cuda", backend=backend),
                                os.path.join(root, name), timeout=timeout)

            def waited():
                outs = wait()
                log("  [%s] %d ranks in %.1f s" % (name, world, time.perf_counter() - t0))
                return outs

            return waited

        # (a) and (d), two ranks on the card over gloo, timed alone
        outs = [o["steps"] for o in ranks("steps", "steps", 2, "gloo", steps=[
            dict(name=name, method="NACF", over=PAR_OVER, batches=steps, timed=timed, mesh=mesh)
            for name, mesh in (("dp", None), ("tp", {"data": 1, "model": 2}))])()]
        dp, tp = [o["dp"] for o in outs], [o["tp"] for o in outs]
        # (b) one rank on NCCL, alone (it times replays), then its loop
        base = default_config("NACF", **dict(PAR_OVER, epochs=1)).replace(
            teacher_path="", load_teacher_weights=False, with_teacher=False)
        corpus, refs = make_synthetic_corpus(base, n_videos=PAR_VIDEOS, n_caps=PAR_CAPS,
                                             vocab_size=base.vocab_size)
        feats = make_synthetic_feats(base, n_videos=PAR_VIDEOS, n_total_frames=ENTRY_FRAMES)
        (nccl,) = ranks("nccl", "nccl_step,loop", 1, "nccl",
                        nccl_step=dict(over=PAR_OVER, batches=steps),
                        loop=dict(root=root, corpus=corpus, refs=refs, feats=feats,
                                  loops=[("loop", base)]))()
        # NCCL's refusal and (c) the CLI, side by side
        data = os.path.join(root, "data", "MSRVTT")
        os.makedirs(data)
        for name, obj in (("info_corpus.pkl", corpus), ("refs.pkl", refs)):
            with open(os.path.join(data, name), "wb") as f:
                pickle.dump(obj, f)
        argv = ["--device", "cuda", "--dataset", "MSRVTT", "--method", "NACF", "--scope",
                "par", "--use_pallas", "--epochs", "1", "--batch_size", str(PAR_B),
                "--hidden_dropout_prob", "0", "--encoder_dropout", "0",
                "--n_total_frames", str(ENTRY_FRAMES),
                "--base_data_path", os.path.join(root, "data"),
                "--base_checkpoint_path", os.path.join(root, "experiments")]
        probe_wait = ranks("nccl_probe", "nccl_probe", 2, "nccl", timeout=60)
        cli = [o["loop"] for o in ranks("cli", "loop", 2, "gloo", loop=dict(
            root=root, corpus=corpus, refs=refs, feats=feats, loops=[], cli_argv=argv))()]
        try:
            probe = [o["nccl_probe"] for o in probe_wait()]
        except subprocess.TimeoutExpired:
            probe = [{"error": "no refusal within 60 s: killed"}] * 2

        # (a)
        if dp[1]["metrics"] != dp[0]["metrics"] or dp[1]["digests"] != dp[0]["digests"]:
            die("parallel (a): the ranks' losses or weights differ after a step")
        gaps, grad_gap, worst_p, worst_bn = par_gaps(dp[0], want, single["grads"])
        if max(gaps) > PAR_LOSS_TOL or grad_gap > PAR_GRAD_TOL or worst_bn > PAR_BN_TOL:
            die("parallel (a): loss gaps %s (limit %g), worst gradient gap %.3e (limit %g), "
                "BatchNorm %.3e (limit %g) against the single-process step"
                % (gaps, PAR_LOSS_TOL, grad_gap, PAR_GRAD_TOL, worst_bn, PAR_BN_TOL))
        if dp[0]["launches"][0] != single["launches"][0]:
            die("parallel (a): a rank's step launched %s, the single-process step %s"
                % (dp[0]["launches"][0], single["launches"][0]))
        losses = [m["total_loss"] for m in dp[0]["metrics"]]
        res["gloo 2 ranks"] = dict(
            losses=losses, loss_gaps=gaps, grad_gap=grad_gap, worst_weight_gap=worst_p,
            bn_gap=worst_bn, ms=float(np.median(dp[0]["ms"])), launches=dp[0]["launches"][0],
            collectives=dp[0]["collectives"][0])
        n = nccl["nccl_step"]
        log("parallel (a) [%s]: 2 ranks on one card over gloo, global batch %d (%d a rank), "
            "eager: losses %s (single process %s; gaps %s, limit %g), worst gradient gap "
            "%.3e (limit %g), BatchNorm statistics %.3e (limit %g), worst weight gap %.3e "
            "(not gated), the ranks bit for bit alike after every step; %.2f ms a step "
            "(median of %d, host clock) against %.2f eager and %.2f replayed in one process; "
            "a rank's step launches %s and makes %s collectives" % (
                card, PAR_B, PAR_B // 2, ["%.5f" % x for x in losses],
                ["%.5f" % x for x in want["losses"]], ["%.2e" % g for g in gaps],
                PAR_LOSS_TOL, grad_gap, PAR_GRAD_TOL, worst_bn, PAR_BN_TOL, worst_p,
                res["gloo 2 ranks"]["ms"], PAR_TIMED, res["single"]["eager_ms"],
                n["median ms"]["single"], dp[0]["launches"][0], dp[0]["collectives"][0]))
        log("parallel: NCCL with two ranks on one card: %s" % "; ".join(
            "rank %d %s" % (r, "refused (%s)" % p["error"] if p.get("refused")
                            else p.get("error", "no refusal: %s" % p.get("result")))
            for r, p in enumerate(probe)))
        res["nccl two ranks on one card"] = [p.get("error", "no refusal") for p in probe]

        # (b)
        if n["backend"] != "nccl" or n["graphs"] != 1 or n["replayed"] != n["eager"]:
            die("parallel (b): on %s, %d graphs, the captured step's losses %s, its eager "
                "run's %s" % (n["backend"], n["graphs"], n["replayed"], n["eager"]))
        gaps_b = [abs(a - b) / abs(b) for a, b in zip(n["replayed"], n["single"])]
        if max(gaps_b) > PAR_LOSS_TOL:
            die("parallel (b): loss gaps %s against the single-process step" % gaps_b)
        if n["replayed launches"] != n["single launches"] or n["replayed host collectives"] \
                or not n["gloo jit"].startswith("ValueError: gloo collectives cannot be"):
            die("parallel (b): a replay launched %s (the single-process replay %s) and "
                "issued %d collectives from the host; jit=True on gloo: %s" % (
                    n["replayed launches"], n["single launches"],
                    n["replayed host collectives"], n["gloo jit"]))
        loop = nccl["loop"]["loop"]
        if not (os.path.join(root, "loop", "best.ckpt") in loop["saved"]
                and loop["n_eval"] == 1 and np.isfinite(loop["train_curve"]).all()
                and loop["launches"].get("train_fwd", 0) >= 3 * 2):
            die("parallel (b): the NCCL loop gave %s" % loop)
        res["nccl 1 rank"] = dict(median_ms=n["median ms"], replay_launches=n["replayed launches"],
                                  loss_gaps=gaps_b, loop_s=loop["seconds"],
                                  loop_collectives=loop["collectives"],
                                  loop_train_curve=loop["train_curve"])
        log("parallel (b) [%s]: 1 rank on NCCL, the step captured: its %d steps bit for bit "
            "its eager run's (loss gaps to the single process %s); a replay launches %s (%d "
            "kernel launches, the single-process replay's) and issues no collective from the "
            "host; jit=True on a gloo group raises; replayed %.2f ms a step against %.2f "
            "single-process (median of 10, host clock); train_network_all_multihost, 1 "
            "epoch of %d videos: %.1f s, train loss %s, test %s, launches %s, host "
            "collectives %s (the first step's eager run and capture; the others replayed)" % (
                card, PAR_STEPS, ["%.2e" % g for g in gaps_b], n["replayed launches"],
                sum(n["replayed launches"].values()), n["median ms"]["replayed"],
                n["median ms"]["single"], PAR_VIDEOS, loop["seconds"], loop["train_curve"],
                {k: loop["test_res"][k] for k in ("Bleu_4", "METEOR", "CIDEr")},
                loop["launches"], loop["collectives"]))

        # (c)
        if cli[0]["cli"]["train_curve"] != cli[1]["cli"]["train_curve"] or \
                (cli[0]["cli"]["n_eval"], cli[1]["cli"]["n_eval"]) != (1, 0) or \
                cli[1]["cli"]["test_res"] is not None or \
                not all(c["resume"].startswith("NotImplementedError") for c in cli):
            die("parallel (c): cli.train --distributed gave %s" % cli)
        best = os.path.join(root, "experiments", "MSRVTT", "NACF", "par", "best.ckpt")
        if not os.path.exists(best):
            die("parallel (c): rank 0 wrote no best.ckpt")
        bmodel, bcfg, _ = load_model_and_config(best, device="cuda")
        loader = get_loader(bcfg, "test", corpus, feats)
        loader.dataset.set_references(refs)
        test = run_eval(bcfg, Evaluator(bcfg, bmodel), loader, loader.dataset.get_vocab())
        if not np.isfinite(test["CIDEr"]):
            die("parallel (c): best.ckpt scores %s here, %s in the run" % (
                test["CIDEr"], cli[0]["cli"]["test_res"]))
        res["cli"] = dict(train_curve=cli[0]["cli"]["train_curve"],
                          test={k: cli[0]["cli"]["test_res"][k] for k in ("Bleu_4", "CIDEr")})
        log("parallel (c) [%s]: cli.train.main([... --distributed]) on 2 gloo ranks, NACF 1 "
            "epoch of %d videos: train loss %s on both ranks, validation on rank 0 only, its "
            "best.ckpt loaded in one process decodes the test split: CIDEr %.4f (the run's "
            "%.4f); with --resume both ranks raise" % (
                card, PAR_VIDEOS, cli[0]["cli"]["train_curve"], test["CIDEr"],
                cli[0]["cli"]["test_res"]["CIDEr"]))

        # (d)
        if tp[0]["metrics"] != tp[1]["metrics"] or tp[0]["digests"] != tp[1]["digests"] or \
                tp[0]["shard_digests"] == tp[1]["shard_digests"]:
            die("parallel (d): the ranks' losses or weights differ, or their TP slices agree")
        for name, (shape, dim) in tp[0]["shards"].items():
            full = tp[0]["full_shapes"][name]
            if 2 * shape[dim] != full[dim] or \
                    shape[:dim] + shape[dim + 1:] != full[:dim] + full[dim + 1:]:
                die("parallel (d): %s holds %s of %s" % (name, shape, full))
        gaps_d, grad_gap_d, worst_pd, worst_bnd = par_gaps(tp[0], want, single["grads"])
        if len(tp[0]["shards"]) != 5 or max(gaps_d) > PAR_LOSS_TOL or \
                grad_gap_d > PAR_GRAD_TOL or worst_bnd > PAR_BN_TOL:
            die("parallel (d): %d TP parameters, loss gaps %s, gradient gap %.3e, BatchNorm "
                "%.3e" % (len(tp[0]["shards"]), gaps_d, grad_gap_d, worst_bnd))
        res["tp data 1 x model 2"] = dict(
            losses=[m["total_loss"] for m in tp[0]["metrics"]], loss_gaps=gaps_d,
            grad_gap=grad_gap_d, worst_weight_gap=worst_pd,
            shards={k: v[0] for k, v in tp[0]["shards"].items()},
            ms=float(np.median(tp[0]["ms"])), optimizer_numel=tp[0]["optimizer_numel"],
            model_numel=n_params)
        log("parallel (d) [%s]: data 1 x model 2 on 2 gloo ranks: TP slices %s (each rank "
            "half of each), the optimizer over %d of the model's %d parameters a rank; "
            "losses %s (gaps %s, limit %g), worst gradient gap %.3e (limit %g), BatchNorm "
            "%.3e, worst weight gap %.3e; %.2f ms a step (median of %d)" % (
                card, res["tp data 1 x model 2"]["shards"], tp[0]["optimizer_numel"],
                n_params, ["%.5f" % x for x in res["tp data 1 x model 2"]["losses"]],
                ["%.2e" % g for g in gaps_d], PAR_LOSS_TOL, grad_gap_d, PAR_GRAD_TOL,
                worst_bnd, worst_pd, res["tp data 1 x model 2"]["ms"], PAR_TIMED))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["launches_distributed_step"] = dp[0]["launches"][0]
    return res


# the extract phase: ResNet-101 (random init from a seed) on 224 x 224 frames
EXTRACT_FRAMES, EXTRACT_CPU, EXTRACT_VIDEOS, EXTRACT_PER_VIDEO = 32, 2, 2, 8
EXTRACT_TOL = 1e-3  # max |card - CPU| over max |CPU|, TF32 off


def extract_phase(card):
    """models/resnet.py's ResNet-101 (init_resnet, seed 0) through
    make_backbone on the card: EXTRACT_CPU frames against the CPU forward of
    the same weights (TF32 off: torch.backends.cudnn.allow_tf32 False;
    EXTRACT_TOL), frames/s at batch EXTRACT_FRAMES (host clock, numpy in and
    out, median of 5), and EXTRACT_VIDEOS videos x EXTRACT_PER_VIDEO frames
    of features through an NACF encode and decode (modality i, dim_i 2048,
    random weights): frames -> features -> captions. Numpy frames: the
    card's host may lack PIL and ffmpeg. Returns the figures."""
    import copy

    import numpy as np
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.decoding import make_nar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.models.resnet import RESNET_STAGES, init_resnet, make_backbone

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        die("extract: TF32 is allowed")
    t0 = time.perf_counter()
    cpu_model = init_resnet(torch.Generator().manual_seed(0), RESNET_STAGES[101])
    card_model = copy.deepcopy(cpu_model)
    backbone = make_backbone(card_model, batch_size=EXTRACT_FRAMES, device="cuda")
    init_s = time.perf_counter() - t0
    frames = np.random.RandomState(0).rand(EXTRACT_FRAMES, 224, 224, 3).astype(np.float32)
    got = backbone(frames[:EXTRACT_CPU])
    t0 = time.perf_counter()
    want = make_backbone(cpu_model, device="cpu")(frames[:EXTRACT_CPU])
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    if got.shape != (EXTRACT_CPU, 2048) or not err <= EXTRACT_TOL:
        die("extract: ResNet-101 on the card against the CPU: shape %s, max gap %.3e of the "
            "largest feature (limit %g)" % (got.shape, err, EXTRACT_TOL))
    backbone(frames)  # cuDNN picks its algorithms at this batch
    ms = [host_ms(lambda: backbone(frames), iters=1) for _ in range(5)]
    fps = EXTRACT_FRAMES / (float(np.median(ms)) / 1e3)
    # frames -> features -> captions
    clip = np.random.RandomState(1).rand(EXTRACT_VIDEOS * EXTRACT_PER_VIDEO, 224, 224,
                                         3).astype(np.float32)
    feats = backbone(clip).reshape(EXTRACT_VIDEOS, EXTRACT_PER_VIDEO, 2048)
    cfg = default_config("NACF", **dict(OVER, modality="i", dim_i=2048,
                                        n_frames=EXTRACT_PER_VIDEO))
    nacf = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    cat = torch.as_tensor(np.random.RandomState(2).randint(0, cfg.num_category,
                                                           (EXTRACT_VIDEOS, 1))).cuda()
    with torch.no_grad():
        enc = nacf.encode([torch.as_tensor(feats).cuda()])
        hyp = make_nar_generator(cfg, nacf)(enc, cat).cpu().numpy()
    if hyp.shape != (EXTRACT_VIDEOS, cfg.max_len) or hyp.min() < 0 or \
            hyp.max() >= cfg.vocab_size or not np.isfinite(feats).all():
        die("extract: captions of shape %s, ids %d..%d from features finite %s" % (
            hyp.shape, hyp.min(), hyp.max(), np.isfinite(feats).all()))
    log("extract [%s]: ResNet-101 (random init, seed 0) through make_backbone: %d frames "
        "224 x 224 on the card against the CPU forward of the same weights (%.1f s), TF32 "
        "off: max gap %.3e of the largest feature (limit %g); %.1f frames/s at batch %d "
        "(%.2f ms a batch, median of 5, host clock, numpy in and out); set-up %.1f s; %d "
        "videos x %d frames -> (%d, %d, 2048) features -> NACF (modality i, random "
        "weights) captions %s" % (
            card, EXTRACT_CPU, cpu_s, err, EXTRACT_TOL, fps, EXTRACT_FRAMES,
            float(np.median(ms)), init_s, EXTRACT_VIDEOS, EXTRACT_PER_VIDEO, EXTRACT_VIDEOS,
            EXTRACT_PER_VIDEO, hyp[:, :10].tolist()))
    return dict(max_rel_err=err, frames_per_s=fps, batch_ms=float(np.median(ms)),
                cpu_s=cpu_s, captions_shape=list(hyp.shape))


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit: its K1-K7, K1u "
                    "and K9-K12b kernels, weight-gradient reduction, NACF request, B=1024 ARB "
                    "decode, B=64 epoch and B=2048 train step are run through its own "
                    "wrappers in a second process and timed in turns with this tree's")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--switch", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.exit(serve_worker(args.worker))
    if args.switch:
        sys.exit(switch_worker(args.switch))
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

    # -- 1. build (the parent's worker builds its own kernels meanwhile) -----
    parent = Worker(args.parent) if args.parent else None
    t0 = time.perf_counter()
    logs = _build.build()
    log("build: %.1f s (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %s" % (k, "built" if v is not None else "cached") for k, v in logs.items())))
    for name, text in logs.items():
        for line in (text or "").splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                log("  ptxas %s: %s" % (name, line.strip()))

    # -- 2. models at full width, seeded random weights ---------------------
    over = OVER
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

    def k1_times(run, case, causal, n_head):
        """K1's device ms (a call issues ~10 launches: device_ms) and, given
        --parent, the parent's K1 through its own wrappers on the same
        operands, in turns (parent, this, this, parent)."""
        if parent is None:
            return dict(ms=device_ms(run))
        theirs = parent.load("fused_layer", case, n_head=n_head, causal=causal)["out"]
        err = hid_err(run(), theirs)
        if not err <= HID_TOL:
            die("the parent's fused_layer (%s) disagrees with this one: %.3e"
                % ("causal" if causal else "nar", err))
        del theirs
        p1, a1, a2, p2 = (parent.time("device"), device_ms(run), device_ms(run),
                          parent.time("device"))
        return dict(ms=(a1 + a2) / 2, parent_ms=(p1 + p2) / 2)

    # K1's 8 products as bf16 torch.matmul at their shapes (matmul_ms): the
    # N * L canvas rows (here the static features) by Wq, Wk, Wv, Wo_s, Wq_c,
    # Wo_c and Wi, the FFN activations by Wo2
    acts = torch.randn(n * l, inter, generator=seeded(8)).to(dev, torch.bfloat16)
    k1_mm = [(static.view(n * l, h), getattr(ops.layer, k)) for k in (
        "wq_s", "wk_s", "wv_s", "wo_s", "wq_c", "wo_c", "wi")] + [(acts, ops.layer.wo2)]
    k1_matmul_ms = device_ms(lambda: [torch.matmul(a, b.t()) for a, b in k1_mm])
    del acts, k1_mm

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
    if not (torch.equal(k1(), out_k1) and bool((out_k1[kp] == 0).all())):
        die("fused_layer: two calls differ, or a PAD row is not zero")
    real = int((~kp).sum())
    fl = layer_flops(real, real, n, le, h, inter)
    nb = layer_bytes(n, l, le, h, inter, n * l)
    t_nar = k1_times(k1, dict(raw=raw, static=static, kp=kp, ke=ke, ve=ve, w=vars(ops.layer),
                              lns=ops.ln_scale, lnb=ops.ln_bias), False, ops.n_head)
    rec_nar = record("fused_layer[nar]", err_nar, HID_TOL, t_nar["ms"],
                     cuda_ms(k1p, iters=5), fl, nb,
                     note="  matmul_ms %.4f; parent %s" % (
                         k1_matmul_ms, "%.4f ms" % t_nar["parent_ms"]
                         if "parent_ms" in t_nar else "not run"))
    rec_nar.update(matmul_ms=k1_matmul_ms, **{k: t_nar[k] for k in ("parent_ms",) if k in t_nar})

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
    if not (torch.equal(k1c(), out_k1c) and bool((out_k1c[t_kp] == 0).all())):
        die("fused_layer (causal): two calls differ, or a PAD row is not zero")
    t_real = int((~t_kp).sum())
    t_causal = k1_times(k1c, dict(raw=t_raw, static=t_static, kp=t_kp, ke=tke, ve=tve,
                                  w=vars(tops.layer), lns=tops.ln_scale, lnb=tops.ln_bias),
                        True, tops.n_head)
    rec_causal = record("fused_layer[causal]", err_causal, HID_TOL, t_causal["ms"],
                        cuda_ms(k1cp, iters=5), layer_flops(t_real, t_real, n, le, h, inter),
                        nb, note="  parent %s" % ("%.4f ms" % t_causal["parent_ms"]
                                                  if "parent_ms" in t_causal else "not run"))
    rec_nar["causal"] = dict(rec_causal, **{k: t_causal[k] for k in ("parent_ms",)
                                           if k in t_causal})

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
    if not k2_vs_k1 <= HID_TOL:
        die("K2 rows differ from K1 rows at the same positions: %.3e" % k2_vs_k1)
    # K2 beside bf16 torch.matmul of its 8 products at their shapes (matmul_ms:
    # the N * L canvas rows, here the static features; the N * K query rows;
    # FFN activations) and, given --parent, the parent's K2 through its own
    # wrappers, in turns (parent, this, this, parent)
    qx = static[:, :k_slots].reshape(n * k_slots, h)
    acts = torch.randn(n * k_slots, inter, generator=seeded(9)).to(dev, torch.bfloat16)
    k2_mm = [(static.view(n * l, h), ops.layer.wk_s), (static.view(n * l, h), ops.layer.wv_s)] + [
        (qx, getattr(ops.layer, k)) for k in ("wq_s", "wo_s", "wq_c", "wo_c", "wi")] + [
        (acts, ops.layer.wo2)]
    t_k2 = dict(matmul_ms=device_ms(lambda: [torch.matmul(a, b.t()) for a, b in k2_mm]))
    del qx, acts, k2_mm
    if parent is None:
        t_k2["ms"] = device_ms(k2)
    else:
        theirs = parent.load("fused_layer_qsub", dict(
            qidx=qidx, mrow=mrow, raw=m_raw, static=static, kp=m_kp, ke=ke, ve=ve,
            w=vars(ops.layer), lns=ops.ln_scale, lnb=ops.ln_bias), n_head=ops.n_head)["out"]
        err = hid_err(k2(), theirs)
        if not err <= HID_TOL:
            die("the parent's fused_layer_qsub disagrees with this one: %.3e" % err)
        del theirs
        p1, a1, a2, p2 = (parent.time("device"), device_ms(k2), device_ms(k2),
                          parent.time("device"))
        t_k2.update(ms=(a1 + a2) / 2, parent_ms=(p1 + p2) / 2)
    rec_k2 = record("fused_layer_qsub", err_k2, HID_TOL, t_k2["ms"],
                    cuda_ms(k2p, iters=5), fl2, nb2,
                    note="  rows vs K1 rows %.3e, %d of %d slots used; matmul_ms %.4f; "
                    "parent %s" % (k2_vs_k1, n_used, n * k_slots, t_k2["matmul_ms"],
                                   "%.4f ms" % t_k2["parent_ms"] if "parent_ms" in t_k2
                                   else "not run"))
    rec_k2.update((k, t_k2[k]) for k in ("matmul_ms", "parent_ms") if k in t_k2)

    # K1u, the unfolded form (float32 embedded rows, cross K/V projected in
    # the kernel) at K1's shape, NAR and causal: K11's launches at p = 0. No
    # path of navc_tpu or of the port calls it. Timed beside bf16
    # torch.matmul of its 10 products at their shapes (matmul_ms: the N * L
    # rows by Wq, Wk, Wv, Wo_s, Wq_c, Wo_c and Wi, the N * Le encoder rows by
    # Wk_c and Wv_c, the FFN activations by Wo2) and, given --parent, the
    # parent's K1u on the same operands in turns (parent, this, this, parent)
    x_u = torch.randn(n, l, h, generator=g).to(dev)
    enc_u = torch.repeat_interleave(enc, cfg.length_beam_size, 0)
    err_u, t_u = 0.0, {}
    for causal in (False, True):
        k1u = lambda: fused_layer_unfolded(x_u, enc_u, kp, ops.layer,  # noqa: E731
                                           ops.n_head, causal, torch.bfloat16)
        out_u = k1u()
        want_u = fused_layer_unfolded_plain(x_u, enc_u, kp, ops.layer, ops.n_head,
                                            causal, torch.bfloat16)
        torch.cuda.synchronize()
        e, sc, re, rs = scaled_err(out_u, want_u)
        what = "causal" if causal else "nar"
        if not (e <= TRAIN_TOL * sc and re <= TRAIN_RMS_TOL * rs):
            die("fused_layer_unfolded (%s) disagrees with its plain version: max err "
                "%.3e (scale %.3e), rms err %.3e (rms %.3e)" % (what, e, sc, re, rs))
        if not (torch.equal(k1u(), out_u) and bool((out_u[kp] == 0).all())):
            die("fused_layer_unfolded (%s): two calls differ, or a PAD row is not zero" % what)
        err_u = max(err_u, e)
        t = {}
        if parent is None:
            t["ms"] = device_ms(k1u)
        else:
            theirs = parent.load("fused_layer_unfolded", dict(
                x=x_u, enc=enc_u, kp=kp, w=vars(ops.layer)), n_head=ops.n_head,
                causal=causal)["out"]
            e, sc, re, rs = scaled_err(theirs, out_u)
            if not (e <= TRAIN_TOL * sc and re <= TRAIN_RMS_TOL * rs):
                die("the parent's fused_layer_unfolded (%s) disagrees with this one: %.3e"
                    % (what, e))
            del theirs
            p1, a1, a2, p2 = (parent.time("device"), device_ms(k1u), device_ms(k1u),
                              parent.time("device"))
            t.update(ms=(a1 + a2) / 2, parent_ms=(p1 + p2) / 2)
        t_u[causal] = t
        log("fused_layer_unfolded (%s) at N=%d, L=%d, Le=%d: kernel %.4f ms, parent %s"
            % (what, n, l, le, t["ms"], "%.4f ms (%.2fx faster)" % (
                t["parent_ms"], t["parent_ms"] / t["ms"]) if "parent_ms" in t else "not run"))
    x16 = x_u.view(n * l, h).to(torch.bfloat16)
    e16 = enc_u.view(n * le, h).to(torch.bfloat16)
    acts = torch.randn(n * l, inter, generator=seeded(10)).to(dev, torch.bfloat16)
    u_mm = [(x16, getattr(ops.layer, k)) for k in (
        "wq_s", "wk_s", "wv_s", "wo_s", "wq_c", "wo_c", "wi")] + [
        (e16, ops.layer.wk_c), (e16, ops.layer.wv_c), (acts, ops.layer.wo2)]
    u_matmul_ms = device_ms(lambda: [torch.matmul(a, b.t()) for a, b in u_mm])
    del x16, e16, acts, u_mm
    weights_b = (8 * h * h + 2 * h * inter) * 2 + (8 * h + inter + h) * 4
    rec_k1u = record(
        "fused_layer_unfolded", err_u, None, t_u[False]["ms"],
        cuda_ms(lambda: fused_layer_unfolded_plain(x_u, enc_u, kp, ops.layer,
                                                   ops.n_head, False, torch.bfloat16),
                iters=5),
        layer_flops(real, real, n, le, h, inter) + 2 * 2 * n * le * h * h,
        n * l * h * 4 + n * le * h * 4 + n * l + weights_b + n * l * h * 2,
        note="  (max_err: absolute, NAR and causal; tolerance %.0e of the largest "
        "|value| and %.0e of the rms; matmul_ms %.4f; causal %.4f ms; no path of navc_tpu "
        "reaches it: launches 0)" % (TRAIN_TOL, TRAIN_RMS_TOL, u_matmul_ms, t_u[True]["ms"]))
    rec_k1u.update(matmul_ms=u_matmul_ms, causal=t_u[True],
                   **{k: t_u[False][k] for k in ("parent_ms",) if k in t_u[False]})

    # K3 / K4 on the dense layer output (R = N * L rows), untied (the
    # model's projection), tied (a bias at 0.1) and with a bias ten times
    # the scores' scale. K4 asks for a random id on odd rows and for the
    # argmax on even ones: under the large bias a random id's probability
    # falls below float32's range, and those (< 1e-30) are left out.
    hid = out_k1.view(n * l, h)
    w16, wb = ops.proj_w, ops.proj_b
    r = hid.shape[0]
    scores = hid.float() @ w16.float().t()
    scale = float(scores.std())
    targets = torch.randint(0, v, (r,), generator=g).to(dev, torch.int32)
    p_err = g_err = 0.0
    for case, bias in (("untied", wb), ("tied", torch.randn(v, generator=g).to(dev) * 0.1),
                       ("large bias", torch.randn(v, generator=g).to(dev) * 10 * scale)):
        for rows in (r,) + SPARSE_ROWS:
            hh = hid[:rows]
            ids_k, maxp_k = project_argmax(hh, w16, bias)
            ids_p, maxp_p = project_argmax_plain(hh, w16, bias)
            top2 = (scores[:rows] if bias is None else scores[:rows] + bias).topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-3
            bad = int(((ids_k != ids_p) & clear).sum())
            if bad:
                die("project_argmax (%s, %d rows): %d ids disagree with the plain version "
                    "where the top-2 margin > 1e-3" % (case, rows, bad))
            p_err = max(p_err, float(((maxp_k - maxp_p).abs() / maxp_p).max()))
            if rows == r:
                near, dense_ids = int((~clear).sum()), ids_p
        tg = targets.clone()
        tg[::2] = dense_ids[::2]
        prob_k = project_gather_prob(hid, w16, tg, bias)
        prob_p = project_gather_prob_plain(hid, w16, tg, bias)
        ok = prob_p > 1e-30
        if int(ok.sum()) <= r // 2:
            die("project_gather_prob (%s): too few probabilities above 1e-30" % case)
        g_err = max(g_err, float(((prob_k - prob_p).abs() / prob_p)[ok].max()))
        log("project_argmax / project_gather_prob (%s): ids equal where the top-2 margin "
            "> 1e-3 at %s rows (%d of %d dense rows within 1e-3)"
            % (case, "/".join(map(str, (r,) + SPARSE_ROWS)), near, r))

    # K4 on the teacher's causal layer output, as the rescoring calls it
    t_hid = out_k1c.view(n * l, h)
    prob_k = project_gather_prob(t_hid, tops.proj_w, targets, tops.proj_b)
    prob_p = project_gather_prob_plain(t_hid, tops.proj_w, targets, tops.proj_b)
    g_err = max(g_err, float(((prob_k - prob_p).abs() / prob_p).max()))

    # times at the decode's row counts beside torch.matmul on the same bf16
    # operands and, given --parent, the parent commit's kernel in turns
    # (parent, this, this, parent)
    by_rows = {}
    for name, rows in [("project_argmax", rr) for rr in (r,) + SPARSE_ROWS] + [
            ("project_gather_prob", r)]:
        if name == "project_argmax":
            hh, ww, bb, tt = hid[:rows], w16, wb, None
            run = lambda: project_argmax(hh, ww, bb)  # noqa: E731
        else:
            hh, ww, bb, tt = t_hid, tops.proj_w, tops.proj_b, targets
            run = lambda: project_gather_prob(hh, ww, tt, bb)  # noqa: E731
        t = dict(library_ms=device_ms(lambda: torch.matmul(hh, ww.t())))
        if parent is None:
            t["ms"] = device_ms(run)
        else:
            got = parent.load(name, dict(h=hh, w=ww, bias=bb, targets=tt))["p"]
            want = run()
            torch.cuda.synchronize()
            want = want[1] if name == "project_argmax" else want
            if float(((got - want).abs() / want).max()) > 1e-4:
                die("the parent's %s disagrees with this one at %d rows" % (name, rows))
            p1, k1, k2, p2 = (parent.time("device"), device_ms(run), device_ms(run),
                              parent.time("device"))
            t.update(ms=(k1 + k2) / 2, parent_ms=(p1 + p2) / 2)
        by_rows[name, rows] = t
        log("%s at %d x %d x %d: kernel %.4f ms, torch.matmul %.4f ms (%.2fx), parent %s, "
            "bound %.4f ms" % (name, rows, h, v, t["ms"], t["library_ms"],
                              t["ms"] / t["library_ms"],
                              "%.4f ms (%.2fx faster)" % (t["parent_ms"], t["parent_ms"] / t["ms"])
                              if "parent_ms" in t else "not run",
                              bound(2 * rows * h * v, rows * h * 2 + v * h * 2 + rows * 8)[0]))
    fl3 = 2 * r * h * v
    nb3 = r * h * 2 + v * h * 2 + r * 8
    t3, t4 = by_rows["project_argmax", r], by_rows["project_gather_prob", r]
    rec_k3 = record("project_argmax", p_err, 1e-4, t3["ms"],
                    cuda_ms(lambda: project_argmax_plain(hid, w16, wb), iters=5),
                    fl3, nb3, lib_ms=t3["library_ms"],
                    note="  (max_err: max prob, relative, untied, tied and large bias)")
    rec_k3["by_rows"] = {str(rr): by_rows["project_argmax", rr] for rr in (r,) + SPARSE_ROWS}
    rec_k4 = record("project_gather_prob", g_err, 1e-4, t4["ms"],
                    cuda_ms(lambda: project_gather_prob_plain(
                        t_hid, tops.proj_w, targets, tops.proj_b), iters=5),
                    fl3, nb3 + r * 4, lib_ms=t4["library_ms"],
                    note="  (max_err: prob, relative, untied, tied and large bias)")
    for rec, t in ((rec_k3, t3), (rec_k4, t4)):
        if "parent_ms" in t:
            rec["parent_ms"] = t["parent_ms"]
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
    list(cap.map_stream([warm]))  # first use: the encodes' and the decode's capture
    eager_cap = StreamingCaptioner(cfg, model, (tcfg, teacher), depth=2, jit=False)
    list(eager_cap.map_stream([warm]))  # first use: cuBLAS handles, allocator
    torch.cuda.synchronize()
    eager_outs, eager_request = eager_cap.timed_stream(reqs)
    _build.reset_launches()
    outs, per_request = cap.timed_stream(reqs)
    launches = dict(_build.LAUNCHES)
    log("main path: %d requests x %d videos, %.2f ms per request (%.1f "
        "captions/s, host clock, depth 2; replayed CUDA graphs, eager route %.2f ms); "
        "launches %s" % (N_REQUESTS, N_VIDEOS, per_request * 1e3,
                         N_VIDEOS / per_request, eager_request * 1e3, launches))
    if not all(np.array_equal(a, b) for a, b in zip(outs, eager_outs)):
        die("main path: the replayed requests' tokens differ from the eager route's")
    del eager_cap
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
    if parent is not None:
        # the parent commit's request (its own models from the same seeds, its
        # own wrappers), this tree's in a worker as fresh as the parent's, and
        # this one in turns: parent, fresh, this, this, fresh, parent, three
        # times, 3 requests each (host clock, each ends in the tokens' copy)
        fresh = Worker(ROOT)
        case = dict(feats=[torch.as_tensor(f) for f in extra[0]], cat=torch.as_tensor(extra[1]))
        got = {w: w.load("nacf_decode", case, over=OVER, seed=0)["hyp"].cpu().numpy()
               for w in (parent, fresh)}
        decode = lambda: list(cap.map_stream([extra]))  # noqa: E731
        hyp = decode()[0]
        ms = {"this": [], "this, fresh process": [], "parent": []}
        for _ in range(3):
            ms["parent"].append(parent.time("host3"))
            ms["this, fresh process"].append(fresh.time("host3"))
            ms["this"] += [host_ms(decode), host_ms(decode)]
            ms["this, fresh process"].append(fresh.time("host3"))
            ms["parent"].append(parent.time("host3"))
        fresh.close()
        log("NACF request of %d videos in turns: %s ms per request; token agreement with "
            "this process's request: parent %.4f, fresh process %.4f" % (
                N_VIDEOS, "; ".join("%s %s (mean %.2f, median %.2f)" % (
                    who, " ".join("%.2f" % x for x in t), np.mean(t), np.median(t))
                    for who, t in ms.items()),
                float((got[parent] == hyp).mean()), float((got[fresh] == hyp).mean())))
        del decode

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
    arb_recs, arb_launches = arb_phases(tcfg, teacher, cpu_teacher, record, parent)

    # -- 5b. the captured decodes against the eager route -----------------------
    t0 = time.perf_counter()
    graph_results = graphs_phase(cfg, model, tcfg, teacher, cpu_teacher, card)
    log("graphs phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(graph_results)))

    # -- 5c. NAB and ARB2: the p = 0 step, the compiled step ------------------
    t0 = time.perf_counter()
    method_results = methods_phase()
    log("methods phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(method_results)))

    # -- 6. the training step ----------------------------------------------------
    t0 = time.perf_counter()
    train_recs, train_launches = train_phases(record, seeded, parent)
    log("training phases: %.1f s" % (time.perf_counter() - t0))

    # -- 6b. the compiled training step against the eager one -----------------
    t0 = time.perf_counter()
    train_graph_results = train_graphs_phase(card)
    log("train graphs phase: %.1f s; %s" % (time.perf_counter() - t0,
                                            json.dumps(train_graph_results)))

    # -- 7. the entry point: train_network_all at full width -------------------
    t0 = time.perf_counter()
    entry_point_phase()
    log("entry point phase: %.1f s" % (time.perf_counter() - t0))

    # -- 8. the inference entry points: translate, CaptionPipeline ------------
    t0 = time.perf_counter()
    inference = inference_phase(card)
    log("inference phase: %.1f s" % (time.perf_counter() - t0))

    # -- 8b. the four methods trained at full width, checks on their weights --
    t0 = time.perf_counter()
    learning_results = learning_phase(card)
    log("learning phase: %.1f s; %s" % (time.perf_counter() - t0,
                                        json.dumps(learning_results)))

    # -- 8c. navc_tpu's route switches, each in a fresh process ---------------
    t0 = time.perf_counter()
    switch_results = switches_phase(card)
    log("switches phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(switch_results)))

    # -- 8d. SelfMask: the p = 0 step, the compiled step, the beam -------------
    t0 = time.perf_counter()
    selfmask_results = selfmask_phase(card)
    log("selfmask phase: %.1f s; %s" % (time.perf_counter() - t0,
                                        json.dumps(selfmask_results)))

    # -- 8e. cfg.remat at B=2048 on both training routes ----------------------
    t0 = time.perf_counter()
    remat_results = remat_phase(card)
    log("remat phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(remat_results)))

    # -- 8f. the native scorer and corpus preparation on the card's host -------
    t0 = time.perf_counter()
    offline_results = offline_phase(card, inference)
    log("offline phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(offline_results)))

    # -- 8g. data and tensor parallelism over ranks on the card ----------------
    t0 = time.perf_counter()
    parallel_results = parallel_phase(card)
    log("parallel phase: %.1f s; %s" % (time.perf_counter() - t0,
                                        json.dumps(parallel_results)))

    # -- 8h. feature extraction: frames -> ResNet-101 -> NACF captions --------
    t0 = time.perf_counter()
    extract_results = extract_phase(card)
    log("extract phase: %.1f s; %s" % (time.perf_counter() - t0, json.dumps(extract_results)))

    # -- 9. results -----------------------------------------------------------
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
        entry("ce_fwd", "navc_tpu_torch/csrc/vocab_fused.cu",
              "navc_tpu/ops/vocab_ce.py:118", train_recs["ce_fwd"], train_launches),
        entry("ce_bwd_dh", "navc_tpu_torch/csrc/vocab_ce.cu",
              "navc_tpu/ops/vocab_ce.py:152", train_recs["ce_bwd_dh"], train_launches),
        entry("ce_bwd_dw", "navc_tpu_torch/csrc/vocab_ce.cu",
              "navc_tpu/ops/vocab_ce.py:152", train_recs["ce_bwd_dw"], train_launches),
        dict(entry("fused_layer_unfolded", "navc_tpu_torch/csrc/fused_layer_train.cu",
                   "navc_tpu/ops/fused_layer.py:303", rec_k1u),
             note="no path of navc_tpu reaches the unfolded form (its decodes pass "
             "static=, which selects :289); held against its plain version only"),
    ]
    remat_on = remat_results["fused"]["remat on"]["replayed"]["launches"]
    for k in kernels:  # launches on each decode of the graphs phase, under each switch
        k["launches_by_path"] = {case: graph_results[case]["launches"].get(k["name"], 0)
                                 for case, *_ in GRAPH_CASES}
        k["launches_by_switch"] = {case: switch_results[case]["launches"].get(k["name"], 0)
                                   for case, *_ in SWITCH_CASES}
        k["launches_remat_step"] = remat_on.get(k["name"], 0)  # NACF at B=2048, remat on
        # one rank's step of the 2-rank gloo run (NACF, global batch PAR_B)
        k["launches_distributed_step"] = parallel_results["launches_distributed_step"].get(
            k["name"], 0)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
