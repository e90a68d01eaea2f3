"""One rank of the port's process groups (not a test module), and the
launcher of such ranks, shared by the tests and chip_smoke.py's
``parallel`` phase.

    python tests/torch_port_dist_worker.py SUITES RANK WORLD PORT WORKDIR

joins a group of WORLD ranks at 127.0.0.1:PORT through the ``NAVC_*``
variables (``parallel.initialize``), reads ``WORKDIR/inputs.pkl`` (written
by ``start``: ``device``, optionally ``backend``, and each suite's cases),
runs the suites (comma-separated) in turn and pickles {suite: results} to
``WORKDIR/out_RANK.pkl``. It imports torch and navc_tpu_torch only; the
callers hold its results against navc_tpu and the port's single-process
runs (``single_steps``).

Suites:
  * ``steps``: training steps over global batches (``cases``), each rank
    stepping its rows (``shard_batch``) on the case's mesh, eagerly: per
    step the metrics, the kernel launches and collectives, a digest of the
    model's parameters and running statistics and one of the rank's TP
    slices, and on rank 0 the global gradient (the all-reduced one, TP
    slices all-gathered into full tensors) as a flax tree; after the steps
    the weights (gathered) as a flax tree and the TP slices' shapes; then
    the case's ``timed`` batches, each step's ms on the host clock;
  * ``sweep``: NAB's NAR decode of a global batch, each rank decoding its
    rows (``generate_sharded``);
  * ``loop``: ``train_network_all_multihost`` for each of ``loops`` (name,
    config): its curve, validations, the save calls each rank made, its
    launches, host collectives and seconds; then, given ``cli_argv``,
    ``cli.train.main([... "--distributed"])``, with and without
    ``--resume``;
  * ``nccl_step`` (the card, NCCL): the step captured (``jit=True``) and
    eager from the same weights on the rank's rows, the single-process
    step captured on the whole batch; a replay's launches and the
    collectives the host issued during it; ms of replays; ``jit=True`` on a
    gloo group;
  * ``nccl_probe``: one all-reduce, and the error NCCL raises for it
    (two ranks on one card: "Duplicate GPU detected").
"""

import contextlib
import copy
import hashlib
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def start(suites, world, inputs, workdir, timeout=240):
    """Start ``world`` ranks of this script running ``suites`` on
    ``inputs`` in ``workdir``; returns ``wait()``, which waits for them (at
    most ``timeout`` seconds from the start, then kills them and raises
    ``subprocess.TimeoutExpired``) and returns each rank's results, in rank
    order."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, "log_%d.txt" % r), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suites, str(r), str(world),
                 str(port), workdir], stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout

    def wait():
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        logs = []
        for r, p in enumerate(procs):
            with open(os.path.join(workdir, "log_%d.txt" % r)) as f:
                logs.append(f.read())
            assert p.returncode == 0, "rank %d exited %s:\n%s" % (r, p.returncode, logs[-1][-6000:])
        outs = []
        for r in range(world):
            with open(os.path.join(workdir, "out_%d.pkl" % r), "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return wait


@contextlib.contextmanager
def grads_before_step(tree_of):
    """Within the block every ``optim.step`` first keeps ``tree_of()`` (the
    step's gradient) in the list the block is given."""
    from navc_tpu_torch.runtime import optim

    kept, real = [], optim.step

    def keep_then_step(cfg, opt):
        kept.append(tree_of())
        real(cfg, opt)

    optim.step = keep_then_step
    try:
        yield kept
    finally:
        optim.step = real


def grad_tree(model, sharded=None):
    """The step's gradient of every parameter of ``model`` as a flax tree:
    its ``.grad``, or for a TP parameter of ``sharded`` its slices'
    gradients all-gathered over the 'model' group (a collective)."""
    import torch

    from navc_tpu_torch.convert import export_flax_variables
    from navc_tpu_torch.parallel import distributed as D

    full = {id(s.full): s for s in sharded.shards} if sharded else {}
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads.parameters()):
            s = full.get(id(p))
            if s is None:
                g.copy_(p.grad)
            else:
                g.copy_(torch.cat(list(D.all_gather(s.shard.grad, sharded.mesh.model_group)),
                                  s.dim))
    return export_flax_variables(grads)["params"]


def leaves(tree, prefix=""):
    """(path, float64 array) of each leaf of a flax tree."""
    import numpy as np

    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v, np.float64)


def _digest(tensors):
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _counted(fn):
    """fn()'s result, and the kernel launches and collectives it made."""
    from navc_tpu_torch.ops import _build
    from navc_tpu_torch.parallel import distributed as D

    _build.reset_launches()
    before = dict(D.COLLECTIVES)
    out = fn()
    launches = {k: n for k, n in _build.LAUNCHES.items() if n}
    return out, launches, {k: n - before.get(k, 0) for k, n in D.COLLECTIVES.items()
                           if n != before.get(k, 0)}


def _timed(step, batches, device, seed=100):
    """ms of each step over ``batches`` (host clock, each ending in the
    loss's copy)."""
    import torch

    ms = []
    for i, b in enumerate(batches):
        _sync(device)
        t0 = time.perf_counter()
        float(step(b, torch.Generator().manual_seed(seed + i))["total_loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def single_steps(cfg, model, batches, timed=()):
    """The port's single-process eager step over whole ``batches`` from
    ``model``'s weights: per step the metrics, the gradient (a flax tree),
    the launches; the weights after the steps (a flax tree); then ms of
    each ``timed`` batch's step."""
    import torch

    from navc_tpu_torch.convert import export_flax_variables
    from navc_tpu_torch.runtime.train_step import create_train_state, make_train_step

    step = make_train_step(cfg, model, create_train_state(cfg, model).optimizer, jit=False)
    out = {"metrics": [], "launches": []}
    with grads_before_step(lambda: grad_tree(model)) as grads:
        for i, b in enumerate(batches):
            metrics, launches, _ = _counted(
                lambda: step(b, torch.Generator().manual_seed(7 + i)))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["launches"].append(launches)
    out["grads"] = grads
    out["variables"] = export_flax_variables(model)
    out["ms"] = _timed(step, timed, next(model.parameters()).device)
    return out


def run_steps(case, device):
    import torch

    from navc_tpu_torch import parallel
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.convert import export_flax_variables, load_flax_variables
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    from navc_tpu_torch.runtime.train_step import create_train_state, make_sharded_train_step

    cfg = default_config(case["method"], **case["over"])
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0),
                        train=True)
    if case.get("variables") is not None:
        load_flax_variables(model, case["variables"])
    mesh = make_mesh(case.get("mesh"))
    sharded = shard_params(model, mesh)
    state = create_train_state(cfg, model, sharded.parameters())
    step = make_sharded_train_step(cfg, model, state.optimizer, sharded, jit=False)
    primary = parallel.process_index() == 0
    out = {"metrics": [], "launches": [], "collectives": [], "digests": [],
           "shard_digests": []}
    with grads_before_step(lambda: grad_tree(model, sharded)) as grads:
        for i, batch in enumerate(case["batches"]):
            metrics, launches, collectives = _counted(lambda: step(
                shard_batch(batch, mesh), torch.Generator().manual_seed(7 + i)))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["launches"].append(launches)
            out["collectives"].append(collectives)
            out["digests"].append(_digest(t for _, t in sorted(model.state_dict().items())))
            out["shard_digests"].append(_digest(s.shard for s in sharded.shards))
            if not primary:  # the global gradient is alike on every rank
                del grads[:]
    out["grads"] = grads
    out["shards"] = {s.name: (tuple(s.shard.shape), s.dim) for s in sharded.shards}
    out["full_shapes"] = {s.name: tuple(s.full.shape) for s in sharded.shards}
    out["optimizer_shapes"] = sorted(tuple(p.shape) for g in state.optimizer.param_groups
                                     for p in g["params"])
    out["optimizer_numel"] = sum(p.numel() for p in sharded.parameters())
    sharded.gather()
    out["variables"] = export_flax_variables(model)
    out["ms"] = _timed(step, [shard_batch(b, mesh) for b in case.get("timed", ())], device)
    return out


def run_sweep(case, device):
    import torch

    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.convert import load_flax_variables
    from navc_tpu_torch.decoding import make_nar_generator
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.parallel.mesh import generate_sharded, make_mesh

    cfg = default_config(case["method"], **case["over"])
    model = load_flax_variables(build_model(cfg, device=device), case["variables"])
    feats = [torch.from_numpy(f).to(device) for f in case["feats"]]
    with torch.no_grad():
        enc = model.encode(feats)
        gen = make_nar_generator(cfg, model)
        hyp = generate_sharded(gen, make_mesh(), enc)
    return {"tokens": hyp.cpu().numpy()}


def run_loop(inputs, device):
    from navc_tpu_torch.cli import train as cli_train
    from navc_tpu_torch.runtime import distributed_loop, loop

    saved = []
    real_save = loop.save_checkpoint

    def recording_save(state, filepath, filename="checkpoint.ckpt"):
        saved.append(os.path.join(filepath, filename))
        return real_save(state, filepath, filename)

    out = {}
    loop.save_checkpoint = recording_save
    try:
        for name, cfg in inputs["loops"]:
            del saved[:]
            t0 = time.perf_counter()
            res, launches, collectives = _counted(
                lambda: distributed_loop.train_network_all_multihost(
                    cfg, os.path.join(inputs["root"], name), info_corpus=inputs["corpus"],
                    references=inputs["refs"], in_memory_feats=inputs["feats"],
                    device=device, verbose=False))
            out[name] = {"train_curve": res["train_curve"], "n_eval": len(res["history"]),
                         "saved": list(saved), "test_res": res.get("test_res"),
                         "history": res["history"], "launches": launches,
                         "collectives": collectives, "seconds": time.perf_counter() - t0}
    finally:
        loop.save_checkpoint = real_save
    argv = inputs.get("cli_argv")
    if argv:
        res = cli_train.main(argv + ["--distributed"], in_memory_feats=inputs["feats"])
        out["cli"] = {"train_curve": res["train_curve"], "n_eval": len(res["history"]),
                      "test_res": res.get("test_res")}
        try:
            cli_train.main(argv + ["--distributed", "--resume"], in_memory_feats=inputs["feats"])
            out["resume"] = "no error"
        except NotImplementedError as e:
            out["resume"] = "NotImplementedError: %s" % e
    return out


def run_nccl_step(inputs):
    import numpy as np
    import torch

    from navc_tpu_torch import parallel
    from navc_tpu_torch.config import default_config
    from navc_tpu_torch.models import build_model
    from navc_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch, shard_params
    from navc_tpu_torch.runtime.train_step import (create_train_state,
                                                   make_sharded_train_step, make_train_step)

    cfg = default_config("NACF", **inputs["over"])
    mesh = make_mesh()

    def trainer(jit, m):
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                            train=True)
        if m is None:
            return make_train_step(cfg, model, create_train_state(cfg, model).optimizer,
                                   jit=jit)
        sharded = shard_params(model, m)
        state = create_train_state(cfg, model, sharded.parameters())
        return make_sharded_train_step(cfg, model, state.optimizer, sharded, jit=jit)

    out = {"backend": mesh.backend}
    steps = {"eager": trainer(False, mesh), "replayed": trainer(True, mesh),
             "single": trainer(True, None)}
    rows = {"eager": lambda b: shard_batch(b, mesh), "replayed": lambda b: shard_batch(b, mesh),
            "single": lambda b: b}
    for name, step in steps.items():
        out[name] = [float(step(rows[name](b), torch.Generator().manual_seed(i))["total_loss"])
                     for i, b in enumerate(inputs["batches"])]
    for name in ("replayed", "single"):
        b = rows[name](inputs["batches"][0])
        _, launches, collectives = _counted(
            lambda: steps[name](b, torch.Generator().manual_seed(9)))
        torch.cuda.synchronize()
        out[name + " launches"] = launches
        out[name + " host collectives"] = sum(collectives.values())
    out["graphs"] = len(steps["replayed"].jitted.graphs)
    ms = {"replayed": [], "single": []}
    for _ in range(10):  # in turns
        for name in ms:
            ms[name] += _timed(steps[name], [rows[name](inputs["batches"][1])], "cuda")
    out["median ms"] = {k: float(np.median(v)) for k, v in ms.items()}
    world = parallel.process_count()
    gloo = torch.distributed.new_group(list(range(world)), backend="gloo")
    try:
        trainer(True, Mesh(world, 1, parallel.process_index(), gloo, gloo))
        out["gloo jit"] = "no error"
    except ValueError as e:
        out["gloo jit"] = "ValueError: %s" % e
    return out


def run_nccl_probe():
    import torch

    from navc_tpu_torch.parallel import distributed as D

    try:
        t = D.all_reduce_(torch.ones(4, device="cuda"))
        torch.cuda.synchronize()
        return {"refused": False, "result": t.tolist()}
    except Exception as e:  # the refusal is what this suite looks for
        return {"refused": "Duplicate GPU" in str(e), "error": str(e).strip()[-400:]}


def main():
    suites, rank, world, port, workdir = sys.argv[1:6]
    os.environ.update(NAVC_COORDINATOR="127.0.0.1:%s" % port, NAVC_NUM_PROCESSES=world,
                      NAVC_PROCESS_ID=rank)
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from navc_tpu_torch import parallel

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    device = inputs["device"]
    parallel.initialize(backend=inputs.get("backend"), device=device)
    assert parallel.process_count() == int(world) and parallel.process_index() == int(rank)
    out = {}
    try:
        for suite in suites.split(","):
            if suite == "steps":
                out[suite] = {c["name"]: run_steps(c, device) for c in inputs["steps"]}
            elif suite == "sweep":
                out[suite] = {c["name"]: run_sweep(c, device) for c in inputs["sweep"]}
            elif suite == "loop":
                out[suite] = run_loop(inputs["loop"], device)
            elif suite == "nccl_step":
                out[suite] = run_nccl_step(inputs["nccl_step"])
            elif suite == "nccl_probe":
                out[suite] = run_nccl_probe()
            else:
                raise ValueError("unknown suite %r" % suite)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(workdir, "out_%s.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    if "nccl_probe" in out:
        os._exit(0)  # a communicator that failed its set-up cannot be torn down
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
