"""Multi-rank training orchestration.

Port of navc_tpu/runtime/distributed_loop.py, the counterpart of
``loop.train_network_all`` across ranks (reference misc/run.py:272-359 has
no distributed mode): every rank runs its step over its part of the global
batch on a ('data', 'model') mesh (``parallel.mesh``); each rank loads its
'data' coordinate's shard of every epoch (wrap-padded strided split, so the
ranks' step counts stay in lockstep); validation, checkpoints, the CSV log
and the k-best queue are rank 0's, with the early-stop decision broadcast
so every rank leaves the epoch loop together.

Call ``navc_tpu_torch.parallel.initialize(...)`` first, on every rank, then
call this as ``train_network_all``. On an NCCL group the step is the
compiled one (its collectives captured in its CUDA graph); gloo collectives
cannot be captured, so on a gloo group it runs eagerly.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..config import Config
from ..data.loader import get_loader
from ..models import build_model
from ..parallel import distributed as D
from ..parallel.mesh import make_mesh, shard_params
from .evaluate import Evaluator
from .logger import CsvLogger, KBestQueue
from .loop import (METRIC_FIELDS, checkpoint_of, eval_due, final_test, run_train_epoch,
                   save_epoch, validate, warm_start)
from .optim import LrSchedule
from .train_step import create_train_state, make_sharded_train_step


def train_network_all_multihost(cfg: Config, workdir: Optional[str] = None,
                                info_corpus=None, references=None,
                                in_memory_feats=None, verbose: bool = True,
                                device="cuda") -> Dict[str, Any]:
    """Training across the process group's ranks, each on its own device
    (``parallel.rank_device``; the card unless the caller asks for the
    CPU). Returns navc_tpu's dict on every rank: 'state', 'history' (rank
    0's validations), 'train_curve' (the global train loss per epoch, alike
    on every rank), and on rank 0 'best_res' and 'test_res'."""
    dev = D.rank_device(device)
    primary = D.is_primary()
    workdir = workdir or cfg.checkpoint_path or "./experiments/run"
    if primary:
        os.makedirs(workdir, exist_ok=True)
    cfg = cfg.replace(checkpoint_path=workdir)

    mesh = make_mesh(dict(cfg.mesh_shape) if cfg.mesh_shape else None)
    assert cfg.batch_size % mesh.data == 0, \
        "global batch %d must divide across %d 'data' ranks" % (cfg.batch_size, mesh.data)
    jit = mesh.backend != "gloo"
    if verbose and primary:
        print("mesh data=%d model=%d, %s backend: the step %s" % (
            mesh.data, mesh.model, mesh.backend, "captured (jit=True)" if jit
            else "eager (jit=False: gloo collectives cannot be captured)"))

    # the same seed on every rank: the same initial weights; the warm starts
    # on every rank keep them alike (the rescoring teacher is rank 0's: it
    # serves the validation only)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed),
                        train=True)
    teacher_model, teacher_cfg = warm_start(cfg, model, dev, verbose and primary,
                                            rescorer=primary)

    sharded = shard_params(model, mesh)
    state = create_train_state(cfg, model, sharded.parameters())
    train_step = make_sharded_train_step(cfg, model, state.optimizer, sharded, jit=jit)
    lr_schedule = LrSchedule.from_config(cfg)

    loader_kw = dict(info_corpus=info_corpus, in_memory_feats=in_memory_feats)
    train_loader = get_loader(cfg, "train", host_shard=True, mesh=mesh,
                              batch_size=cfg.batch_size // mesh.data, **loader_kw)
    # validation runs on rank 0 alone, over the whole split: no collective
    vali_loader = get_loader(cfg, "validate", **loader_kw) if primary else None
    if primary and references is not None:
        vali_loader.dataset.set_references(references)
    vocab = vali_loader.dataset.get_vocab() if primary else None

    logger = CsvLogger(filepath=workdir, filename="trainning_record.csv",
                       fieldsnames=["epoch", "train_loss"] + METRIC_FIELDS) \
        if primary else None
    best_model = KBestQueue(k_best_model=cfg.k_best_model,
                            folder_path=os.path.join(workdir, "tmp_models"),
                            standard=cfg.standard) if primary else None
    evaluator = Evaluator(cfg, model, teacher_cfg, teacher_model) if primary else None
    generator = torch.Generator().manual_seed(cfg.seed + 1)
    flag_device = dev if mesh.backend == "nccl" else "cpu"

    history = []
    train_curve = []  # the global train loss per epoch: alike on every rank
    for epoch in range(cfg.epochs):
        train_loader.dataset.shuffle()  # the lockstep stream: alike on every rank
        state, train_info = run_train_epoch(
            cfg, train_step, state, train_loader, lr_schedule, generator,
            logger.write_text if (primary and verbose) else None)
        lr_schedule.epoch_update()
        train_curve.append(float(train_info.get("total_loss", 0.0)))

        keep = True
        if eval_due(cfg, epoch):
            # the TP slices into full weights: a collective, so every rank
            # runs it, not only rank 0 (navc_tpu distributed_loop.py:146-148)
            sharded.gather()
            if primary:
                res = validate(cfg, evaluator, vali_loader, vocab, epoch, train_info, logger)
                history.append(res)
                keep = save_epoch(cfg, workdir, best_model, logger, verbose, checkpoint_of(
                    cfg, model, state, lr_schedule, epoch, res))
            # every rank takes the same branch out of the epoch loop
            keep = D.broadcast_flag(keep, flag_device)
            if not keep:
                break
        D.barrier()

    out: Dict[str, Any] = {"state": state, "history": history,
                           "train_curve": train_curve}
    if primary and history:
        out["best_res"] = best_model.best_res

    if not cfg.no_test:
        # the final test evaluation (reference run.py:349-356): the
        # collective gather first, then rank 0's decode as above
        sharded.gather()
        if primary:
            test_loader = get_loader(cfg, "test", **loader_kw)
            if references is not None:
                test_loader.dataset.set_references(references)
            out["test_res"] = final_test(cfg, workdir, dev, best_model, evaluator, teacher_cfg,
                                         teacher_model, test_loader, vocab)
        D.barrier()
    return out
