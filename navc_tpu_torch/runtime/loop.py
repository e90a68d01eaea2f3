"""Training orchestration (port of navc_tpu/runtime/loop.py, reference
misc/run.py train_network_all :272-359 and run_train :249-269).

``run_train_epoch``: the lr is set per step from the schedule (on the card
a fill of the optimizer's lr tensor, which the captured step reads); the
metrics of every step stay on the device until the epoch ends and are read
in one copy, so the host queues step n + 1 while the card runs step n.

``train_network_all``: pretrained and teacher warm starts, the rescoring
teacher, per-epoch shuffle -> train -> lr decay -> validation decode and
scoring -> checkpoint / k-best / early stop, then the test evaluation of
the best checkpoint; ``resume`` continues from the rolling
``checkpoint.ckpt``. Init draws from ``torch.Generator().manual_seed(
cfg.seed)``, dropout from a generator seeded with ``cfg.seed + 1``. The
rolling checkpoint also keeps the train data's numpy RNG and the dropout
generator's state, so a resumed run continues the straight run's streams.
The step is the compiled one (``make_train_step(..., jit=True)``: a CUDA
graph per batch signature on the card); every weight and optimizer state is
loaded (warm starts, ``resume``) before its first call, which captures it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..convert import load_flax_variables
from ..data.loader import get_loader
from ..device import resolve_device
from ..models import build_model
from .checkpoint import (load_checkpoint, load_model_and_config,
                         load_satisfied_weights, save_checkpoint, to_torch)
from .evaluate import Evaluator, run_eval
from .logger import AverageMeter, CsvLogger, KBestQueue
from .optim import LrSchedule, set_learning_rate
from .summary import SummaryWriter
from .train_step import TrainState, create_train_state, make_train_step

METRIC_FIELDS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                 "METEOR", "ROUGE_L", "CIDEr", "Sum"]


def run_train_epoch(cfg, train_step, state: TrainState, batches: Iterable[Dict],
                    lr_schedule: LrSchedule, generator: torch.Generator,
                    log: Optional[Callable[[str], None]] = None
                    ) -> Tuple[TrainState, Dict[str, float]]:
    """Run ``train_step`` over ``batches`` (dicts of numpy arrays); returns
    (state, info) with navc_tpu's info keys: total_loss, lang_loss,
    length_loss, word_acc0/1, perplexity."""
    del cfg  # kept for navc_tpu's signature
    pending = []
    for batch in batches:
        set_learning_rate(state.optimizer, lr_schedule.step_lr())
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        pending.append(train_step(arrays, generator))
        state.step += 1

    meters: Dict[str, AverageMeter] = {}
    if pending:
        keys = sorted(pending[0])
        table = torch.stack([torch.stack([m[k].to(torch.float32) for k in keys])
                             for m in pending]).cpu().tolist()
        for row in table:
            metrics = dict(zip(keys, row))
            n = metrics["num_samples"]
            for name in ("total_loss", "lang_loss", "length_loss"):
                if name in metrics:
                    meters.setdefault(name, AverageMeter()).update(metrics[name], n)
            for j in range(2):
                ck, nk = "word_acc%d_correct" % j, "word_acc%d_count" % j
                if ck in metrics:
                    meters.setdefault("word_acc%d" % j, AverageMeter()).update(
                        metrics[ck], metrics[nk], multiply=False)
            if "ppl_sum" in metrics:
                meters.setdefault("perplexity_ce", AverageMeter()).update(
                    metrics["ppl_sum"], metrics["ppl_count"], multiply=False)

    info = {k: m.avg for k, m in meters.items()}
    if "perplexity_ce" in info:
        info["perplexity"] = float(np.exp(min(info.pop("perplexity_ce"), 50.0)))
    if log is not None:
        log("\t".join("%10s: %05.3f" % (k, v) for k, v in info.items()))
    return state, info


def _variables(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    out = {"params": ckpt["params"]}
    if ckpt.get("batch_stats"):
        out["batch_stats"] = ckpt["batch_stats"]
    return out


def _require(path: str, what: str) -> None:
    # a configured path that does not exist is fatal, like the reference's
    # asserts (opts.py:208): training from random init would not be the
    # configured experiment
    if not os.path.exists(path):
        raise FileNotFoundError("%s not found: %s" % (what, path))


def train_network_all(cfg: Config, workdir: Optional[str] = None,
                      info_corpus=None, references=None, in_memory_feats=None,
                      verbose: bool = True, resume: bool = False,
                      device="cuda") -> Dict[str, Any]:
    """End-to-end training on ``device`` (the card unless the caller asks
    for the CPU); returns {'model', 'state', 'history', 'best_res',
    'test_res'}."""
    dev = resolve_device(device)
    workdir = workdir or cfg.checkpoint_path or "./experiments/run"
    os.makedirs(workdir, exist_ok=True)
    cfg = cfg.replace(checkpoint_path=workdir)

    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(cfg.seed),
                        train=True)
    if cfg.pretrained_path:  # reference train.py:85-87
        _require(cfg.pretrained_path, "pretrained_path")
        load_flax_variables(model, _variables(load_checkpoint(cfg.pretrained_path)))

    # teacher warm start + rescoring teacher (reference run.py:274-291)
    teacher_model, teacher_cfg = None, None
    if cfg.load_teacher_weights and cfg.teacher_path:
        _require(cfg.teacher_path, "teacher_path")
        load_satisfied_weights(model, cfg.teacher_path, verbose=verbose)
    if cfg.with_teacher and cfg.method in ("NAB", "NACF") and cfg.teacher_path:
        _require(cfg.teacher_path, "teacher_path")
        teacher_model, teacher_cfg, _ = load_model_and_config(cfg.teacher_path, device=dev)

    state = create_train_state(cfg, model)
    lr_schedule = LrSchedule.from_config(cfg)

    loader_kw = dict(info_corpus=info_corpus, in_memory_feats=in_memory_feats)
    train_loader = get_loader(cfg, "train", **loader_kw)
    vali_loader = get_loader(cfg, "validate", **loader_kw)
    test_loader = get_loader(cfg, "test", **loader_kw)
    if references is not None:
        vali_loader.dataset.set_references(references)
        test_loader.dataset.set_references(references)
    vocab = vali_loader.dataset.get_vocab()
    generator = torch.Generator().manual_seed(cfg.seed + 1)

    start_epoch = 0
    kbest_resume = None
    resume_path = os.path.join(workdir, "checkpoint.ckpt")
    if resume and os.path.exists(resume_path):
        ckpt = load_checkpoint(resume_path)
        kbest_resume = ckpt.get("kbest")
        if ckpt.get("opt_state") is not None:
            load_flax_variables(model, _variables(ckpt))
            state.optimizer.load_state_dict(to_torch(ckpt["opt_state"]))
            start_epoch = int(ckpt.get("epoch", 0))
            state.step = int(ckpt.get("step", 0))
            sched = ckpt.get("lr_schedule", {})
            lr_schedule.learning_rate = sched.get("learning_rate", lr_schedule.learning_rate)
            lr_schedule.n_current_steps = sched.get("n_current_steps", 0)
            rng = ckpt.get("rng_state")
            if rng:
                train_loader.dataset.random.set_state(rng["train_data"])
                generator.set_state(torch.from_numpy(rng["dropout"].copy()))
            if verbose:
                print("resumed from %s at epoch %d (lr=%g)"
                      % (resume_path, start_epoch, lr_schedule.learning_rate))

    # after every load: its first call captures the step
    train_step = make_train_step(cfg, model, state.optimizer)
    logger = CsvLogger(filepath=workdir, filename="trainning_record.csv",
                       fieldsnames=["epoch", "train_loss"] + METRIC_FIELDS)
    best_model = KBestQueue(k_best_model=cfg.k_best_model,
                            folder_path=os.path.join(workdir, "tmp_models"),
                            standard=cfg.standard)
    if kbest_resume:
        # without this the relative-Sum normalizers reset and the first
        # post-resume eval (trivially Sum = 1.0) would clobber best.ckpt
        best_model.load_state_dict(kbest_resume)
    evaluator = Evaluator(cfg, model, teacher_cfg, teacher_model)
    summary = SummaryWriter(os.path.join(workdir, "trainval"))
    log = logger.write_text if verbose else None

    history = []
    for epoch in range(start_epoch, cfg.epochs):
        train_loader.dataset.shuffle()
        if verbose:
            logger.write_text("epoch %d lr=%g" % (epoch, lr_schedule.get_lr()))
        state, train_info = run_train_epoch(cfg, train_step, state, train_loader,
                                            lr_schedule, generator, log)
        lr_schedule.epoch_update()
        summary.add_scalar("learning_rate", lr_schedule.get_lr(), epoch)
        summary.add_scalars({k: v for k, v in train_info.items()
                             if isinstance(v, float)}, epoch)

        if (epoch + 1) > cfg.start_eval_epoch and (epoch + 1) % cfg.save_checkpoint_every == 0:
            res = run_eval(cfg, evaluator, vali_loader, vocab, analyze=True)
            res["train_loss"] = train_info.get("total_loss", 0.0)
            res["epoch"] = epoch
            history.append(res)
            logger.write(res)
            summary.add_scalars({k: v for k, v in res.items()
                                 if isinstance(v, (int, float)) and k != "epoch"}, epoch)

            ckpt = {
                "epoch": epoch + 1,
                "step": state.step,
                "model": model,
                "opt_state": state.optimizer.state_dict(),
                "lr_schedule": {"learning_rate": lr_schedule.get_lr(),
                                "n_current_steps": lr_schedule.n_current_steps},
                "rng_state": {"train_data": train_loader.dataset.random.get_state(),
                              "dropout": generator.get_state()},
                "validate_result": res,
                "settings": cfg,
            }

            def _save_best(dst, _ckpt=ckpt):
                # best checkpoints drop the optimizer state (eval artifacts)
                slim = {k: v for k, v in _ckpt.items() if k not in ("opt_state", "rng_state")}
                slim["opt_state"] = None
                save_checkpoint(slim, os.path.dirname(dst), os.path.basename(dst))

            keep, info = best_model.check(res, workdir, cfg.tolerence, _save_best)
            ckpt["kbest"] = best_model.state_dict()
            save_checkpoint(ckpt, workdir, "checkpoint.ckpt")
            if verbose:
                logger.write_text(str(info))
            if not keep:
                break

    out: Dict[str, Any] = {"model": model, "state": state, "history": history,
                           "best_res": best_model.best_res}
    if not cfg.no_test:
        best_path = os.path.join(workdir, "best.ckpt")
        if not os.path.exists(best_path) and cfg.k_best_model > 1:
            # with k > 1 the queue writes tmp_models/model_NNNN.ckpt only
            best_path = best_model.best_entry_path() or best_path
        if best_path and os.path.exists(best_path):
            bmodel, bcfg, _ = load_model_and_config(best_path, device=dev)
            bevaluator = Evaluator(bcfg, bmodel, teacher_cfg, teacher_model)
        else:
            bevaluator = evaluator
        out["test_res"] = run_eval(cfg, bevaluator, test_loader, vocab, analyze=True)
    return out
