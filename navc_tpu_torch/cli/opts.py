"""Argparse flag surface mirroring reference opts.py (a copy of
navc_tpu/cli/opts.py: the same flags, names and defaults).

Every reference flag is accepted with the same name/semantics
(opts.py:5-145); resolution order (method overlay -> NAR forcing ->
``--default`` presets) is implemented in navc_tpu_torch.config.resolve.
``--use_pallas`` keeps its name and turns on the CUDA kernels.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import Config, resolve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", type=str, default="MSRVTT")
    p.add_argument("-m", "--modality", type=str, default="mi")
    p.add_argument("-df", "--default", default=False, action="store_true")
    p.add_argument("--scope", type=str, default="")
    p.add_argument("--method", type=str, default="",
                   help="ARB | ARB2 | NAB | NACF")
    p.add_argument("--encoder", type=str, default="Encoder_HighWay")
    p.add_argument("--decoder", type=str, default="BertDecoder")
    p.add_argument("--decoding_type", type=str, default="ARFormer")
    p.add_argument("--fusion", type=str, default="temporal_concat")

    model = p.add_argument_group("Model Parameters")
    model.add_argument("--dim_hidden", type=int, default=512)
    model.add_argument("--num_hidden_layers_decoder", type=int, default=1)
    model.add_argument("--num_attention_heads", type=int, default=8)
    model.add_argument("--intermediate_size", type=int, default=2048)
    model.add_argument("--hidden_act", type=str, default="gelu_new")
    model.add_argument("--hidden_dropout_prob", type=float, default=0.5)
    model.add_argument("--attention_probs_dropout_prob", type=float, default=0.0)
    model.add_argument("--max_len", type=int, default=30)
    model.add_argument("--layer_norm_eps", type=float, default=1e-5)
    model.add_argument("--watch", type=int, default=0)
    model.add_argument("--pos_attention", default=False, action="store_true")
    model.add_argument("--enhance_input", type=int, default=2)
    model.add_argument("--with_layernorm", default=False, action="store_true")
    model.add_argument("-wc", "--with_category", default=False, action="store_true")
    model.add_argument("--num_category", type=int, default=20)
    model.add_argument("--encoder_dropout", type=float, default=0.5)
    model.add_argument("--no_encoder_bn", default=False, action="store_true")
    model.add_argument("--norm_type", type=str, default="bn")
    model.add_argument("--dim_word", type=int, default=512)
    model.add_argument("-tie", "--tie_weights", default=False, action="store_true")

    tr = p.add_argument_group("Training Parameters")
    tr.add_argument("--seed", default=0, type=int)
    tr.add_argument("--learning_rate", default=5e-4, type=float)
    tr.add_argument("--decay", default=0.9, type=float)
    tr.add_argument("--minimum_learning_rate", default=5e-5, type=float)
    tr.add_argument("--n_warmup_steps", type=int, default=0)
    tr.add_argument("--optim", type=str, default="adam")
    tr.add_argument("--grad_clip", type=float, default=5.0)
    tr.add_argument("--weight_decay", type=float, default=5e-4)
    tr.add_argument("-e", "--epochs", type=int, default=50)
    tr.add_argument("-b", "--batch_size", type=int, default=64)
    tr.add_argument("--pretrained_path", default="", type=str)
    tr.add_argument("--teacher_path", type=str, default="")
    tr.add_argument("--beta", nargs="+", type=float, default=[0, 1])
    tr.add_argument("--visual_word_generation", default=False, action="store_true")
    tr.add_argument("--demand", nargs="+", type=str, default=["VERB", "NOUN"])
    tr.add_argument("-nvw", "--nv_weights", nargs="+", type=float, default=[0.8, 1.0])
    tr.add_argument("--load_teacher_weights", default=False, action="store_true")
    tr.add_argument("--no_test", default=False, action="store_true")

    ev = p.add_argument_group("Evaluation Parameters")
    ev.add_argument("-see", "--start_eval_epoch", type=int, default=0)
    ev.add_argument("--tolerence", type=int, default=1000)
    ev.add_argument("--metric_sum", nargs="+", type=int, default=[1, 1, 1, 1])
    ev.add_argument("--standard", nargs="+", type=str,
                    default=["Bleu_4", "METEOR", "CIDEr"])
    ev.add_argument("-bs", "--beam_size", type=int, default=1)
    ev.add_argument("-ba", "--beam_alpha", type=float, default=1.0)
    ev.add_argument("--paradigm", type=str, default="mp")
    ev.add_argument("-lbs", "--length_beam_size", type=int, default=6)
    ev.add_argument("--iterations", type=int, default=5)
    ev.add_argument("--q", type=int, default=1)
    ev.add_argument("--q_iterations", type=int, default=1)
    ev.add_argument("--use_ct", default=False, action="store_true")
    ev.add_argument("--k_best_model", type=int, default=1)
    ev.add_argument("--save_checkpoint_every", type=int, default=1)

    mt = p.add_argument_group("Multi-Task Parameters")
    mt.add_argument("--crit", nargs="+", type=str, default=["lang"])
    mt.add_argument("--crit_name", nargs="+", type=str, default=["Cap Loss"])
    mt.add_argument("--crit_scale", nargs="+", type=float, default=[1.0])

    dl = p.add_argument_group("Dataloader Parameters")
    dl.add_argument("--n_frames", type=int, default=8)
    dl.add_argument("--n_total_frames", type=int, default=60)
    dl.add_argument("--n_caps_per_video", type=int, default=0)
    dl.add_argument("--random_type", type=str, default="segment_random")
    dl.add_argument("--load_feats_type", type=int, default=1)
    dl.add_argument("--dim_a", type=int, default=1)
    dl.add_argument("--dim_m", type=int, default=2048)
    dl.add_argument("--dim_i", type=int, default=2048)
    dl.add_argument("--dim_o", type=int, default=1)
    dl.add_argument("--dim_t", type=int, default=1)
    dl.add_argument("--feats_a_name", nargs="+", type=str, default=[])
    dl.add_argument("--feats_m_name", nargs="+", type=str,
                    default=["motion_resnext101_kinetics_duration16_overlap8.hdf5"])
    dl.add_argument("--feats_i_name", nargs="+", type=str,
                    default=["image_resnet101_imagenet_fps_max60.hdf5"])
    dl.add_argument("--feats_o_name", nargs="+", type=str, default=[])
    dl.add_argument("--feats_t_name", nargs="+", type=str, default=[])
    dl.add_argument("--info_corpus_name", type=str, default="info_corpus.pkl")
    dl.add_argument("--reference_name", type=str, default="refs.pkl")

    paths = p.add_argument_group("Paths")
    paths.add_argument("--base_data_path", type=str, default="./data")
    paths.add_argument("--base_checkpoint_path", type=str, default="./experiments")

    tpu = p.add_argument_group("Kernel and precision parameters")
    tpu.add_argument("--compute_dtype", type=str, default="bfloat16")
    tpu.add_argument("--use_pallas", default=False, action="store_true")
    tpu.add_argument("--prefetch_depth", type=int, default=2)

    return p


def parse_config(argv=None, require_teacher_ckpt: bool = True) -> Config:
    args = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in known})
    return resolve(cfg, require_teacher_ckpt=require_teacher_ckpt)
