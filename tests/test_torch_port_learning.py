"""Learning sanity of the port on the CPU: the port's counterpart of
tests/test_learning.py.

``train_network_all`` with ``device="cpu"`` on ``make_learnable_synthetic``
(24 videos of 4 latent classes: features clustered by class, one caption
per class) must recover the class -> caption mapping on held-out videos.
The toy configuration and the thresholds are tests/test_learning.py's:
ARB (and ARB2, the same decoder under the disentangled two-pass training)
max val CIDEr > 2.0 and test > 1.5 with the train loss down by a fifth;
NAB (length head + mask-predict, no teacher) max val CIDEr > 1.0 and test
> 0.7.

Those thresholds were calibrated on navc_tpu's seed-0 initial weights
(``init_params`` with ``PRNGKey(cfg.seed)``), so each run starts from that
draw, carried into the port through ``convert.load_flax_variables`` and a
``.ckpt`` (``cfg.pretrained_path``). The port's own seed-0 draw (a torch
Generator) is another draw of the same distribution: from it the ARB run
reads val CIDEr 0.98 and test 0.57, and navc_tpu trained from that same
``.ckpt`` reads the same numbers to 1e-9 (seeds 1-3 of the port read test
2.0-3.5), so these are the draw's, not the port's.

Run: ``python -m pytest tests/test_torch_port_learning.py -q``.
"""

import jax
import numpy as np
import pytest

from navc_tpu.config import default_config as jax_default_config
from navc_tpu.models import build_model as jax_build_model
from navc_tpu.models import init_params
from navc_tpu_torch.config import default_config
from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.data.synthetic import make_learnable_synthetic
from navc_tpu_torch.models import build_model
from navc_tpu_torch.runtime.checkpoint import save_checkpoint
from navc_tpu_torch.runtime.loop import train_network_all

TOY = dict(dataset="MSVD", vocab_size=40, dim_hidden=32, num_attention_heads=2,
           intermediate_size=64, n_frames=4, n_total_frames=10, dim_i=12, dim_m=10,
           modality="mi", max_len=10, batch_size=8, hidden_dropout_prob=0.0,
           encoder_dropout=0.0, compute_dtype="float32", save_checkpoint_every=4,
           learning_rate=2e-3, minimum_learning_rate=5e-4)


def train(method, tmp_path, **kw):
    """The port's ``train_network_all`` from navc_tpu's initial weights for
    ``method`` under TOY + ``kw``; returns its result."""
    over = dict(TOY, base_checkpoint_path=str(tmp_path), **kw)
    cfg = default_config(method, **over)
    jcfg = jax_default_config(method, **over)
    if cfg.decoding_type == "NARFormer":
        no_teacher = dict(teacher_path="", load_teacher_weights=False, with_teacher=False)
        cfg, jcfg = cfg.replace(**no_teacher), jcfg.replace(**no_teacher)
    assert cfg.to_dict() == jcfg.to_dict()
    variables = init_params(jax_build_model(jcfg), jax.random.PRNGKey(jcfg.seed), jcfg)
    model = load_flax_variables(build_model(cfg, device="cpu"),
                                jax.tree_util.tree_map(np.asarray, variables))
    init = save_checkpoint({"model": model, "settings": cfg}, str(tmp_path), "init.ckpt")
    corpus, refs, feats = make_learnable_synthetic(cfg, n_videos=24, n_classes=4)
    return train_network_all(cfg.replace(pretrained_path=init),
                             workdir=str(tmp_path / "run"), info_corpus=corpus,
                             references=refs, in_memory_feats=feats, verbose=False,
                             device="cpu")


@pytest.mark.parametrize("method", ["ARB", "ARB2"])
def test_ar_model_learns_class_captions(method, tmp_path):
    out = train(method, tmp_path, epochs=12, beam_size=2)
    h = out["history"]
    assert h[-1]["train_loss"] < h[0]["train_loss"] * 0.8
    assert max(x["CIDEr"] for x in h) > 2.0, [x["CIDEr"] for x in h]
    # generalization: held-out test videos of seen classes score well
    assert out["test_res"]["CIDEr"] > 1.5, out["test_res"]


def test_nar_mask_predict_learns(tmp_path):
    out = train("NAB", tmp_path, epochs=16, length_beam_size=3, iterations=3)
    h = out["history"]
    assert max(x["CIDEr"] for x in h) > 1.0, [x["CIDEr"] for x in h]
    assert out["test_res"]["CIDEr"] > 0.7, out["test_res"]
