"""The port's feature extraction (models/resnet.py, data/pretreatment.py)
against navc_tpu's, on the CPU.

A small ResNet (stages 1-1-1-1, width 8, 64 x 64 images): the port's
seeded init, its BatchNorm statistics randomised, as navc_tpu's flax
variables (navc_tpu's ``convert_torchvision_resnet``), carried back into
the port by ``convert.load_flax_variables``; the torchvision-keyed mirror of
tests/test_resnet_backbone.py loaded by ``load_state_dict``;
``make_backbone``'s normalisation and batching; the frame and HDF5
pipeline (PIL, h5py; ffmpeg through a stand-in script, which this host
lacks) against navc_tpu's. Features within atol = rtol = 1e-4 (float32
convolutions summed in another order), as test_resnet_backbone.py holds
navc_tpu's against the mirror.
"""

import os
import stat
import sys

import jax
import numpy as np
import pytest
import torch
from navc_tpu.data import pretreatment as jax_pre
from navc_tpu.models import resnet as jax_resnet

from navc_tpu_torch.convert import load_flax_variables
from navc_tpu_torch.data import pretreatment
from navc_tpu_torch.models.resnet import (IMAGENET_MEAN, IMAGENET_STD, RESNET_STAGES, ResNet,
                                          init_resnet, make_backbone)
from test_resnet_backbone import STAGES, WIDTH, randomized_torch_model

TOL = dict(atol=1e-4, rtol=1e-4)


def seeded_resnet(seed=0):
    """The port's init from ``seed``, its BatchNorm affine terms and
    running statistics randomised."""
    model = init_resnet(torch.Generator().manual_seed(seed), STAGES, WIDTH)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) * 0.5 + 0.75)
    return model


def flax_resnet(seed=0):
    """``seeded_resnet(seed)`` as navc_tpu's flax variables."""
    return jax_resnet.convert_torchvision_resnet(seeded_resnet(seed).state_dict())


def port_from_flax(variables):
    return load_flax_variables(ResNet(STAGES, WIDTH), variables).eval()


def images(n, seed=0, size=64):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def test_resnet_matches_navc_tpu_on_carried_weights():
    """navc_tpu's flax tree fills every weight and statistic of the port's
    module (the conv kernels transposed back: the seeded model's own
    values) and both give the same features."""
    variables = flax_resnet()
    model = port_from_flax(variables)
    for (k, t), u in zip(model.state_dict().items(), seeded_resnet().state_dict().values()):
        assert torch.equal(t, u), k
    x = images(3)
    apply = jax.jit(lambda v, x: jax_resnet.ResNet(stage_sizes=STAGES, width=WIDTH).apply(
        v, x, train=False))
    want = np.asarray(apply(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (3, WIDTH * 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_torchvision_state_dict_loads_directly():
    """The mirror's keys are the port's plus the classifier, which the
    reference strips as the port does: load_state_dict takes the rest."""
    tmodel = randomized_torch_model()
    sd = {k: v for k, v in tmodel.state_dict().items() if not k.startswith("fc.")}
    model = ResNet(STAGES, WIDTH)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    x = torch.from_numpy(images(2).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(x).numpy(), tmodel(x).numpy(), **TOL)


def test_make_backbone_normalizes_and_batches():
    tmodel = randomized_torch_model(3)
    model = ResNet(STAGES, WIDTH)
    model.load_state_dict({k: v for k, v in tmodel.state_dict().items()
                           if not k.startswith("fc.")})
    backbone = make_backbone(model, batch_size=2, device="cpu")
    x = images(5, 1)
    feats = backbone(x)
    assert feats.shape == (5, WIDTH * 32) and feats.dtype == np.float32
    normed = (x - IMAGENET_MEAN) / IMAGENET_STD
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(normed.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(feats, ref, **TOL)
    jfeats = jax_resnet.make_backbone(
        jax_resnet.convert_torchvision_resnet(tmodel.state_dict()), STAGES, WIDTH, 2)(x)
    np.testing.assert_allclose(feats, jfeats, **TOL)
    assert backbone(x[:0]).shape == (0, WIDTH * 32)


def test_backbone_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_backbone(ResNet(STAGES, WIDTH))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_resnet(torch.Generator().manual_seed(0), STAGES, WIDTH, device="cuda")


def test_init_resnet_is_seeded_flax_style():
    a = init_resnet(torch.Generator().manual_seed(0), STAGES, WIDTH)
    b = init_resnet(torch.Generator().manual_seed(0), STAGES, WIDTH)
    c = init_resnet(torch.Generator().manual_seed(1), STAGES, WIDTH)
    assert not a.training
    for (k, t), u, w in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(t, u), k
        if k.endswith("conv2.weight"):
            assert not torch.equal(t, w)
            assert abs(float(t.std()) * np.sqrt(t[0].numel()) - 1) < 0.15, k
        if k.endswith("running_var"):
            assert bool((t == 1).all()), k
    assert RESNET_STAGES[101] == (3, 4, 23, 3)
    x = torch.from_numpy(images(2).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        assert torch.isfinite(a(x)).all()


@pytest.mark.parametrize("n,k", [(0, 4), (3, 4), (4, 4), (10, 4), (60, 8), (61, 28), (7, 0)])
def test_uniform_sample_matches_navc_tpu(n, k):
    assert pretreatment.uniform_sample(n, k) == jax_pre.uniform_sample(n, k)


def _write_frames(d, n, seed):
    from PIL import Image

    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        arr = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / ("image_%05d.jpg" % i))
    return str(d)


def test_load_frames_matches_navc_tpu(tmp_path):
    d = _write_frames(tmp_path / "v", 3, 0)
    paths = sorted(os.path.join(d, f) for f in os.listdir(d))
    got = pretreatment.load_frames(paths, size=32)
    assert got.shape == (3, 32, 32, 3) and got.min() >= 0 and got.max() <= 1
    np.testing.assert_array_equal(got, jax_pre.load_frames(paths, size=32))
    assert pretreatment.load_frames([], 16).shape == (0, 16, 16, 3)


def test_extract_frames_runs_ffmpeg_as_navc_tpu(tmp_path):
    """Both strategies' ffmpeg command lines (a stand-in script records them
    and writes two frames) and the returned frame paths, as navc_tpu's."""
    log = tmp_path / "argv.txt"
    fake = tmp_path / "ffmpeg"
    fake.write_text(
        "#!%s\nimport sys\nopen(%r, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "for i in (1, 2):\n    open(sys.argv[-1] %% i, 'wb').write(b'')\n"
        % (sys.executable, str(log)))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    for strategy in (0, 1):
        out = [mod.extract_frames("v.mp4", str(tmp_path / ("%s%d" % (name, strategy))),
                                  strategy=strategy, fps=5, vframes=60, ffmpeg=str(fake))
               for name, mod in (("p", pretreatment), ("j", jax_pre))]
        assert [os.path.basename(p) for p in out[0]] == ["image_00001.jpg", "image_00002.jpg"]
        assert [os.path.basename(p) for p in out[1]] == [os.path.basename(p) for p in out[0]]
    lines = [ln.replace("/j", "/p") for ln in log.read_text().splitlines()]
    assert lines[0] == lines[1] and lines[2] == lines[3]
    assert "-vf fps=5 -vframes 60" in lines[2] and "-vf" not in lines[0]
    with pytest.raises(ValueError):
        pretreatment.extract_frames("v.mp4", str(tmp_path / "x"), strategy=2, ffmpeg=str(fake))


def test_hdf5_extraction_roundtrip_matches_navc_tpu(tmp_path):
    """jpg frames -> the port's ResNet backbone -> HDF5, against navc_tpu's
    pipeline on the same weights (reference
    extract_image_feats_from_frames.py:20-59)."""
    h5py = pytest.importorskip("h5py")
    frame_dirs = {vid: _write_frames(tmp_path / vid, 6, s)
                  for s, vid in enumerate(("video0", "video1"))}
    variables = flax_resnet(1)
    outs = {}
    for name, mod, backbone in (
            ("port", pretreatment, make_backbone(port_from_flax(variables), 4, device="cpu")),
            ("navc", jax_pre, jax_resnet.make_backbone(variables, STAGES, WIDTH, 4))):
        outs[name] = str(tmp_path / ("%s.hdf5" % name))
        mod.extract_video_features(frame_dirs, backbone, outs[name], k_frames=4,
                                   batch_size=3, image_size=64)
    with h5py.File(outs["port"]) as f, h5py.File(outs["navc"]) as g:
        assert set(f.keys()) == set(g.keys()) == {"video0", "video1"}
        for vid in f:
            assert f[vid].shape == (4, WIDTH * 32)
            np.testing.assert_allclose(f[vid][()], g[vid][()], **TOL)


def test_random_projection_backbone_matches_navc_tpu():
    x = images(4, 2, size=8)
    np.testing.assert_allclose(pretreatment.random_projection_backbone(16, 3)(x),
                               jax_pre.random_projection_backbone(16, 3)(x), rtol=1e-6)
