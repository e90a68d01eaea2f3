"""ResNet image backbone for offline feature extraction.

Port of navc_tpu/models/resnet.py. The reference extracts 2048-d image
features with a last-layer-stripped ResNet-101
(pretreatment/extract_image_feats_from_frames.py:104-114: conv stem -> 4
bottleneck stages -> global average pool):

  * ``ResNet``: the torchvision-v1 architecture (Bottleneck layout, the
    stride 2 in the middle 3x3 conv), its ``state_dict`` keys torchvision's
    (``conv1``, ``bn1``, ``layerS.B.convN`` / ``bnN``,
    ``layerS.B.downsample.{0,1}``), so a torchvision checkpoint loads with
    ``load_state_dict`` (navc_tpu's ``convert_torchvision_resnet``; its
    ``fc.*`` classifier is stripped, as the reference strips it) and
    navc_tpu's flax variables with ``convert.load_flax_variables``;
  * ``init_resnet``: random weights from a ``torch.Generator``, as navc_tpu's
    flax init draws them (convolutions of variance 1 / fan-in, BatchNorm
    scale 1, bias 0, running statistics 0 / 1): no pretrained weights are
    fetched;
  * ``make_backbone``: ``images (N, H, W, 3)`` in [0, 1] -> ``(N, 2048)``
    numpy features, ImageNet-normalised and run in batches, on the card
    unless the caller asks for the CPU; the ``backbone`` of
    ``data.pretreatment.extract_video_features``.

The convolutions are ``F.conv2d`` (cuDNN on the card), as navc_tpu's are
``lax.conv`` outside any Pallas kernel. Inference only: BatchNorm uses its
running statistics.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (self.downsample(x) if self.downsample is not None else x))


class ResNet(nn.Module):
    """torchvision-v1 ResNet trunk; NCHW in, pooled (N, width * 32) out."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET_STAGES[101], width: int = 64):
        super().__init__()
        self.width = width
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for s, n_blocks in enumerate(stage_sizes):
            planes = width * (2 ** s)
            blocks = [Bottleneck(inplanes, planes, 1 if s == 0 else 2, downsample=True)]
            blocks += [Bottleneck(planes * 4, planes) for _ in range(1, n_blocks)]
            self.add_module("layer%d" % (s + 1), nn.Sequential(*blocks))
            inplanes = planes * 4
        self.n_stages = len(stage_sizes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for s in range(self.n_stages):
            x = getattr(self, "layer%d" % (s + 1))(x)
        return x.mean(dim=(2, 3))  # global average pool -> (N, C)


def init_resnet(generator: Optional[torch.Generator] = None,
                stage_sizes: Sequence[int] = RESNET_STAGES[101], width: int = 64,
                device="cpu") -> ResNet:
    """A ``ResNet`` in eval mode with random weights drawn from
    ``generator`` (flax's default init: each convolution normal of variance
    1 / fan-in; BatchNorm scale 1, bias 0, running mean 0, variance 1)."""
    model = ResNet(stage_sizes, width)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / np.sqrt(fan_in))
    return model.to(resolve_device(device)).eval()


def make_backbone(model: ResNet, batch_size: int = 32, device="cuda"
                  ) -> Callable[[np.ndarray], np.ndarray]:
    """``backbone(images)``: (N, H, W, 3) float32 images in [0, 1] ->
    (N, C) float32 numpy features: ImageNet normalisation, then ``model``
    on ``device`` (moved there, in eval mode) ``batch_size`` images at a
    time. The ``backbone`` of ``data.pretreatment.extract_video_features``."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)

    @torch.no_grad()
    def backbone(images: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(images), batch_size):
            x = torch.as_tensor(np.asarray(images[i:i + batch_size], np.float32)).to(dev)
            x = ((x - mean) / std).permute(0, 3, 1, 2)
            out.append(model(x).float().cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, model.width * 32), np.float32)

    return backbone
