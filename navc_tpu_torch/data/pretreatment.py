"""Offline pretreatment: frame extraction and CNN feature extraction.

Port of navc_tpu/data/pretreatment.py (reference pretreatment/):
  * frame extraction runs ffmpeg per video with the same two strategies:
    all frames, or fps-capped with a maximum frame count
    (extract_frames_from_videos.py:10-31),
  * image-feature extraction samples k frames uniformly (or takes all) and
    writes one ``(frames, dim)`` dataset per video id to HDF5
    (extract_image_feats_from_frames.py:20-59).

The backbone is any callable ``images (N, H, W, 3) float32 -> features
(N, dim)``: ``models.resnet.make_backbone`` (a ResNet with random or
locally loaded weights: no pretrained weights are fetched), or
``random_projection_backbone`` for fixtures. PIL and h5py are imported
where they are used, so a host without them imports this module. Motion
(3D-CNN) features stay an external tool's step, as in the reference
(README.md:115-124).
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import Callable, Dict, List, Sequence

import numpy as np


def extract_frames(video_path: str, out_dir: str, strategy: int = 1,
                   fps: int = 5, vframes: int = 60, prefix: str = "image_",
                   ffmpeg: str = "ffmpeg") -> List[str]:
    """Extract the frames of one video (reference
    extract_frames_from_videos.py); returns their paths, sorted.

    strategy 0: every frame; strategy 1: ``fps`` frames a second, at most
    ``vframes`` (the README's fps 5 / max 60 protocol).
    """
    os.makedirs(out_dir, exist_ok=True)
    out_pattern = os.path.join(out_dir, prefix + "%05d.jpg")
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-i", video_path]
    if strategy == 1:
        cmd += ["-vf", "fps=%d" % fps, "-vframes", str(vframes)]
    elif strategy != 0:
        raise ValueError("strategy must be 0 or 1")
    cmd += ["-q:v", "2", out_pattern]
    subprocess.run(cmd, check=True)
    return sorted(glob.glob(os.path.join(out_dir, prefix + "*.jpg")))


def uniform_sample(n_total: int, k: int) -> List[int]:
    """k uniformly spaced indices (reference extract_image_feats:38-49)."""
    if k <= 0 or n_total <= k:
        return list(range(n_total))
    bound = np.linspace(0, n_total, k + 1).astype(int)
    return [int((bound[i] + bound[i + 1]) // 2) for i in range(k)]


def load_frames(frame_paths: Sequence[str], size: int = 224) -> np.ndarray:
    """Decode and resize frames to (N, size, size, 3) float32 in [0, 1]."""
    from PIL import Image

    out = []
    for p in frame_paths:
        img = Image.open(p).convert("RGB").resize((size, size))
        out.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(out) if out else np.zeros((0, size, size, 3), np.float32)


def extract_video_features(
        frame_dirs: Dict[str, str],
        backbone: Callable[[np.ndarray], np.ndarray],
        out_hdf5: str,
        k_frames: int = 0,
        batch_size: int = 32,
        image_size: int = 224) -> None:
    """Run the backbone over the (sampled) frames of each video and write
    HDF5: ``frame_dirs`` maps a video id to its directory of frames."""
    import h5py

    with h5py.File(out_hdf5, "w") as f:
        for vid, d in frame_dirs.items():
            paths = sorted(glob.glob(os.path.join(d, "*.jpg")))
            paths = [paths[i] for i in uniform_sample(len(paths), k_frames)]
            feats = []
            for start in range(0, len(paths), batch_size):
                imgs = load_frames(paths[start:start + batch_size], image_size)
                feats.append(np.asarray(backbone(imgs)))
            if feats:
                f.create_dataset(vid, data=np.concatenate(feats, axis=0))


def random_projection_backbone(dim: int = 2048, seed: int = 0
                               ) -> Callable[[np.ndarray], np.ndarray]:
    """A deterministic stub backbone for tests and fixtures: the mean pixel
    through a random projection. Not a trained model."""
    rng = np.random.RandomState(seed)
    w = rng.randn(3, dim).astype(np.float32) / np.sqrt(3)

    def backbone(images: np.ndarray) -> np.ndarray:
        return images.mean(axis=(1, 2)) @ w  # (N, 3) @ (3, dim)

    return backbone
