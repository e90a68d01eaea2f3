"""Data pipeline: the dataset, the batch loader and synthetic fixtures
(ports of navc_tpu.data.dataset, loader and synthetic)."""

from .dataset import VideoDataset, get_frame_ids, resampling_ids  # noqa: F401
from .loader import BatchLoader, get_loader  # noqa: F401
