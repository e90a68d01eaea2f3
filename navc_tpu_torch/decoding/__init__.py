"""Decoding: AR beam search, length beam + mask-predict refinement
(navc_tpu.decoding)."""

from .beam import make_ar_generator  # noqa: F401
from .length_beam import build_canvas, predict_length_beam  # noqa: F401
from .mask_predict import make_nar_generator  # noqa: F401
