"""Model stack: nn.Modules mirroring navc_tpu.models (eval and train mode).

    navc_tpu.models.layers    -> navc_tpu_torch.models.layers
    navc_tpu.models.encoder   -> navc_tpu_torch.models.encoder
    navc_tpu.models.fusion    -> navc_tpu_torch.models.fusion
    navc_tpu.models.predictor -> navc_tpu_torch.models.predictor
    navc_tpu.models.decoder   -> navc_tpu_torch.models.decoder
    navc_tpu.models.seq2seq   -> navc_tpu_torch.models.seq2seq
    navc_tpu.models.resnet    -> navc_tpu_torch.models.resnet (feature extraction)
"""

from .seq2seq import Seq2Seq, build_model  # noqa: F401
