"""navc_tpu_torch — the PyTorch / NVIDIA H100 port of ``navc_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and numpy and
nothing of JAX or ``navc_tpu``. The JAX package stays the reference, and the
tests hold every module here against its counterpart there.

It covers two serving paths: NACF (mask-predict decoding with the
coarse-template pass and AR-teacher rescoring) and ARB/ARB2 (KV-cached beam
search), and the training step of all four methods (the decoder layer as a
fused training layer, the vocab projection on the logits route). The Pallas
kernels those paths reach in ``navc_tpu`` are hand-written CUDA kernels
here (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use.

Package layout (mirrors ``navc_tpu``):
    constants   token ids (copy of navc_tpu.constants)
    config      config tree + method registry (copy of navc_tpu.config)
    convert     flax ``variables`` tree (numpy leaves) <-> port modules
    models      nn.Module model stack
    ops         masks, selection, kernel gates, the kernel wrappers
    decoding    length beam + mask-predict refinement, AR beam search
    runtime     StreamingCaptioner serving entry, .ckpt loading, the train
                step, losses, optimizer and epoch loop
"""

__version__ = "0.1.0"
