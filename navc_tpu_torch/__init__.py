"""navc_tpu_torch — the PyTorch / NVIDIA H100 port of ``navc_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and numpy and
nothing of JAX or ``navc_tpu``. The JAX package stays the reference, and the
tests hold every module here against its counterpart there.

It serves NACF and NAB (mask-predict, left-to-right or easy-first
refinement, with the coarse-template pass and AR-teacher rescoring, and the
per-iteration collect modes), ARB/ARB2 (KV-cached beam search) and a
DeepSeek-V3-type MoE language model as a beam-search caption decoder
(method ``MLAMoE``: ``models/mla_moe.py``, ``decoding/lm_beam.py``), trains
all four methods (``cli/train.py``; across ranks with ``--distributed``:
data and tensor parallelism on torch.distributed), extracts image features
(``models/resnet.py``, ``data/pretreatment.py``), and evaluates and captions from a
checkpoint (``cli/translate.py``, ``api.CaptionPipeline``; reference
``.pth.tar`` files through ``cli/convert.py``). The Pallas kernels those
paths reach in ``navc_tpu`` are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use.

Package layout (mirrors ``navc_tpu``):
    constants   token ids (copy of navc_tpu.constants)
    config      config tree + method registry (copy of navc_tpu.config)
    convert     flax ``variables`` tree (numpy leaves) <-> port modules
    models      nn.Module model stack
    ops         masks, selection, kernel gates, the kernel wrappers
    decoding    length beam + mp / l2r / ef refinement, AR beam search
    runtime     StreamingCaptioner serving entry, .ckpt files, the train
                step, losses, optimizer, epoch loop (one rank or several)
                and evaluation, reference state_dict conversion
    parallel    the process group, the (data, model) rank grid, sharding
    data        the dataset, the loader (host-sharded or not), synthetic
                corpora, corpus preparation (info_corpus.pkl / refs.pkl
                from annotations) and frame / feature extraction
    metrics     the PTB tokenizer and the COCO scorers
    native      the C++ tokenizer and scorers (ctypes; g++ at first use)
    api         CaptionPipeline: checkpoint -> captions
    cli         train, translate, convert and prepare_corpora entry points
"""

__version__ = "0.1.0"
