"""Low-level ops: masks, selection, kernel gates and the CUDA kernels'
wrappers (navc_tpu.ops)."""
