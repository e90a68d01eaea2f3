"""Runtime: the serving entry (navc_tpu.runtime.serving) and checkpoint
loading (navc_tpu.runtime.checkpoint)."""
