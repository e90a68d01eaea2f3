"""Runtime: the serving entry (navc_tpu.runtime.serving)."""
