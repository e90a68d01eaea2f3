"""Runtime: the serving entry (navc_tpu.runtime.serving), checkpoint
loading (navc_tpu.runtime.checkpoint), and training: the train step, losses,
optimizer, running averages and the epoch loop (navc_tpu.runtime.train_step,
crit, optim, logger, loop)."""
