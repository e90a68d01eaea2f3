"""Command-line entry points (navc_tpu_torch.cli.train)."""
