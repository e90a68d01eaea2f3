"""Command-line entry points: navc_tpu_torch.cli.train, translate, convert
and prepare_corpora."""
