"""Command-line tools of the port (run as `python -m raisr_tpu_torch.tools.<name>`)."""
