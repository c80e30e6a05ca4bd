"""Command-line tools of the port (``python -m qatzip_tpu_torch.tools.<name>``)."""
