"""Command-line tools of the port (`python -m veles_tpu_torch.tools.<name>`)."""
