"""Command-line entry points of the port (``python -m vaeunet_tpu_torch.cli.<name>``)."""
