"""Command-line entry points of the port (`python -m vexpress_torch.cli.infer`)."""
