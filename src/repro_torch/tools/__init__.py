"""Developer-facing command-line tools (``python -m repro_torch.tools.<tool>``)."""
