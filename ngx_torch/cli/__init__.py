"""Command-line entry points of the port (``python -m ngx_torch.cli.<name>``)."""
