"""Utilities of the port: checkpoints (:mod:`ngx_torch.utils.checkpoint`)."""
