"""Parallel training on torch.distributed."""
