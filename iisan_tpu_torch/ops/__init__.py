"""Kernel wrappers with their plain PyTorch versions, and ranking metrics."""
