"""Build and load code for the CUDA sources in ``csrc/``."""
