"""iisan_tpu_torch: the PyTorch / CUDA port of iisan_tpu for NVIDIA Hopper.

This slice ports the cached serving path: the side adapter network (SAN)
and ``com_dense`` build the fused item table from cached tap tables, and
the SASRec user encoder scores the catalogue for top-K requests and for
HR@10 / nDCG@10.  Its two hand-written kernels (the fused user-encoder
forward and the SAN cascade forward) live in ``csrc/`` and are built on
first use by ``kernels/build.py``.  The package imports no JAX; the JAX
package ``iisan_tpu`` is the reference it is tested against.
"""

__all__: list = []
