"""iisan_tpu_torch: the PyTorch / CUDA port of iisan_tpu for NVIDIA Hopper.

Ported so far: the cached serving path (the side adapter network (SAN)
and ``com_dense`` build the fused item table from cached tap tables, and
the SASRec user encoder scores the catalogue for top-K requests and for
HR@10 / nDCG@10), IISAN (Cached) training (``train.cached``), IISAN-Versa
over asymmetric towers with int8 tap tables and on-disk hidden-state
stores (``pipeline="cached_asym"``), and IISAN (Uncached) training with
its full fine-tuning baseline, the BERT and ViT towers in the step
(``train.uncached``), and the builders of the hidden-state caches
(``cache_builder``, ``tools.build_caches``) with the Versa towers (Llama,
CLIP, EVA), the ID-SASRec baseline (``train.id_pipeline``), and the run
path: ``python -m iisan_tpu_torch.cli`` and
``train.pipelines.run_from_config`` (dispatch, checkpoints and resume,
warm starts from reference ``.pt`` files, export) and ``sweep``.  Its
hand-written kernels (the fused user-encoder forward and backward, the SAN
cascade forward, resident and step-streamed, the tower attention forward,
backward and mask replay) live in ``csrc/``
and are built on first use by ``kernels/build.py``.  The package imports no
JAX; the JAX package ``iisan_tpu`` is the reference it is tested against.
"""

__all__: list = []
