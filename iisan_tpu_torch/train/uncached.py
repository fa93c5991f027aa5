"""IISAN (Uncached) and full fine-tuning training on one device.

Port of ``iisan_tpu/train/uncached.py``: the BERT and ViT towers run inside
every training step.  ``build_uncached_model`` picks the model from the
adapter method (IISAN: ``UncachedIISANModel`` with frozen towers; otherwise
``FFTRecModel``), and ``trainable_mask`` decides what the optimizer
updates.  A step: upload the batch's uint8 images, normalise them on the
device, the model's training forward, ``backward``, one Adam step.  Images
are decoded on a thread pool one batch ahead (``ParallelImageLoader``);
titles are rows of the packed token table.

Not ported: ``device_bench`` (a scan over staged data for the TPU),
meshes, W8A8 towers and the attention-subblock kernels
(``towers_from_config`` raises for the last two).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.images import ParallelImageLoader, normalize_images
from ..device import resolve_device
from ..eval.evaluate import evaluate
from ..models.san import san_from_config
from ..models.towers import FFTRecModel, UncachedIISANModel, towers_from_config
from ..utils.jax_params import load_jax_params
from .loop import TrainLoopMixin
from .optim import build_optimizer, log_group_sizes
from .peft_masks import trainable_mask

log = logging.getLogger("iisan_tpu_torch")


def build_uncached_model(cfg, device=None, generator=None):
    """(model, method): ``UncachedIISANModel`` and "iisan" for the IISAN
    method, else ``FFTRecModel`` and the adapter type ("fft" when no
    adapter is added)."""
    dtype = getattr(torch, cfg.compute_dtype)
    text, image = towers_from_config(cfg, dtype, device, generator)
    fused_ue = None if getattr(cfg, "fused_user_encoder", True) else False
    common = dict(embedding_dim=cfg.embedding_dim, max_seq_len=cfg.max_seq_len,
                  num_attention_heads=cfg.num_attention_heads,
                  transformer_block=cfg.transformer_block,
                  drop_rate=cfg.drop_rate, dtype=dtype,
                  fused_user_encoder=fused_ue, device=device,
                  generator=generator)
    if cfg.is_iisan():
        model = UncachedIISANModel(
            text, image, san_from_config(cfg, device, generator),
            text_tap_ids=cfg.san_text_taps(), image_tap_ids=cfg.san_image_taps(),
            modality=cfg.modality, freeze_towers=cfg.towers_frozen(), **common)
        return model, "iisan"
    method = cfg.adapter_type if cfg.adding_adapter_to != "None" else "fft"
    return FFTRecModel(text, image, **common), method


class UncachedTrainer(TrainLoopMixin):
    """Uncached training with both towers in the step.

    cfg: an ``IISANConfig`` (either package's); corpus: a ``Corpus``;
    token_table: (item_num+1, 2 * num_words) packed title rows;
    image_store: ``.get(name)`` -> (H, W, 3) uint8; tower_params: optional
    {"text_tower/bert": JAX tree, ...} grafted over the initial weights.
    The model is initialised on the CPU from ``cfg.seed`` and moved to
    ``device`` (default the first CUDA card; the CPU only when asked
    for).  Dropout draws from a generator on ``device`` seeded from
    ``cfg.seed``.
    """

    def __init__(self, cfg, corpus, token_table, image_store,
                 tower_params: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        self.cfg, self.corpus = cfg, corpus
        self.token_table = np.asarray(token_table)
        self.loader = ParallelImageLoader(image_store,
                                          num_threads=max(cfg.num_workers, 1))
        self.model, self.method = build_uncached_model(
            cfg, generator=torch.Generator().manual_seed(cfg.seed))
        for key, tree in (tower_params or {}).items():
            load_jax_params(self.model.get_submodule(key.replace("/", ".")), tree)
        self.model.to(self.device)
        self.mask = trainable_mask(
            self.model, self.method,
            finetune_layernorm="None" not in cfg.finetune_layernorm,
            freeze_paras_before=cfg.freeze_paras_before,
            fine_tune_to_all="all" in cfg.fine_tune_to)
        self.optimizer = build_optimizer(cfg, self.model, self.mask)
        log_group_sizes(cfg, self.model, self.mask)
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.pop_prob = torch.as_tensor(np.asarray(corpus.pop_prob),
                                        device=self.device)
        self._last_step_losses = None
        n_train = sum(p.numel() for n, p in self.model.named_parameters()
                      if self.mask[n])
        log.info("##### method %s trainable_num %d #####", self.method, n_train)

    def _names(self, ids: np.ndarray):
        """Item names of ids; the pad id 0 is None (a zero image)."""
        names = self.corpus.item_names
        return [names[i] if i > 0 else None for i in ids]

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def train_step(self, ids, images_u8, tokens, log_mask) -> torch.Tensor:
        """One step: ids (bs, L+1), images_u8 (bs*(L+1), H, W, 3) uint8,
        tokens (bs*(L+1), 2 * num_words), log_mask (bs, L), all on the
        device; returns the loss (not synchronised)."""
        images = normalize_images(images_u8, self.dtype)
        loss = self.model(ids.long(), images, tokens, log_mask, self.pop_prob,
                          deterministic=False, generator=self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def run_epoch(self, epoch: int) -> float:
        c = self.corpus
        perm = self.epoch_permutation(epoch)
        flat = [c.train_seqs[p].reshape(-1) for p in perm]
        images = self.loader.iter_batches([self._names(f) for f in flat])
        losses = [self.train_step(self._put(c.train_seqs[p]), self._put(imgs),
                                  self._put(self.token_table[f]),
                                  self._put(c.train_log_mask[p]))
                  for p, f, imgs in zip(perm, flat, images)]
        self._last_step_losses = torch.stack(losses)
        return float(self._last_step_losses.float().mean())

    @torch.no_grad()
    def item_embedding_tables(self, batch: int = 256) -> torch.Tensor:
        """The fused (item_num+1, emb) table, the towers in eval mode, in
        batches of ``batch`` items (the last one wrapped to full size)."""
        n = self.corpus.item_num + 1
        idx = np.arange(n)
        chunks = [np.resize(idx[s:s + batch], batch) for s in range(0, n, batch)]
        images = self.loader.iter_batches([self._names(ids) for ids in chunks])
        outs = []
        for s, ids, imgs in zip(range(0, n, batch), chunks, images):
            emb = self.model.item_embeddings(
                normalize_images(self._put(imgs), self.dtype),
                self._put(self.token_table[ids]))
            outs.append(self.model.fuse_embeddings(*emb)[: min(batch, n - s)])
        return torch.cat(outs)

    def evaluate_split(self, split: str = "valid",
                       batch_size: int = None) -> Tuple[float, float]:
        c = self.corpus
        if split == "valid":
            args = (c.valid_tokens, c.valid_log_mask, c.valid_target, c.valid_history)
        else:
            args = (c.test_tokens, c.test_log_mask, c.test_target, c.test_history)
        return evaluate(self.model, self.item_embedding_tables(), *args,
                        batch_size=batch_size or self.cfg.eval_batch_size)

    def gate_values(self) -> Dict[str, np.ndarray]:
        """The learned fusion gates, sigmoid(theta / 0.1) (IISAN only)."""
        san = getattr(self.model, "san", None)
        out = {}
        for name in ("side_gate_params_text", "side_gate_params_cv",
                     "side_gate_params_mm"):
            p = getattr(san, name, None)
            if p is not None:
                out[name] = torch.sigmoid(p.detach().float() / 0.1).cpu().numpy()
        return out
