"""Tower remat (``remat_towers`` = True / "mlp") against no remat.

The port's counterpart of ``tests/test_uncached_e2e.py::test_remat_modes_
match_noremat_gradients``: remat trades memory for time and must not
change the math.  One training step (forward and backward, no optimizer)
of the full fine-tuning model and of the LoRA and BitFit baselines (their
trainability masks set, so layer 0's input needs no gradient: reentrant
checkpointing would drop the gradients inside such a layer) at the small
size (2 layers, width 128, fp32), from the same weights, LoRA's B moved
off zero.  Every gradient agrees with no remat's within rtol 2e-5 and
atol 2e-6, with tower dropout 0 and at tower dropout 0.1 (BERT's rate on
the main path) with the same generator seed: the recompute replays the
forward's dropout masks, and the caller's generator ends the step in the
state it reaches without remat.  ``intermediate`` runs once per layer a
step under False and "mlp" (its pre-GELU output is stored) and twice
under True; under ``torch.no_grad()`` (frozen IISAN towers) remat does
nothing.
"""

import numpy as np
import pytest
import torch

from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.train.peft_masks import trainable_mask
from iisan_tpu_torch.train.uncached import build_uncached_model

SMALL = dict(embedding_dim=16, side_adapter_vit_list="0,1",
             side_adapter_bert_list="0,1", word_embedding_dim=128,
             image_embedding_dim=128, text_layers=2, image_layers=2,
             CV_resize=32, num_words_title=6, max_seq_len=4,
             compute_dtype="float32", bert_adapter_down_size=8,
             cv_adapter_down_size=8)
METHODS = {"fft": dict(adding_adapter_to="None"),
           "lora": dict(adapter_type="lora", adding_adapter_to="all"),
           "bitfit": dict(adapter_type="bitfit", adding_adapter_to="all")}
ITEMS = 20


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    bs, L, nw = 3, cfg.max_seq_len, cfg.num_words_title
    n = bs * (L + 1)
    tokens = np.zeros((n, 2 * nw), np.int64)
    tokens[:, :nw] = rng.integers(1, 99, (n, nw))
    tokens[:, nw:] = 1
    tokens[0, nw + 3:] = 0  # a padded title
    return (torch.tensor(rng.integers(1, ITEMS + 1, (bs, L + 1))),
            torch.tensor(rng.standard_normal((n, 32, 32, 3)), dtype=torch.float32),
            torch.tensor(tokens), torch.ones((bs, L)),
            torch.full((ITEMS + 1,), 1.0 / (ITEMS + 1)))


def _model(method, remat, tower_dropout, state=None):
    cfg = IISANConfig(**SMALL, **METHODS[method], remat_towers=remat,
                      tower_dropout=tower_dropout)
    model, m = build_uncached_model(cfg, generator=torch.Generator().manual_seed(0))
    if state is None:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("lora_B"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
    else:
        model.load_state_dict(state)
    trainable_mask(model, m)
    return cfg, model


def _count_intermediate(model):
    counts = []
    for name, mod in model.named_modules():
        if name.endswith(".intermediate"):
            mod.register_forward_hook(lambda *_: counts.append(1))
    return counts


def _step(model, batch, seed):
    g = torch.Generator().manual_seed(seed)
    counts = _count_intermediate(model)
    loss = model(*batch, deterministic=False, generator=g)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, g.get_state(), len(counts)


@pytest.mark.parametrize("tower_dropout", [0.0, 0.1])
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("remat", [True, "mlp"])
def test_remat_matches_no_remat(remat, method, tower_dropout):
    cfg, ref = _model(method, False, tower_dropout)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    batch = _batch(cfg)
    loss0, g0, gen0, n0 = _step(ref, batch, seed=7)
    _, model = _model(method, remat, tower_dropout, state)
    assert model.text_tower.bert.remat == remat == model.image_tower.vit.remat
    loss, g, gen, n = _step(model, batch, seed=7)
    layers = cfg.text_layers + cfg.image_layers
    assert n0 == layers and n == (2 if remat is True else 1) * layers
    assert torch.equal(gen, gen0)  # the caller's generator, as without remat
    np.testing.assert_allclose(loss.numpy(), loss0.numpy(), rtol=2e-5, atol=2e-6)
    assert g.keys() == g0.keys()
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert g.keys() == trained
    tower = [n for n in g if ".bert." in n or ".vit." in n]
    assert tower and all(bool(g[n].abs().sum() > 0) for n in tower
                         if "lora_A" in n or "lora_B" in n or method == "fft")
    for name in g0:
        np.testing.assert_allclose(g[name].numpy(), g0[name].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=name)


def test_remat_does_nothing_without_autograd():
    """Frozen IISAN towers run under ``no_grad``: no checkpoint, one
    ``intermediate`` call per layer, the same taps."""
    kw = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")
    taps = {}
    for remat in (False, True, "mlp"):
        cfg = IISANConfig(**SMALL, **kw, remat_towers=remat)
        model, method = build_uncached_model(
            cfg, generator=torch.Generator().manual_seed(0))
        assert method == "iisan"
        ids, images, tokens, *_ = _batch(cfg)
        counts = _count_intermediate(model)
        taps[remat] = model.encode_taps(images, tokens, False,
                                        torch.Generator().manual_seed(3))
        assert len(counts) == cfg.text_layers + cfg.image_layers
    for remat in (True, "mlp"):
        for a, b in zip(taps[remat], taps[False]):
            assert torch.equal(a, b)
