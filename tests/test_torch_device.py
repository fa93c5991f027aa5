"""Where the port's entry points run: the first CUDA card unless the caller
names another device, and an error (not the CPU) when no card is there.

``torch.cuda.is_available`` is patched, so the tests show the same
behaviour on a machine with or without a card.  ``--device cpu`` and
``device="cpu"`` run on the CPU.
"""

import numpy as np
import pytest
import torch

from iisan_tpu_torch import serve
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.device import resolve_device
from iisan_tpu_torch.models.model import IISANRecModel
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.train.uncached import UncachedTrainer

NO_DEVICE = "pass device='cpu'"


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture()
def artifact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = IISANRecModel(None, 16, 4, 2, 2, 0.0, generator=gen)
    table = torch.randn(11, 16, generator=gen)
    path = str(tmp_path / "rec.npz")
    serve.Recommender(model.eval(), table, 4).save(path)
    return path


def test_resolve_device(no_cuda, monkeypatch):
    with pytest.raises(RuntimeError, match=NO_DEVICE):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


def test_cached_trainer_needs_a_card_or_cpu(no_cuda):
    cfg = IISANConfig(embedding_dim=16, word_embedding_dim=32,
                      image_embedding_dim=32, side_adapter_vit_list="1",
                      side_adapter_bert_list="1", bert_adapter_down_size=8,
                      cv_adapter_down_size=8, compute_dtype="float32")
    corpus = synthetic_corpus(n_users=8, item_num=10)
    taps = np.zeros((11, 2, 32), np.float32)
    with pytest.raises(RuntimeError, match=NO_DEVICE):
        CachedTrainer(cfg, corpus, taps, taps)
    assert CachedTrainer(cfg, corpus, taps, taps, device="cpu").device.type == "cpu"


def test_uncached_trainer_needs_a_card_or_cpu(no_cuda):
    cfg = IISANConfig(embedding_dim=16, word_embedding_dim=128,
                      image_embedding_dim=128, text_layers=1, image_layers=1,
                      side_adapter_vit_list="0", side_adapter_bert_list="0",
                      CV_resize=16, num_words_title=4, max_seq_len=4,
                      bert_adapter_down_size=8, cv_adapter_down_size=8,
                      adapter_type="IISAN", adding_adapter_to="all",
                      fine_tune_to="None")
    data = (synthetic_corpus(n_users=8, item_num=10, max_seq_len=4),
            synthetic_token_table(10, 4), SyntheticImageStore(16))
    with pytest.raises(RuntimeError, match=NO_DEVICE):
        UncachedTrainer(cfg, *data)
    assert UncachedTrainer(cfg, *data, device="cpu").device.type == "cpu"


def test_recommender_load_needs_a_card_or_cpu(no_cuda, artifact):
    with pytest.raises(RuntimeError, match=NO_DEVICE):
        serve.Recommender.load(artifact)
    rec = serve.Recommender.load(artifact, device="cpu")
    assert rec.fused_table.device.type == "cpu"
    assert rec.top_k([[1, 2]], k=3)[0].shape == (1, 3)


def test_serve_main_needs_a_card_or_cpu(no_cuda, artifact, tmp_path):
    inp, out = tmp_path / "seqs.tsv", tmp_path / "recs.tsv"
    inp.write_text("U0\t1 2 3\n")
    args = [artifact, "--input", str(inp), "--out", str(out), "--k", "2"]
    with pytest.raises(RuntimeError, match=NO_DEVICE):
        serve.main(args)
    assert not out.exists()
    assert serve.main(args + ["--device", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == 1
