"""The port's run path (``train/pipelines.py``) against the JAX package's.

A dataset in the reference's TSV format is written here (the
``tiny_dataset`` of tests/test_pipelines.py: 30 items, 15 users), with a
BERT tokenizer built from a ``vocab.txt`` written here and tiny fp32
hidden-state stores (taps 1,3 of 13 rows, width 32).  On it:

- ``load_corpus`` gives the JAX package's ``Corpus`` and token table, with
  and without the items TSV (arrays equal);
- ``run_from_config`` trains each of the four pipelines it dispatches on
  the CPU (cached, cached_asym, id, uncached on synthetic images) to finite
  losses, and refuses an uncached run whose image source exists but
  cannot be opened (a garbage ``data.mdb``, a legacy pickle-shim);
- the served numbers agree: JAX parameters (the JAX trainer's initial
  ones, moved off their init) written by the JAX package's
  ``save_reference_checkpoint`` and read by the port's
  ``--pretrained_recsys_model x.pt --mode test`` give the JAX
  ``evaluate_split``'s test HR@10 / nDCG@10 within 1e-6 (fp32, both on the
  CPU), for the cached and the ID families; and the port's ``.pt`` read by
  the JAX importer is the port's tree, array for array;
- ``run_sweep`` expands and labels a dry grid as the JAX one does.
"""

import os

import jax
import numpy as np
import pytest

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.data import preprocess as jprep
from iisan_tpu.train import pipelines as jpipe
from iisan_tpu.utils import torch_import as jimport
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data import images as timages
from iisan_tpu_torch.data.cache_store import HiddenStateCache
from iisan_tpu_torch.train import pipelines as tpipe
from iisan_tpu_torch.utils import torch_import as timport
from iisan_tpu_torch.utils.jax_params import export_jax_params, flatten_tree

transformers = pytest.importorskip("transformers")

WORDS = "title of item alpha beta gamma delta".split()


def write_dataset(root, n_items=30, n_users=15, items=True):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    if items:
        with open(os.path.join(root, "items.tsv"), "w") as f:
            for i in range(n_items):
                f.write(f"I{i:04d}\tTitle of item {i}\n")
    with open(os.path.join(root, "users.tsv"), "w") as f:
        for u in range(n_users):
            n = int(rng.integers(5, 12))
            seq = " ".join(f"I{int(x):04d}" for x in
                           rng.integers(0, n_items, size=n))
            f.write(f"U{u}\t{seq}\n")


def write_tokenizer(root):
    """A BERT tokenizer where load_tokenizer looks first."""
    path = os.path.join(root, "pretrained_models", "bert", "bert_base_uncased")
    os.makedirs(path, exist_ok=True)
    vocab = os.path.join(path, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS + [str(i) for i in range(10)]) + "\n")
    transformers.BertTokenizerFast(vocab_file=vocab).save_pretrained(path)


def write_store(path, n_rows, n_layers, dim, seed):
    store = HiddenStateCache.create(path, n_rows, n_layers, dim, "float32")
    rng = np.random.default_rng(seed)
    store.write_rows(1, rng.standard_normal(
        (n_rows - 1, n_layers, dim)).astype("float32"))
    store.flush()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_path")
    write_dataset(str(root))
    write_tokenizer(str(root))
    vecs = root / "vecs"
    for name, layers, dim, seed in (("bert_outputs", 13, 32, 1),
                                    ("vit_outputs", 13, 32, 2),
                                    ("llama_embeddings", 9, 48, 3),
                                    ("vit_tiny_outputs", 5, 24, 4)):
        write_store(str(vecs / f"{name}.memmap"), 31, layers, dim, seed)
    return root


def fields(dataset, **kw):
    return {**dict(
        root_data_dir=str(dataset), dataset="", behaviors="users.tsv",
        news="items.tsv", images="items.tsv", epoch=2, batch_size=8,
        embedding_dim=16, side_adapter_vit_list="1,3",
        side_adapter_bert_list="1,3", compute_dtype="float32",
        eval_batch_size=16, word_embedding_dim=32, image_embedding_dim=32,
        stored_vector_path=str(dataset / "vecs"),
        log_dir=str(dataset / "logs"), ckpt_dir=str(dataset / "ckpts"),
        save_checkpoints=False), **kw}


ASYM = dict(pipeline="cached_asym", text_layers=8, text_embedding_dim=48,
            image_layers=4, image_embedding_dim=24,
            side_adapter_bert_list="1,3,5,7", side_adapter_vit_list="1,3",
            cached_text_model="llama_embeddings", cached_text_prefix="llama",
            cached_image_model="vit_tiny_outputs")
UNCACHED = dict(pipeline="uncached", adapter_type="IISAN",
                adding_adapter_to="all", fine_tune_to="None", text_layers=2,
                image_layers=2, CV_resize=32, num_words_title=6,
                side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
                bert_adapter_down_size=8, cv_adapter_down_size=8,
                lmdb_data="no_images.lmdb")


@pytest.mark.parametrize("items", [True, False])
@pytest.mark.parametrize("pipeline", ["cached", "uncached"])
def test_load_corpus_is_the_jax_one(dataset, tmp_path, items, pipeline):
    if items:
        root = dataset
    else:
        write_dataset(str(tmp_path), items=False)
        root = tmp_path
    kw = fields(root, **(UNCACHED if pipeline == "uncached" else {}))
    if pipeline == "uncached" and not items:
        # titles are needed and absent: both refuse
        for pkg, cfg in ((jpipe, JaxConfig(**kw)), (tpipe, IISANConfig(**kw))):
            with pytest.raises(FileNotFoundError):
                pkg.load_corpus(cfg)
        return
    jc, jt = jpipe.load_corpus(JaxConfig(**kw))
    tc, tt = tpipe.load_corpus(IISANConfig(**kw))
    assert tc.item_names == jc.item_names and tc.item_num == jc.item_num
    for name, value in vars(jc).items():
        if isinstance(value, np.ndarray):
            got = getattr(tc, name)
            assert got.dtype == value.dtype and np.array_equal(got, value), name
    if pipeline == "uncached":
        assert tt.shape == (tc.item_num + 1, 12)
        np.testing.assert_array_equal(tt, jt)
    else:
        assert tt is None and jt is None


def test_load_tokenizer_reads_only_local_files(tmp_path):
    cfg = IISANConfig(root_data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bert_base_uncased"):
        tpipe.load_tokenizer(cfg)


@pytest.mark.parametrize("pipeline", ["cached", "cached_asym", "id", "uncached"])
def test_run_from_config_trains_each_pipeline(dataset, pipeline):
    extra = {"cached_asym": ASYM, "uncached": UNCACHED,
             "id": dict(item_tower="id")}.get(pipeline, {})
    cfg = IISANConfig(**fields(dataset, **extra))
    trainer, res = tpipe.run_from_config(cfg, device="cpu")
    want = {"cached": "CachedTrainer", "cached_asym": "CachedTrainer",
            "id": "IDTrainer", "uncached": "UncachedTrainer"}[pipeline]
    assert type(trainer).__name__ == want
    assert res.epochs_run == 2 and np.isfinite(res.losses).all()
    assert res.test_metrics is not None
    if pipeline == "cached_asym":
        assert (trainer.model.san.kt, trainer.model.san.kc) == (5, 3)


def test_uncached_run_with_an_image_source_raises(dataset, tmp_path):
    (tmp_path / "image.lmdb").mkdir()
    (tmp_path / "image.lmdb" / "data.mdb").write_bytes(b"\x00" * 64)
    kw = fields(dataset, **{**UNCACHED, "lmdb_data": str(tmp_path / "image.lmdb")})
    with pytest.raises(timages.lmdb.Error):
        tpipe.run_from_config(IISANConfig(**kw), device="cpu")
    (tmp_path / "shim").mkdir()
    (tmp_path / "shim" / "data.shimdb").write_bytes(b"IISAN-LMDB-SHIM-v1\n")
    kw = fields(dataset, **{**UNCACHED, "lmdb_data": str(tmp_path / "shim")})
    with pytest.raises(RuntimeError, match="legacy pickle-shim"):
        tpipe.run_from_config(IISANConfig(**kw), device="cpu")


def test_run_from_config_needs_a_card_unless_told(dataset):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_from_config(IISANConfig(**fields(dataset, item_tower="id")))


def jax_trainer(cfg, family):
    """The JAX trainer of ``family`` over the dataset, its parameters moved
    off their init (gates and biases start at constants)."""
    corpus, _ = jpipe.load_corpus(cfg)
    if family == "id":
        from iisan_tpu.train.id_pipeline import IDTrainer

        tr = IDTrainer(cfg, corpus)
    else:
        from iisan_tpu.train.cached import CachedTrainer

        tr = CachedTrainer(cfg, corpus,
                           jpipe.open_cache(cfg, "image", corpus).load_taps(
                               cfg.san_image_taps()),
                           jpipe.open_cache(cfg, "text", corpus).load_taps(
                               cfg.san_text_taps()))
    rng = np.random.default_rng(7)
    tr.params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(tr.params))
    return tr


@pytest.mark.parametrize("family", ["cached", "id"])
def test_reference_pt_warm_start_serves_the_jax_numbers(dataset, tmp_path,
                                                        family):
    kw = fields(dataset, **({"item_tower": "id"} if family == "id" else {}))
    jt = jax_trainer(JaxConfig(**kw), family)
    want = jt.evaluate_split("test")
    path = str(tmp_path / "epoch-3.pt")
    jimport.save_reference_checkpoint(jt.params, path)

    cfg = IISANConfig(**kw).replace(pretrained_recsys_model=path, mode="test")
    trainer, res = tpipe.run_from_config(cfg, eval_only=True, device="cpu")
    assert res is None
    got = trainer.evaluate_split("test")
    assert abs(got[0] - want[0]) <= 1e-6 and abs(got[1] - want[1]) <= 1e-6
    assert 0 < want[1] <= want[0]

    # and back: the port's .pt, read by the JAX importer, is the port's tree
    ours = export_jax_params(trainer.model)
    back = str(tmp_path / "epoch-4.pt")
    timport.save_reference_checkpoint(ours, back)
    theirs = flatten_tree(jimport.params_from_reference_checkpoint(back))
    ours = flatten_tree(ours)
    assert theirs.keys() == ours.keys()
    for name, value in ours.items():
        np.testing.assert_array_equal(np.asarray(theirs[name]), value, name)


def test_reference_import_refuses_what_the_jax_one_refuses():
    import torch

    sd = {"user_encoder.transformer_encoder.position_embedding.weight":
          torch.zeros(10, 4),
          "user_encoder.transformer_encoder.layer_norm.weight": torch.ones(4),
          "user_encoder.transformer_encoder.layer_norm.bias": torch.zeros(4)}
    for extra in ({"mm_encoder.bert_encoder.x": torch.zeros(1),
                   "mm_encoder.bert_adapter_list.0.fc_down.weight": torch.zeros(1)},
                  {"something.else": torch.zeros(1)}):
        for pkg in (jimport, timport):
            with pytest.raises(pkg.ImportError_):
                pkg.params_from_reference_checkpoint({**sd, **extra})


def test_sweep_dry_grid_and_labels(monkeypatch):
    from iisan_tpu import sweep as jsweep
    from iisan_tpu_torch import sweep as tsweep

    grid = {"lr": [1e-4, 2e-4], "seed": [1, 2, 3]}
    assert tsweep.expand_grid(grid) == jsweep.expand_grid(grid)
    res = tsweep.run_sweep({"item_tower": "id"}, {"lr": [1e-4, 2e-4]},
                           dry_run=True)
    assert [p for p, r in res] == [{"lr": 1e-4}, {"lr": 2e-4}]
    assert all(r is None for _, r in res)

    seen = []

    def fake_run(cfg, eval_only=False, device=None):
        seen.append((cfg.label_screen, device))
        return None, None

    monkeypatch.setattr(tpipe, "run_from_config", fake_run)
    tsweep.run_sweep({}, {"dataset": ["Dataset/Scientific"]}, device="cpu")
    assert seen == [("datasetDataset-Scientific", "cpu")]
