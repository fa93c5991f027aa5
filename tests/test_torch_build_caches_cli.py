"""The port's cache-build command line (``tools/build_caches.py``) against
the JAX package's.

A dataset written here (20 items, 10 users), a BERT tokenizer built from a
``vocab.txt`` written here and saved beside each text checkpoint, and tiny
checkpoints made here with random weights (transformers ``LlamaModel``,
``CLIPVisionModel`` and ``BertModel`` from configs, ``save_pretrained``;
an EVA directory of ``config.json`` and a hand-named ``eva_clip`` state
dict): both packages' ``main`` build the caches of one Llama + CLIP pair
and of one BERT + EVA pair, and their stores agree as
``tests/test_torch_cache_builder.py`` holds the builders (fp32 within
1e-5 of the largest value; fp16 within one ulp plus that bound).  Both
take the port's synthetic images (the JAX store seeds from the salted
``hash``).

Also: ``--num-shards 2 --shard-files`` and ``--finalize-shards`` give the
single build bit for bit, and ``--finalize-shards`` runs with transformers
unimportable; an ``--image-source`` that exists but cannot be opened (a
legacy pickle-shim directory, a garbage ``data.mdb``) is refused; without
``--device`` the build asks for the first CUDA card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import iisan_tpu.data.images as jimages
from iisan_tpu.tools import build_caches as jcli
from iisan_tpu_torch.data.cache_store import HiddenStateCache
from iisan_tpu_torch.data import images as timages
from iisan_tpu_torch.data.images import SyntheticImageStore
from iisan_tpu_torch.tools import build_caches as tcli

transformers = pytest.importorskip("transformers")
from test_torch_versa_towers import eva_state_dict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORDS = "versa test item number alpha beta gamma delta scope lens probe".split()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    with open(root / "items.tsv", "w") as f:
        for i in range(20):
            f.write(f"V{i:03d}\tversa test item number {WORDS[4 + i % 7]}\n")
    with open(root / "users.tsv", "w") as f:
        for u in range(10):
            seq = " ".join(f"V{int(x):03d}" for x in rng.integers(0, 20, int(rng.integers(6, 12))))
            f.write(f"U{u}\t{seq}\n")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + WORDS + [str(i) for i in range(10)]) + "\n")
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab))
    torch.manual_seed(0)
    transformers.LlamaModel(transformers.LlamaConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=64,
        rope_theta=10000.0)).save_pretrained(root / "llama")
    tok.save_pretrained(root / "llama")
    transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8)).save_pretrained(root / "clip")
    transformers.BertModel(transformers.BertConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40)).save_pretrained(root / "bert")
    tok.save_pretrained(root / "bert")
    os.makedirs(root / "eva")
    torch.save(eva_state_dict(), root / "eva" / "pytorch_model.bin")
    with open(root / "eva" / "config.json", "w") as f:
        json.dump({"vision_config": dict(
            image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=48, state_dict_prefix="visual.")}, f)
    return root


def _argv(root, out, text, image, dtype, *extra):
    text_arch, image_arch = ("llama" if text == "llama" else "bert"), image
    return ["--dataset", str(root), "--items", "items.tsv", "--behaviors", "users.tsv",
            "--text-model", str(root / text), "--text-arch", text_arch,
            "--image-model", str(root / image), "--image-arch", image_arch,
            "--out", str(out), "--batch", "8", "--num-words-title", "12",
            "--resize", "32", "--dtype", dtype, *extra]


def _agree(got, want, dtype):
    g, w = np.asarray(got._arr), np.asarray(want._arr)
    assert g.shape == w.shape and g.dtype == w.dtype and not g[0].any()
    bound = 1e-5 * np.abs(w.astype(np.float32)).max()
    diff = np.abs(g.astype(np.float32) - w.astype(np.float32))
    if dtype == "float16":
        bound = bound + np.spacing(np.maximum(np.abs(g), np.abs(w))).astype(np.float32)
    assert (diff <= bound).all()


@pytest.mark.parametrize("text,image,dtype,stores", [
    ("llama", "clip", "float32", ("llama_outputs", "clip_outputs")),
    ("bert", "eva", "float16", ("bert_outputs", "eva_clip_outputs"))])
def test_both_clis_build_the_same_stores(models, tmp_path, monkeypatch, text,
                                         image, dtype, stores):
    monkeypatch.setattr(jimages, "SyntheticImageStore", SyntheticImageStore)
    jcli.main(_argv(models, tmp_path / "jax", text, image, dtype))
    tcli.main(_argv(models, tmp_path / "port", text, image, dtype, "--device", "cpu"))
    for name in stores:
        want = HiddenStateCache.open(str(tmp_path / "jax" / f"{name}.memmap"))
        got = HiddenStateCache.open(str(tmp_path / "port" / f"{name}.memmap"))
        assert got.meta == want.meta and got.meta.n_layers == 3
        _agree(got, want, dtype)
    # the two shard stores, merged, are the single build bit for bit
    shards = tmp_path / "shards"
    for shard in ("0", "1"):
        tcli.main(_argv(models, shards, text, image, dtype, "--device", "cpu",
                        "--num-shards", "2", "--shard-id", shard, "--shard-files"))
    assert len(list(shards.glob("*.shard*"))) == 4
    tcli.main(["--out", str(shards), "--finalize-shards"])
    for name in stores:
        merged = HiddenStateCache.open(str(shards / f"{name}.memmap"))
        single = HiddenStateCache.open(str(tmp_path / "port" / f"{name}.memmap"))
        np.testing.assert_array_equal(np.asarray(merged._arr), np.asarray(single._arr))
    assert not list(shards.glob("*.shard*"))


@pytest.mark.parametrize("source", ["lmdb", "jpeg_dir"])
def test_both_clis_build_image_states_from_an_image_source(models, tmp_path, source):
    """``--image-source`` an LMDB the port's ``build_lmdb`` wrote, or the
    JPEG directory itself: both packages' image stores agree as above."""
    from PIL import Image

    rng = np.random.default_rng(5)
    jpgs = tmp_path / "jpgs"
    jpgs.mkdir()
    names = [ln.split("\t")[0] for ln in (models / "items.tsv").read_text().splitlines()]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
            jpgs / f"{name}.jpg", quality=90)
    src = jpgs
    if source == "lmdb":
        src = tmp_path / "image.lmdb"
        assert timages.build_lmdb(str(models / "items.tsv"), str(jpgs), str(src)) == []
    jcli.main(_argv(models, tmp_path / "jax", "bert", "clip", "float32",
                    "--image-source", str(src)))
    tcli.main(_argv(models, tmp_path / "port", "bert", "clip", "float32",
                    "--device", "cpu", "--image-source", str(src)))
    want = HiddenStateCache.open(str(tmp_path / "jax" / "clip_outputs.memmap"))
    got = HiddenStateCache.open(str(tmp_path / "port" / "clip_outputs.memmap"))
    assert got.meta == want.meta
    _agree(got, want, "float32")
    synthetic = timages.SyntheticImageStore(32).get(names[0])
    assert not np.array_equal(timages.open_image_source(str(src), 32).get(names[0]),
                              synthetic)


def test_finalize_shards_needs_no_transformers(tmp_path):
    from iisan_tpu_torch.data.cache_store import write_shard_range

    base = str(tmp_path / "bert_outputs.memmap")
    for shard, (lo, hi) in enumerate([(1, 5), (5, 10)]):
        st = HiddenStateCache.create(base + f".shard{shard}", 10, 2, 8)
        st.write_rows(lo, np.full((hi - lo, 2, 8), shard + 1, np.float32))
        st.flush()
        write_shard_range(base + f".shard{shard}", lo, hi)
    script = ("import sys; sys.modules['transformers'] = None\n"
              "from iisan_tpu_torch.tools.build_caches import main\n"
              f"main(['--out', {str(tmp_path)!r}, '--finalize-shards'])\n"
              "assert sys.modules['transformers'] is None\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    full = HiddenStateCache.open(base).load_full()
    assert (full[1:5] == 1).all() and (full[5:] == 2).all() and not full[0].any()
    with pytest.raises(SystemExit):
        tcli.main(["--out", str(tmp_path / "empty"), "--finalize-shards"])


def test_image_source_is_refused_and_the_card_is_the_default(models, tmp_path,
                                                             monkeypatch):
    argv = _argv(models, tmp_path / "out", "bert", "clip", "float16")
    shim = tmp_path / "shim"
    shim.mkdir()
    (shim / "data.shimdb").write_bytes(b"IISAN-LMDB-SHIM-v1\n")
    with pytest.raises(RuntimeError, match="legacy pickle-shim"):
        tcli.main(argv + ["--device", "cpu", "--image-source", str(shim)])
    garbage = tmp_path / "garbage.lmdb"
    garbage.mkdir()
    (garbage / "data.mdb").write_bytes(b"\x00" * 64)
    with pytest.raises(timages.lmdb.Error):
        tcli.main(argv + ["--device", "cpu", "--image-source", str(garbage)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not (tmp_path / "out" / "bert_outputs.memmap").exists()


def test_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "iisan_tpu_torch.tools.build_caches",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "--finalize-shards" in proc.stdout
