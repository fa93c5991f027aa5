"""The port's image stores (``iisan_tpu_torch/data/images.py``,
``data/fastimage.py``, ``tools/build_lmdb.py``) against the JAX package's.

JPEGs written here by Pillow (non-square RGB, grayscale, one PNG under a
``.jpg`` name, one listed item with no file) go through both packages:

- ``build_lmdb``: the same bad-file list, ``__keys__`` and ``__len__``; both
  ``LmdbImageStore``s give bit-equal pixels from either package's file, at
  resize 16 and 224;
- ``DirImageStore`` on the native path (the same ``fastimage.cc`` and
  libjpeg) is bit-equal, the PNG going through Pillow in both; a
  hypothesis sweep of image and target sides (down- and up-scales,
  non-square and 1-pixel sides, the same size) holds the port's decoder
  and its Pillow resize to the JAX package's;
- an image whose decode raises an error that is not an ``OSError`` is
  listed as bad by both packages' ``build_lmdb``, from a TSV with CRLF
  line ends and a blank line;
- ``is_lmdb_path`` and ``run_from_config``'s store: a data file, a
  ``data.mdb`` directory, a JPEG directory, nothing (synthetic images and a
  warning), a legacy shim (raises);
- the build-lmdb command line prints the JAX lines and writes the same
  bad-file report;
- a record naming ``os.system`` is refused and runs nothing; reading a
  JAX-built store in a fresh interpreter loads no ``iisan_tpu`` module;
- ``ParallelImageLoader`` batches from the LMDB store, pads included, equal
  the JAX loader's;
- one uncached epoch from an LMDB store: both packages' per-step losses
  within 1e-4 relative (``tests/test_torch_train_uncached.py``'s bound);
- the decoder's libjpeg routes (``fastimage.routes``: Pillow's bundled
  libjpeg through the headers in ``csrc/jpeg``, then the system's): each
  route that builds here decodes the fixture JPEGs
  (``iisan_tpu_torch/data/fixtures``) bit-equal to the JAX package's
  native library; without any libjpeg the directory store decodes every
  image with Pillow, as the JAX store does without its native library,
  with a warning naming libjpeg.
"""

import io
import json
import logging
import os
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import iisan_tpu.data.images as jimages
from iisan_tpu.data import fastimage as jfast
from iisan_tpu.tools import build_lmdb as jbuild
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data import fastimage as tfast
from iisan_tpu_torch.data import images as timages
from iisan_tpu_torch.tools import build_lmdb as tbuild
from iisan_tpu_torch.train import pipelines as tpipe

REPO = Path(__file__).resolve().parents[1]
NAMES = ["B0001", "B0002", "B0003", "GRAY1", "PNG01", "B_MISSING"]


def _jpeg_bytes(arr, quality=90, fmt="JPEG"):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A JPEG directory, its items TSV, and both packages' LMDBs of it."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    jpgs = root / "jpgs"
    jpgs.mkdir()
    shapes = {"B0001": (37, 53, 3), "B0002": (300, 200, 3), "B0003": (64, 64, 3),
              "GRAY1": (45, 30), "PNG01": (20, 24, 3)}
    for name, shape in shapes.items():
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        fmt = "PNG" if name == "PNG01" else "JPEG"
        (jpgs / f"{name}.jpg").write_bytes(_jpeg_bytes(arr, fmt=fmt))
    (root / "items.tsv").write_text("".join(f"{n}\tTitle of {n}\n" for n in NAMES))
    bad = {"jax": jimages.build_lmdb(str(root / "items.tsv"), str(jpgs),
                                     str(root / "jax.lmdb")),
           "port": timages.build_lmdb(str(root / "items.tsv"), str(jpgs),
                                      str(root / "port.lmdb"))}
    return root, bad


def test_build_lmdb_records_match_jax(sources):
    root, bad = sources
    assert bad["jax"] == bad["port"] == ["B_MISSING"]
    for db in ("jax.lmdb", "port.lmdb"):
        env = jimages.lmdb.open(str(root / db), subdir=False, readonly=True)
        with env.begin() as txn:
            keys = [pickle.loads(txn.get(b"__keys__")),
                    timages.load_record(txn.get(b"__keys__"))]
            lengths = [pickle.loads(txn.get(b"__len__")),
                       timages.load_record(txn.get(b"__len__"))]
            for name in NAMES[:-1]:  # the full-size pixels, record by record
                a = pickle.loads(txn.get(name.encode())).get_image()
                b = timages.load_record(txn.get(name.encode())).get_image()
                np.testing.assert_array_equal(a, b)
                assert a.ndim == 3 and a.shape[2] == 3
        env.close()
        want = [n.encode() for n in NAMES[:-1]]
        assert keys == [want, want] and lengths == [5, 5]


@pytest.mark.parametrize("resize", [16, 224])
def test_lmdb_stores_bit_equal_either_file(sources, resize):
    root, _ = sources
    for db in ("jax.lmdb", "port.lmdb"):
        jstore = jimages.LmdbImageStore(str(root / db), resize)
        tstore = timages.LmdbImageStore(str(root / db), resize)
        for name in NAMES[:-1]:
            want = jstore.get(name)
            got = tstore.get(name)
            assert got.shape == (resize, resize, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="B_MISSING"):
        tstore.get("B_MISSING")


@pytest.mark.parametrize("resize", [16, 224])
def test_dir_store_native_bit_equal(sources, resize):
    root, _ = sources
    jstore = jimages.DirImageStore(str(root / "jpgs"), resize)
    tstore = timages.DirImageStore(str(root / "jpgs"), resize)
    assert jstore._native
    for name in NAMES[:-1]:
        np.testing.assert_array_equal(tstore.get(name), jstore.get(name))
    # the PNG named .jpg is not libjpeg's: both take Pillow's path
    blob = (root / "jpgs" / "PNG01.jpg").read_bytes()
    assert not tfast.decode_resize(blob, resize)[1]
    with Image.open(root / "jpgs" / "PNG01.jpg") as im:
        want = np.asarray(im.convert("RGB").resize((resize, resize), Image.BILINEAR))
    np.testing.assert_array_equal(tstore.get("PNG01"), want)
    with pytest.raises(FileNotFoundError):
        tstore.get("B_MISSING")


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), resize=st.integers(1, 80),
       gray=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_decode_and_resize_sweep_bit_equal(h, w, resize, gray, seed):
    arr = np.random.default_rng(seed).integers(
        0, 256, (h, w) if gray else (h, w, 3), dtype=np.uint8)
    blob = _jpeg_bytes(arr)
    got, ok = tfast.decode_resize(blob, resize)
    assert ok
    np.testing.assert_array_equal(got, jfast.decode_resize(blob, resize))
    rgb = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    np.testing.assert_array_equal(timages._resize_u8(rgb, resize),
                                  jimages._resize_u8(rgb, resize))
    if (h, w) == (resize, resize):  # Pillow's identity copy
        np.testing.assert_array_equal(timages._resize_u8(rgb, resize), rgb)


@pytest.mark.parametrize("error", [EOFError, struct.error, IndexError])
def test_build_lmdb_lists_any_decode_error_as_bad(sources, tmp_path, monkeypatch, error):
    root, _ = sources
    items = tmp_path / "items.tsv"
    items.write_text("B0001\tA title\r\n\nB0002\tanother\r\nB0003\n")
    open_ = Image.open

    def failing_open(path, *args, **kwargs):
        if str(path).endswith("B0002.jpg"):
            raise error("planted decode failure")
        return open_(path, *args, **kwargs)

    monkeypatch.setattr(Image, "open", failing_open)
    bad = [build(str(items), str(root / "jpgs"), str(tmp_path / f"{i}.lmdb"))
           for i, build in enumerate((jimages.build_lmdb, timages.build_lmdb))]
    assert bad[0] == bad[1] == ["B0002"]
    stores = [timages.LmdbImageStore(str(tmp_path / f"{i}.lmdb"), 16) for i in (0, 1)]
    for name in ("B0001", "B0003"):
        np.testing.assert_array_equal(stores[0].get(name), stores[1].get(name))
    for store in stores:
        with store.env.begin() as txn:
            assert timages.load_record(txn.get(b"__keys__")) == [b"B0001", b"B0003"]


ROUTES = ["data_file", "data_mdb_dir", "jpeg_dir", "nothing", "shim"]


@pytest.mark.parametrize("route", ROUTES)
def test_is_lmdb_path_and_run_from_config_routing(sources, tmp_path, route):
    root, _ = sources
    path = {"data_file": root / "port.lmdb", "jpeg_dir": root / "jpgs",
            "nothing": tmp_path / "missing"}.get(route, tmp_path / route)
    if route == "data_mdb_dir":
        path.mkdir()
        (path / "data.mdb").write_bytes((root / "port.lmdb").read_bytes())
    if route == "shim":
        path.mkdir()
        (path / "data.shimdb").write_bytes(b"IISAN-LMDB-SHIM-v1\n")
    assert timages.is_lmdb_path(str(path)) == jimages.is_lmdb_path(str(path))
    cfg = IISANConfig(root_data_dir=str(path.parent), dataset="",
                      lmdb_data=path.name, CV_resize=16)
    if route == "shim":
        with pytest.raises(RuntimeError, match="legacy pickle-shim"):
            tpipe._image_store(cfg)
        return
    # a handler on the port's logger itself: the run path's logger setup
    # may stop it propagating to pytest's
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("iisan_tpu_torch")
    logger.addHandler(handler)
    try:
        store = tpipe._image_store(cfg)
    finally:
        logger.removeHandler(handler)
    want = {"data_file": timages.LmdbImageStore, "data_mdb_dir": timages.LmdbImageStore,
            "jpeg_dir": timages.DirImageStore,
            "nothing": timages.SyntheticImageStore}[route]
    assert type(store) is want and store.resize == 16
    warned = any("synthetic images" in r.getMessage() for r in records)
    assert warned == (route == "nothing")
    if route != "nothing":
        assert store.get("B0001").shape == (16, 16, 3)


def test_build_lmdb_cli_matches_jax(sources, tmp_path, capsys):
    root, _ = sources
    outs = {}
    for name, cli in (("jax", jbuild), ("port", tbuild)):
        report = tmp_path / f"{name}_bad.tsv"
        cli.main(["--items", str(root / "items.tsv"), "--images", str(root / "jpgs"),
                  "--out", str(tmp_path / f"{name}.lmdb"), "--bad-report", str(report),
                  "--commit-every", "2"])
        lines = capsys.readouterr().out.splitlines()
        outs[name] = ([ln.replace(str(report), "REPORT") for ln in lines[1:]],
                      report.read_text())
        assert lines[0].startswith("note: 'lmdb' package not installed")
    assert outs["port"] == outs["jax"]
    assert outs["port"] == (["done; 1 bad files", "bad-file report: REPORT"],
                            "B_MISSING\n")
    proc = subprocess.run([sys.executable, "-m", "iisan_tpu_torch.tools.build_lmdb",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "--bad-report" in proc.stdout


def test_planted_record_is_refused(tmp_path):
    marker = tmp_path / "ran"

    class Exploit:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    raw = pickle.dumps(Exploit())
    with pytest.raises(pickle.UnpicklingError, match="system"):
        timages.load_record(raw)
    db = str(tmp_path / "planted.lmdb")
    env = timages.lmdb.open(db, subdir=False)
    with env.begin(write=True) as txn:
        txn.put(b"B0001", raw)
    env.close()
    with pytest.raises(pickle.UnpicklingError, match="not an image record"):
        timages.LmdbImageStore(db, 16).get("B0001")
    assert not marker.exists()


def test_reading_a_jax_store_loads_no_jax_package(sources):
    root, _ = sources
    script = (
        "import json, sys\n"
        "from iisan_tpu_torch.data.images import LmdbImageStore\n"
        f"img = LmdbImageStore({str(root / 'jax.lmdb')!r}, 16).get('B0002')\n"
        "mods = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('iisan_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(json.dumps({'shape': list(img.shape), 'modules': mods}))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"shape": [16, 16, 3], "modules": []}


def test_loader_batches_match_jax(sources):
    root, _ = sources
    batches = [["B0001", None, "GRAY1"], [None, None], ["PNG01", "B0002", "B0003", None]]
    want = list(jimages.ParallelImageLoader(
        jimages.LmdbImageStore(str(root / "jax.lmdb"), 24), num_threads=3
    ).iter_batches(batches))
    got = list(timages.ParallelImageLoader(
        timages.LmdbImageStore(str(root / "port.lmdb"), 24), num_threads=3
    ).iter_batches(batches))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[0][1].any() and got[0][0].any()


ITEMS, WORDS, IMAGE = 20, 6, 32
SMALL = dict(batch_size=4, epoch=1, embedding_dim=16,
             side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
             word_embedding_dim=128, image_embedding_dim=128, text_layers=2,
             image_layers=2, CV_resize=IMAGE, num_words_title=WORDS,
             max_seq_len=4, compute_dtype="float32", bert_adapter_down_size=8,
             cv_adapter_down_size=8, eval_batch_size=8, lr=1e-3,
             adapter_cv_lr=1e-3, adapter_bert_lr=1e-3, num_workers=2,
             adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")


def test_uncached_epoch_from_lmdb_tracks_jax(tmp_path):
    from iisan_tpu.config import IISANConfig as JaxConfig
    from iisan_tpu.train.uncached import UncachedTrainer as JaxTrainer
    from iisan_tpu_torch.data.images import synthetic_token_table
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.train.uncached import UncachedTrainer
    from iisan_tpu_torch.utils.jax_params import load_jax_params

    corpus = synthetic_corpus(n_users=8, item_num=ITEMS, max_seq_len=4, seed=0)
    rng = np.random.default_rng(1)
    jpgs = tmp_path / "jpgs"
    jpgs.mkdir()
    for name in corpus.item_names[1:]:
        arr = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        (jpgs / f"{name}.jpg").write_bytes(_jpeg_bytes(arr))
    (tmp_path / "items.tsv").write_text(
        "".join(f"{n}\tt\n" for n in corpus.item_names[1:]))
    db = str(tmp_path / "image.lmdb")
    assert timages.build_lmdb(str(tmp_path / "items.tsv"), str(jpgs), db) == []
    tokens = synthetic_token_table(ITEMS, WORDS, seed=0, vocab=500)
    cfg = JaxConfig(pipeline="uncached", mesh_shape="data:1", tower_dropout=0.0,
                    drop_rate=0.0, **SMALL)
    jt = JaxTrainer(cfg, corpus, tokens, jimages.LmdbImageStore(db, IMAGE))
    tt = UncachedTrainer(cfg, corpus, tokens, timages.LmdbImageStore(db, IMAGE),
                         device="cpu")
    load_jax_params(tt.model, jax.device_get(jt.params))
    jt.run_epoch(1)
    tt.run_epoch(1)
    want = np.asarray(jt._last_step_losses)
    got = tt._last_step_losses.numpy()
    assert got.shape == want.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert torch.is_tensor(tt._last_step_losses)


FIXTURES = REPO / "iisan_tpu_torch" / "data" / "fixtures"


@pytest.mark.parametrize("which", [0, 1])
def test_each_libjpeg_route_is_the_native_path_on_the_fixtures(which):
    routes = tfast.routes()
    if which >= len(routes):  # no Pillow wheel here: only the system route
        which = len(routes) - 1
    name = routes[which][0]
    path, built = tfast.build(names=[name])
    assert built == name
    lib = tfast.load(path)
    fixtures = sorted(FIXTURES.glob("item*.jpg"))
    assert len(fixtures) == 4
    for fx in fixtures:
        blob = fx.read_bytes()
        for resize in (16, 224):
            got, ok = tfast.decode_resize(blob, resize, lib=lib)
            assert ok
            np.testing.assert_array_equal(got, jfast.decode_resize(blob, resize))
    assert "libjpeg" in name
    assert tfast.route() in [r[0] for r in routes]


def test_dir_store_takes_pillow_where_no_libjpeg_is_found(tmp_path, monkeypatch,
                                                          caplog):
    def missing():
        raise tfast.DecoderUnavailable("the JPEG decoder did not build: it "
                                       "needs libjpeg")

    monkeypatch.setattr(tfast, "library", missing)
    for fx in FIXTURES.glob("item*.jpg"):
        (tmp_path / fx.name).write_bytes(fx.read_bytes())
    with caplog.at_level(logging.WARNING, logger="iisan_tpu_torch"):
        store = timages.open_image_source(str(tmp_path), 64)
    assert isinstance(store, timages.DirImageStore) and not store.native
    assert any("libjpeg" in r.getMessage() for r in caplog.records)
    jstore = jimages.DirImageStore(str(tmp_path), 64, use_native=False)
    for fx in sorted(FIXTURES.glob("item*.jpg")):
        np.testing.assert_array_equal(store.get(fx.stem), jstore.get(fx.stem))
