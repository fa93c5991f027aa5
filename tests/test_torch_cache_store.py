"""Port parity for the on-disk hidden-state store (``data/cache_store.py``)
and ``train/pipelines.open_cache``: the port reads and writes the JAX
package's format byte for byte.

Stores written by the JAX ``HiddenStateCache`` (float16, float32, int8)
load bit-equal through the port's ``load_taps`` / ``load_full``, and
stores the port writes load bit-equal through the JAX package's, with the
same files on disk.  Resume and ``open_cache`` (which imports a
reference ``.pt`` directory on first use) behave as the JAX ones.
"""

import filecmp
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig
from iisan_tpu.data import cache_store as jcs
from iisan_tpu.ops.quant import QuantTaps as JaxQuantTaps
from iisan_tpu.train.pipelines import open_cache as jax_open_cache
from iisan_tpu_torch.data import cache_store as tcs
from iisan_tpu_torch.ops.quant import QuantTaps
from iisan_tpu_torch.train.pipelines import open_cache

N_ITEMS, LAYERS, DIM = 23, 6, 40
LAYER_IDS = (0, 2, 3, 5)


def _states(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_ITEMS - 1, LAYERS, DIM)) * 3).astype(np.float32)


def _write(module, path, dtype, states):
    store = module.HiddenStateCache.create(str(path), N_ITEMS, LAYERS, DIM, dtype)
    store.write_rows(1, states[:10])   # two builder chunks
    store.write_rows(11, states[10:])
    store.flush()
    return module.HiddenStateCache.open(str(path))


def _same(got, want):
    if isinstance(want, JaxQuantTaps):
        assert isinstance(got, QuantTaps) and got.out_dtype == want.out_dtype
        np.testing.assert_array_equal(got.q.numpy(), want.q)
        np.testing.assert_array_equal(got.scale.numpy(), want.scale)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float16", "float32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_load_bit_equal_both_ways(tmp_path, dtype, writer):
    states = _states()
    src = _write(jcs if writer == "jax" else tcs, tmp_path / "a", dtype, states)
    other = _write(tcs if writer == "jax" else jcs, tmp_path / "b", dtype, states)
    for name in ("meta.json", "states.bin") + (("scales.bin",) if dtype == "int8" else ()):
        assert filecmp.cmp(tmp_path / "a" / name, tmp_path / "b" / name,
                           shallow=False), name
    del src, other
    j, t = jcs.HiddenStateCache.open(str(tmp_path / "a")), \
        tcs.HiddenStateCache.open(str(tmp_path / "a"))
    assert t.meta.__dict__ == j.meta.__dict__
    for threads in (1, 4):
        _same(t.load_taps(LAYER_IDS, num_threads=threads),
              j.load_taps(LAYER_IDS, num_threads=threads))
    _same(t.load_taps([4], dtype="float16"), j.load_taps([4], dtype="float16"))
    np.testing.assert_array_equal(t.load_full(), j.load_full())
    assert not t.load_full()[0].any()  # the pad item


def test_resume_reopens_and_refuses_a_mismatch(tmp_path):
    path = str(tmp_path / "s")
    with pytest.raises(FileNotFoundError):
        tcs.HiddenStateCache.create(path, N_ITEMS, LAYERS, DIM, "int8", resume=True)
    store = tcs.HiddenStateCache.create(path, N_ITEMS, LAYERS, DIM, "int8")
    store.write_rows(1, _states()[:5])
    store.flush()
    again = tcs.HiddenStateCache.create(path, N_ITEMS, LAYERS, DIM, "int8",
                                        resume=True)
    again.write_rows(6, _states(1)[:3])
    again.flush()
    want = jcs.HiddenStateCache.open(path).load_taps(range(LAYERS))
    got = tcs.HiddenStateCache.open(path).load_taps(range(LAYERS))
    _same(got, want)
    assert got.q[1:9].any() and not got.q[9:].any()
    with pytest.raises(ValueError, match="geometry"):
        tcs.HiddenStateCache.create(path, N_ITEMS, LAYERS, DIM + 1, "int8",
                                    resume=True)


def test_open_cache_finds_the_configured_stores(tmp_path):
    """Stores open as the JAX ``open_cache`` opens them, and a reference
    directory of per-item ``.pt`` files is imported to ``<name>.memmap``
    on first use, byte for byte as the JAX package imports it."""
    cfg = IISANConfig(stored_vector_path=str(tmp_path),
                      cached_text_model="llama_out", cached_image_model="vit_out")
    _write(jcs, tmp_path / "llama_out.memmap", "float16", _states())
    _write(jcs, tmp_path / "vit_out.memmap", "int8", _states(1))
    for which in ("text", "image"):
        got = open_cache(cfg, which, None).load_taps(LAYER_IDS)
        _same(got, jax_open_cache(cfg, which, None).load_taps(LAYER_IDS))

    corpus = SimpleNamespace(
        item_names=["<pad>"] + [f"item{i}" for i in range(1, N_ITEMS)])
    states = _states(2)
    stores = {}
    for pkg, opener in (("port", open_cache), ("jax", jax_open_cache)):
        root = tmp_path / pkg
        os.makedirs(root / "pt_only")
        for i, name in enumerate(corpus.item_names[1:]):
            torch.save(torch.from_numpy(states[i]).half(),
                       root / "pt_only" / f"llama_{name}.pt")
        c = cfg.replace(stored_vector_path=str(root), cached_text_model="pt_only",
                        cached_text_prefix="llama")
        stores[pkg] = opener(c, "text", corpus)
        assert stores[pkg].path == str(root / "pt_only.memmap")
        assert not os.path.exists(str(root / "pt_only.memmap") + ".importing")
        # the second open finds the imported store and imports nothing
        assert open_cache(c, "text", None).meta.__dict__ == stores[pkg].meta.__dict__
    for name in (tcs.META_NAME, tcs.DATA_NAME):
        assert filecmp.cmp(os.path.join(stores["port"].path, name),
                           os.path.join(stores["jax"].path, name), shallow=False)
    full = stores["port"].load_full()
    assert not full[0].any()
    np.testing.assert_array_equal(full[1:], states.astype(np.float16))
    with pytest.raises(FileNotFoundError):
        open_cache(cfg.replace(cached_text_model="missing"), "text", None)
