"""Port parity for the hidden-state cache builder (``cache_builder.py``)
and the store functions it needs (``data/cache_store.py``).

Tiny BERT, Llama and ViT towers (2 layers, width 32, fp32) from one JAX
param tree each, carried into the port by ``load_jax_params``, build the
same catalogue in both packages.  The port's store holds, value for value,
the JAX builder's: fp32 stores within 1e-5 relative to the largest value
(summation order only), fp16 stores within one fp16 ulp of each value
plus that fp32 bound (a value near zero rounds from fp32 numbers that
differ by summation order), int8 stores within one step of the int8 code
(a one-ulp difference of an fp32 state can flip ``rint`` on a tie) and
their scales within 1e-6 relative.  Row 0 (the pad item) stays zero.

The port's own guarantees, bit for bit: a build in three shards (one
shared store through ``create_or_open``, or shard stores merged by
``merge_shard_stores``) equals the single build; a build stopped after two
batches and resumed with ``start_item`` equals it; the ``.pt`` import
writes the JAX importer's files.  The rounding of the two mean poolings:
BERT's ``collect="mean"`` rounds the fp32 mean to the hidden's dtype once,
and the Llama path (and the builder's full-stack fallback) leaves it in
fp32.
"""

import filecmp
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu import cache_builder as jcb
from iisan_tpu.data import cache_store as jcs
from iisan_tpu.models.bert import BertEncoder as JaxBert
from iisan_tpu.models.llama import LlamaEncoder as JaxLlama
from iisan_tpu.models.vit import ViTEncoder as JaxViT
from iisan_tpu_torch import cache_builder as tcb
from iisan_tpu_torch.data import cache_store as tcs
from iisan_tpu_torch.data.images import SyntheticImageStore
from iisan_tpu_torch.models.bert import BertEncoder
from iisan_tpu_torch.models.llama import LlamaEncoder
from iisan_tpu_torch.models.vit import ViTEncoder
from iisan_tpu_torch.tools.build_caches import shard_range
from iisan_tpu_torch.utils.jax_params import load_jax_params

N_ITEMS, NW, BATCH = 23, 6, 4
BERT = dict(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=2,
            intermediate_dim=64, max_position=16)
LLAMA = dict(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_dim=48, rope_theta=10000.0)
VIT = dict(image_size=16, patch_size=8, hidden_dim=32, num_layers=2,
           num_heads=2, intermediate_dim=64)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(params))


def _tokens(seed=0, all_ones=False):
    """(N_ITEMS, 2*NW) packed rows, row 0 the pad item; ragged masks
    unless ``all_ones`` (the Llama builders' layout)."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((N_ITEMS, 2 * NW), np.int32)
    lengths = rng.integers(2, NW + 1, size=N_ITEMS - 1)
    for i, n in enumerate(lengths, 1):
        tokens[i, :n] = rng.integers(1, 100, size=n)
        tokens[i, NW:] = 1 if all_ones else (np.arange(NW) < n)
    return tokens


def _pair(kind, seed=0):
    """(JAX module, params, port module) from one perturbed JAX tree."""
    if kind == "bert":
        jm = JaxBert(dropout=0.0, **BERT)
        args = (jnp.zeros((1, NW), jnp.int32), jnp.ones((1, NW), jnp.int32))
        tm = BertEncoder(dropout=0.0, **BERT)
    elif kind == "llama":
        jm = JaxLlama(**LLAMA)
        args = (jnp.zeros((1, NW), jnp.int32), jnp.ones((1, NW), jnp.int32))
        tm = LlamaEncoder(**LLAMA)
    else:
        jm = JaxViT(**VIT)
        args = (jnp.zeros((1, 16, 16, 3)),)
        tm = ViTEncoder(**VIT)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), *args)["params"], seed)
    load_jax_params(tm, params)
    return jm, params, tm


NAMES = ["<pad>"] + [f"item{i}" for i in range(1, N_ITEMS)]
IMAGES = SyntheticImageStore(16)


def _build(pkg, kind, path, dtype, pool="cls", **kw):
    jm, params, tm = PAIRS[kind]
    tokens = _tokens(all_ones=kind == "llama")
    if pkg == "jax":
        if kind == "vit":
            return jcb.build_image_cache(jm, params, NAMES, IMAGES, str(path),
                                         resize=16, batch=BATCH, dtype=dtype, **kw)
        return jcb.build_text_cache(jm, params, tokens, str(path), batch=BATCH,
                                    pool=pool, dtype=dtype, **kw)
    if kind == "vit":
        return tcb.build_image_cache(tm, NAMES, IMAGES, str(path), batch=BATCH,
                                     dtype=dtype, device="cpu", **kw)
    return tcb.build_text_cache(tm, tokens, str(path), batch=BATCH, pool=pool,
                                dtype=dtype, device="cpu", **kw)


PAIRS = {k: _pair(k, seed) for seed, k in enumerate(("bert", "llama", "vit"))}


def _assert_stores_agree(got, want, dtype):
    g, w = np.asarray(got._arr), np.asarray(want._arr)
    assert g.shape == w.shape and g.dtype == w.dtype
    assert not g[0].any() and not w[0].any()  # the pad row stays zero
    fp32_bound = 1e-5 * np.abs(w.astype(np.float32)).max()
    if dtype == "float32":
        assert np.abs(g - w).max() <= fp32_bound
    elif dtype == "float16":
        ulp = np.spacing(np.maximum(np.abs(g), np.abs(w))).astype(np.float32)
        diff = np.abs(g.astype(np.float32) - w.astype(np.float32))
        assert (diff <= ulp + fp32_bound).all()
    else:
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        gs, ws = np.asarray(got._scales), np.asarray(want._scales)
        assert not gs[0].any()
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("kind,pool", [("bert", "cls"), ("bert", "mean"),
                                       ("llama", "mean"), ("vit", "cls")])
def test_store_matches_the_jax_builder(tmp_path, kind, pool, dtype):
    want = _build("jax", kind, tmp_path / "jax", dtype, pool)
    got = _build("port", kind, tmp_path / "port", dtype, pool)
    assert got.meta.__dict__ == want.meta.__dict__
    _assert_stores_agree(got, want, dtype)
    tcb.verify_cache(got, 3, 32)


def _same_store(got, want):
    np.testing.assert_array_equal(np.asarray(got._arr), np.asarray(want._arr))
    if want._scales is not None:
        np.testing.assert_array_equal(np.asarray(got._scales),
                                      np.asarray(want._scales))


@pytest.mark.parametrize("dtype", ["float16", "int8"])
@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_sharded_builds_equal_the_single_build(tmp_path, kind, dtype):
    """Three shards into one store (``create_or_open``), and three shard
    stores merged, bit for bit the single build."""
    single = _build("port", kind, tmp_path / "single", dtype)
    shared = tmp_path / "shared"
    base = str(tmp_path / "files" / "store.memmap")
    for shard in range(3):
        lo, hi = shard_range(N_ITEMS, shard, 3)
        _build("port", kind, shared, dtype, start_item=lo, end_item=hi)
        path = base + f".shard{shard}"
        _build("port", kind, path, dtype, start_item=lo, end_item=hi)
        tcs.write_shard_range(path, lo, hi)
    _same_store(tcs.HiddenStateCache.open(str(shared)), single)
    _same_store(tcs.merge_shard_stores(base), single)
    assert glob.glob(base + ".shard*") == [] and not os.path.exists(base + ".merging")


def test_merge_refuses_gaps_with_the_jax_message(tmp_path):
    errors = {}
    for pkg, cs in (("port", tcs), ("jax", jcs)):
        base = str(tmp_path / pkg / "c")
        for shard, (lo, hi) in enumerate([(1, 4), (6, 10)]):  # rows 4, 5 missing
            p = base + f".shard{shard}"
            cs.HiddenStateCache.create(p, 10, 2, 8)
            cs.write_shard_range(p, lo, hi)
        with pytest.raises(ValueError, match="do not tile") as exc:
            cs.merge_shard_stores(base)
        errors[pkg] = str(exc.value)
        shutil.rmtree(base + ".shard1")  # and a missing last shard
        with pytest.raises(ValueError, match="stop at 4") as exc:
            cs.merge_shard_stores(base)
        errors[pkg + " tail"] = str(exc.value)
    assert errors["port"] == errors["jax"]
    assert errors["port tail"] == errors["jax tail"]


def test_create_or_open_checks_geometry(tmp_path):
    path = str(tmp_path / "c")
    a = tcs.HiddenStateCache.create_or_open(path, 10, 3, 8, "int8")
    b = tcs.HiddenStateCache.create_or_open(path, 10, 3, 8, "int8")
    b.write_rows(2, np.ones((1, 3, 8), np.float32))
    b.flush()
    assert np.asarray(a._arr)[2].all() and not np.asarray(a._arr)[0].any()
    with pytest.raises(ValueError, match="geometry"):
        tcs.HiddenStateCache.create_or_open(path, 10, 3, 16, "int8")
    # the JAX store opens the port's, meta for meta
    assert jcs.HiddenStateCache.open(path).meta.__dict__ == a.meta.__dict__


@pytest.mark.parametrize("kind", ["bert", "vit"])
def test_start_item_resume_keeps_built_rows(tmp_path, kind):
    """A build stopped after two batches (``end_item``) and resumed from
    the next row equals the single build; a resume keeps the rows before
    ``start_item`` as they are; a resume into nothing raises."""
    single = _build("port", kind, tmp_path / "single", "float16")
    path = tmp_path / "resumed"
    stop = 1 + 2 * BATCH
    _build("port", kind, path, "float16", end_item=stop)
    partial = np.asarray(tcs.HiddenStateCache.open(str(path))._arr).copy()
    assert partial[1:stop].any() and not partial[stop:].any()
    resumed = _build("port", kind, path, "float16", start_item=stop)
    _same_store(resumed, single)
    marked = tcs.HiddenStateCache.create(str(path), N_ITEMS, 3, 32, "float16",
                                         resume=True)
    marked._arr[1:stop] = 7
    marked.flush()
    again = _build("port", kind, path, "float16", start_item=stop)
    assert (np.asarray(again._arr)[1:stop] == 7).all()
    np.testing.assert_array_equal(np.asarray(again._arr)[stop:],
                                  np.asarray(single._arr)[stop:])
    with pytest.raises(FileNotFoundError, match="resume"):
        _build("port", kind, tmp_path / "nothing", "float16", start_item=stop)


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_pt_import_is_byte_identical_to_jax(tmp_path, dtype):
    rng = np.random.default_rng(5)
    pt_dir = tmp_path / "pt"
    os.makedirs(pt_dir)
    for name in NAMES[1:]:
        torch.save(torch.from_numpy(
            (rng.standard_normal((3, 32)) * 2).astype(np.float32)).half(),
            pt_dir / f"bert_{name}.pt")
    got = tcs.import_reference_pt_dir(str(pt_dir), "bert", NAMES,
                                      str(tmp_path / "port.memmap"), dtype)
    want = jcs.import_reference_pt_dir(str(pt_dir), "bert", NAMES,
                                       str(tmp_path / "jax.memmap"), dtype)
    names = [tcs.META_NAME, tcs.DATA_NAME] + ([tcs.SCALES_NAME] if dtype == "int8" else [])
    for name in names:
        assert filecmp.cmp(os.path.join(got.path, name),
                           os.path.join(want.path, name), shallow=False), name
    os.remove(pt_dir / f"bert_{NAMES[5]}.pt")
    with pytest.raises(FileNotFoundError, match="incomplete"):
        tcs.import_reference_pt_dir(str(pt_dir), "bert", NAMES,
                                    str(tmp_path / "broken.memmap"), dtype)
    assert not os.path.exists(tmp_path / "broken.memmap")


def test_mean_pooling_rounds_as_the_jax_builders(tmp_path):
    """In bf16, BERT's ``collect="mean"`` is the fp32 mean of the full
    stack rounded once to bf16; Llama's is the fp32 mean, not rounded, and
    equals the builder's reduction of its full stack bit for bit."""
    _, params, _ = PAIRS["bert"]
    bert = BertEncoder(dropout=0.0, dtype=torch.bfloat16, **BERT)
    load_jax_params(bert, params)
    tokens = torch.as_tensor(_tokens()[1:9])
    ids, mask = tokens[:, :NW], tokens[:, NW:]
    with torch.no_grad():
        got = tcb.text_states(bert, tokens, "mean")
        _, full = bert(ids, mask)
    w = mask.float()[None, :, :, None]
    want = ((full.float() * w).sum(2) / w.sum(2).clamp(min=1)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and bert.collect == "full"
    torch.testing.assert_close(got, want.transpose(0, 1), rtol=0, atol=0)

    _, params, _ = PAIRS["llama"]
    llama = LlamaEncoder(dtype=torch.bfloat16, **LLAMA)
    load_jax_params(llama, params)
    tokens = torch.as_tensor(_tokens(all_ones=True)[1:9])
    with torch.no_grad():
        got = tcb.text_states(llama, tokens, "mean")
        llama.collect = "full"
        _, full = llama(tokens[:, :NW], tokens[:, NW:])
        llama.collect = "mean"  # as the builder leaves it
        fallback = tcb.text_states(_NoCollect(llama), tokens, "mean")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, full.float().mean(2).transpose(0, 1),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, fallback, rtol=0, atol=0)
    assert not torch.equal(got, got.to(torch.bfloat16).float())


class _NoCollect(torch.nn.Module):
    """An encoder without ``collect``: the builder reduces its full stack."""

    def __init__(self, enc):
        super().__init__()
        self.enc = enc

    def forward(self, ids, mask):
        before, self.enc.collect = self.enc.collect, "full"
        try:
            return self.enc(ids, mask)
        finally:
            self.enc.collect = before


def test_builders_need_a_device_or_the_card(tmp_path, monkeypatch):
    """No silent CPU fallback: without ``device`` the build asks for the
    first CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb.build_text_cache(PAIRS["bert"][2], _tokens(), str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb.build_image_cache(PAIRS["vit"][2], NAMES, IMAGES, str(tmp_path / "i"))
