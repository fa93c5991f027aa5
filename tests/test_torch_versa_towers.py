"""Port parity for the Versa towers: ``models/llama.py``, ``clip_vit.py``
and ``eva.py``.

Each tower (2 layers, width 32-64, 32 x 32 images of 8 x 8 patches, 7
tokens) runs from one JAX param tree, moved off its initial values and
carried across by ``load_jax_params`` (the JAX ``layers.block`` stack
unstacked into the port's per-layer modules; ``export_jax_params`` gives
the tree back), on the same inputs as the JAX module: the hidden stack
and the pooled output within 1e-5 of the largest value in fp32 (summation
order), and max |diff| / max |want| < 0.05 in bf16 (the two frameworks
round the cast chain at different places).  Llama runs grouped-query
attention at 4 q heads over 2 kv heads and 8 over 2 (where tiling the kv
heads instead of repeating each would pair them wrongly) with a padded
row; CLIP with quick_gelu and exact GELU; EVA pre-norm with 2D RoPE and
sub-LN, post-norm, and neither RoPE nor sub-LN.

The importers: ``llama.params_from_hf_torch`` and
``clip_vit.params_from_hf_torch`` on transformers models built from a
config (random weights, no download), and ``eva.params_from_eva_torch`` on
a hand-named ``eva_clip`` state dict, each give the JAX converter's tree
leaf for leaf (exactly: transposes and stacks); loaded into the port, the
transformers models' hidden states come out within 3e-5 (fp32).  The RoPE
tables equal the JAX ones bit for bit, and ``collect`` ("cls", Llama's
"mean") equals the reduction of the full stack bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.models import clip_vit as jclip
from iisan_tpu.models import eva as jeva
from iisan_tpu.models import llama as jllama
from iisan_tpu_torch.models import clip_vit, eva, llama
from iisan_tpu_torch.models.modules import hidden_reducer
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

transformers = pytest.importorskip("transformers")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LLAMA = dict(vocab_size=60, hidden_dim=64, num_layers=2, intermediate_dim=96,
             rope_theta=10000.0)
VISION = dict(image_size=32, patch_size=8, hidden_dim=32, num_layers=2,
              num_heads=2, intermediate_dim=48)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(params))


def _assert_close(got, want, dtype):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = 1e-5 if dtype == "float32" else 0.05
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def _carried(jm, tm, *inputs, seed=0):
    """JAX params (perturbed) loaded into ``tm``; the bridge's export gives
    the same tree back."""
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), *inputs)["params"], seed)
    load_jax_params(tm, params)
    want, got = flatten_tree(params), flatten_tree(export_jax_params(tm))
    assert got.keys() == want.keys()
    for name in want:  # bf16 weights: the JAX values rounded once
        np.testing.assert_allclose(got[name], want[name], atol=0,
                                   rtol=0 if tm.dtype == torch.float32 else 2 ** -8)
    return params


def _llama_inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 60, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 2)])
def test_llama_matches_jax(heads, kv_heads, dtype):
    jdt, tdt = DTYPES[dtype]
    kw = dict(LLAMA, num_heads=heads, num_kv_heads=kv_heads)
    jm, tm = jllama.LlamaEncoder(dtype=jdt, **kw), llama.LlamaEncoder(dtype=tdt, **kw)
    ids, mask = _llama_inputs()
    params = _carried(jm, tm, jnp.asarray(ids), jnp.asarray(mask))
    jlast, jh = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        tlast, th = tm(torch.as_tensor(ids), torch.as_tensor(mask))
    assert th.shape == (3, 3, 7, 64) and th.dtype == tdt
    _assert_close(th, jh, dtype)
    _assert_close(tlast, jlast, dtype)


def _images():
    return np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_jax(act, dtype):
    jdt, tdt = DTYPES[dtype]
    kw = dict(VISION, hidden_act=act)
    jm, tm = jclip.CLIPVisionEncoder(dtype=jdt, **kw), clip_vit.CLIPVisionEncoder(dtype=tdt, **kw)
    imgs = _images()
    params = _carried(jm, tm, jnp.asarray(imgs))
    jp, jh = jm.apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        tp, th = tm(torch.as_tensor(imgs))
    assert th.shape == (3, 2, 17, 32)
    _assert_close(th, jh, dtype)
    _assert_close(tp, jp, dtype)


EVA_VARIANTS = {"prenorm_rope_subln": {}, "postnorm": dict(postnorm=True),
                "no_rope_no_subln": dict(use_rope=False, sub_ln=False)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(EVA_VARIANTS))
def test_eva_matches_jax(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    kw = dict(VISION, **EVA_VARIANTS[variant])
    jm, tm = jeva.EvaVisionEncoder(dtype=jdt, **kw), eva.EvaVisionEncoder(dtype=tdt, **kw)
    imgs = _images()
    params = _carried(jm, tm, jnp.asarray(imgs))
    jp, jh = jm.apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        tp, th = tm(torch.as_tensor(imgs))
    assert th.shape == (3, 2, 17, 32)
    _assert_close(th, jh, dtype)
    _assert_close(tp, jp, dtype)


def test_rope_tables_equal_jax():
    for got, want in zip(llama.rotary_tables(30, 128, 500000.0),
                         jllama.rotary_tables(30, 128, 500000.0)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(eva.rope_2d_tables(16, 128), jeva.rope_2d_tables(16, 128)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="head_dim % 4"):
        eva.rope_2d_tables(4, 6)


@pytest.mark.parametrize("tower,collect", [("llama", "cls"), ("llama", "mean"),
                                           ("clip", "cls"), ("eva", "cls")])
def test_collect_equals_the_full_stack_reduction(tower, collect):
    """bf16; Llama's "mean" in fp32 over the mask, not rounded."""
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(3)
    if tower == "llama":
        tm = llama.LlamaEncoder(dtype=torch.bfloat16, num_heads=4, num_kv_heads=2,
                                generator=gen, **LLAMA)
        ids, mask = (torch.as_tensor(a) for a in _llama_inputs())
        args = (ids, mask)
    else:
        cls = clip_vit.CLIPVisionEncoder if tower == "clip" else eva.EvaVisionEncoder
        tm = cls(dtype=torch.bfloat16, generator=gen, **VISION)
        args, mask = (torch.as_tensor(_images()),), None
    with torch.no_grad():
        _, full = tm(*args)
        tm.collect = collect
        last, got = tm(*args)
    reduce = hidden_reducer(collect, mask)
    want = torch.stack([reduce(h) for h in full])
    assert got.dtype == (torch.float32 if collect == "mean" else torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_versa_towers_take_device_dtype_and_generator():
    """Weights in the compute dtype (norms fp32), drawn from the generator:
    the same seed gives the same tower."""
    def build(seed):
        return eva.EvaVisionEncoder(dtype=torch.bfloat16, device="cpu",
                                    generator=torch.Generator().manual_seed(seed),
                                    **VISION)
    a, b, c = build(0), build(0), build(1)
    assert a.layers[0].w1.kernel.dtype == torch.bfloat16
    assert a.layers[0].norm1.scale.dtype == torch.float32
    assert a.cls_token.dtype == torch.bfloat16
    assert torch.equal(a.layers[1].w3.kernel, b.layers[1].w3.kernel)
    assert not torch.equal(a.layers[1].w3.kernel, c.layers[1].w3.kernel)
    lm = llama.LlamaEncoder(dtype=torch.bfloat16, num_heads=4, num_kv_heads=2, **LLAMA)
    assert lm.embed_tokens.embedding.dtype == torch.bfloat16
    assert lm.layers[0].q_proj.kernel.dtype == torch.bfloat16
    assert lm.norm.scale.dtype == torch.float32


# ---- the importers --------------------------------------------------------


def _same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(jax.device_get(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)


def test_llama_import_from_transformers():
    cfg = transformers.LlamaConfig(
        vocab_size=60, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=32,
        rope_theta=10000.0, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.LlamaModel(cfg).eval()
    sd = hf.state_dict()
    tree = llama.params_from_hf_torch(sd, 2, prefix="")
    _same_tree(tree, jllama.params_from_hf_torch(sd, 2, prefix=""))
    tm = llama.encoder_from_hf_config(cfg)
    assert (tm.num_heads, tm.layers[0].num_kv_heads) == (4, 2)
    load_jax_params(tm, tree)
    ids = torch.randint(0, 60, (2, 9), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = hf(input_ids=ids, output_hidden_states=True).hidden_states
        _, got = tm(ids, torch.ones_like(ids))
    assert got.shape[0] == len(want)
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i].numpy(), w.numpy(), atol=3e-5,
                                   err_msg=f"hidden state {i}")


def test_clip_import_from_transformers():
    cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(cfg).eval()
    sd = hf.state_dict()
    tree = clip_vit.params_from_hf_torch(sd, 2)
    _same_tree(tree, jclip.params_from_hf_torch(sd, 2))
    tm = clip_vit.encoder_from_hf_config(cfg)
    load_jax_params(tm, tree)
    imgs = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = hf(pixel_values=imgs, output_hidden_states=True)
        pooled, got = tm(imgs.permute(0, 2, 3, 1))
    for i, w in enumerate(out.hidden_states):
        np.testing.assert_allclose(got[i].numpy(), w.numpy(), atol=3e-5,
                                   err_msg=f"hidden state {i}")
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=3e-5)


def eva_state_dict(dim=32, layers=2, inter=48, patch=8, grid=4, sub_ln=True,
                   prefix="visual.", seed=0):
    """Random tensors under the public ``eva_clip`` names."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    sd = {"patch_embed.proj.weight": r(dim, 3, patch, patch),
          "patch_embed.proj.bias": r(dim), "cls_token": r(1, 1, dim),
          "pos_embed": r(1, grid * grid + 1, dim),
          "norm.weight": 1 + r(dim), "norm.bias": r(dim)}
    for i in range(layers):
        b = f"blocks.{i}."
        for n in ("norm1", "norm2") + (("attn.inner_attn_ln",) if sub_ln else ()):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = 1 + r(dim), r(dim)
        for n in ("q_proj", "k_proj", "v_proj"):
            sd[b + f"attn.{n}.weight"] = r(dim, dim)
        sd[b + "attn.q_bias"], sd[b + "attn.v_bias"] = r(dim), r(dim)
        sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"] = r(dim, dim), r(dim)
        for n in ("w1", "w2"):
            sd[b + f"mlp.{n}.weight"], sd[b + f"mlp.{n}.bias"] = r(inter, dim), r(inter)
        sd[b + "mlp.w3.weight"], sd[b + "mlp.w3.bias"] = r(dim, inter), r(dim)
        if sub_ln:
            sd[b + "mlp.ffn_ln.weight"], sd[b + "mlp.ffn_ln.bias"] = 1 + r(inter), r(inter)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("sub_ln", [True, False])
def test_eva_import_from_an_eva_clip_state_dict(sub_ln):
    sd = eva_state_dict(sub_ln=sub_ln)
    tree = eva.params_from_eva_torch(sd, 2, sub_ln=sub_ln)
    _same_tree(tree, jeva.params_from_eva_torch(sd, 2, sub_ln=sub_ln))
    kw = dict(VISION, sub_ln=sub_ln)
    tm, jm = eva.EvaVisionEncoder(**kw), jeva.EvaVisionEncoder(**kw)
    load_jax_params(tm, tree)
    imgs = _images()
    jp, jh = jm.apply({"params": tree}, jnp.asarray(imgs))
    with torch.no_grad():
        tp, th = tm(torch.as_tensor(imgs))
    _assert_close(th, jh, "float32")
    _assert_close(tp, jp, "float32")
