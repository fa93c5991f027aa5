"""Port parity for the parameter-efficient tower baselines
(``models/peft.py``, the LoRA and Houlsby options of ``models/{bert,vit}
.py``, and their trainability masks).

``LoRADense`` and ``HoulsbyAdapter`` alone, then BERT and ViT encoders (2
layers, width 128, 2 heads; 32 x 32 images, 6-word titles with a padded
row) with LoRA of rank 8 on q and v or Houlsby adapters of width 8, run
from the same JAX parameters as the JAX modules.  The parameters are moved
off their initial values, so ``lora_B`` is nonzero (at its zero init the
delta, and A's gradient, would be zero and test nothing).  Dropout is off.
Compared: the output (the hidden stack and last output for the encoders)
and the gradients of a fixed random projection of it with respect to the
input, ``lora_A``, ``lora_B`` and every adapter parameter.  fp32 to
rtol 1e-4, atol 1e-5; bf16 to max |diff| / max |want| < 0.05, each
tensor on its own (the tolerances of ``test_torch_towers.py``).  A
gradient's atol is taken in units of its tensor's largest |value| where
that exceeds 1: a standard-normal cotangent over the hidden stack gives
weight gradients up to about 65, where fp32 rounding through two layers
(flax's LayerNorm takes E[x^2] - E[x]^2) reaches 1e-6 of the scale.

The masks: ``trainable_mask`` on models built by ``build_uncached_model``
for ``lora``, ``houslby``, ``houlsby`` and ``bitfit`` equals the JAX
package's predicate on the same tree, each method finds its own
parameters, and the built models' trees are the JAX models' (names and
shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.models.bert import BertEncoder as JaxBert
from iisan_tpu.models.peft import HoulsbyAdapter as JaxHoulsby
from iisan_tpu.models.peft import LoRADense as JaxLoRA
from iisan_tpu.models.vit import ViTEncoder as JaxViT
from iisan_tpu.train.peft_masks import trainable_mask as jax_trainable_mask
from iisan_tpu.train.uncached import build_uncached_model as jax_build
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.models.bert import BertEncoder
from iisan_tpu_torch.models.peft import HoulsbyAdapter, LoRADense, lora_a_init
from iisan_tpu_torch.models.vit import ViTEncoder
from iisan_tpu_torch.train.peft_masks import trainable_mask
from iisan_tpu_torch.train.uncached import build_uncached_model
from iisan_tpu_torch.utils.jax_params import (export_jax_params, flatten_tree,
                                              load_jax_params)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DIMS = dict(hidden_dim=128, num_layers=2, num_heads=2, intermediate_dim=512)
PEFT = {"lora": dict(lora_rank=8), "houlsby": dict(houlsby_down=8),
        "houlsby_gelu": dict(houlsby_down=8, adapter_activation="GELU")}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(params))


def _assert_close(got, want, dtype, what="", scaled=False):
    """fp32: rtol 1e-4, atol 1e-5, the atol in units of the tensor's
    largest |value| where that exceeds 1 and ``scaled`` (gradients);
    bf16: max |diff| / max |want| < 0.05."""
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    if dtype == "float32":
        unit = max(1.0, float(np.abs(want).max())) if scaled else 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * unit,
                                   err_msg=what)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < 0.05, what


def _peft_leaves(flat):
    """The names of the LoRA factors and adapter parameters of a flat tree."""
    return sorted(n for n in flat if "lora_" in n or "adapter" in n)


def _check_module(jm, tm, params, args, dtype, grad_inputs=True, cot_seed=5):
    """Forward and input/parameter gradients of ``sum(out * W)`` for a
    JAX module ``jm`` and its port ``tm`` (``params`` loaded into it).
    ``args``: numpy inputs; float ones are given in the dtype and, with
    ``grad_inputs``, differentiated; ``out`` is the output (an encoder's
    hidden stack)."""
    jdt, tdt = DTYPES[dtype]
    diff = [i for i, a in enumerate(args) if a.dtype == np.float32]
    jargs = [jnp.asarray(a, jdt) if i in diff else a for i, a in enumerate(args)]
    if not grad_inputs:
        diff = []

    def pick(out):
        return out[1] if isinstance(out, tuple) else out

    want = pick(jm.apply({"params": params}, *jargs))
    cot = np.random.default_rng(cot_seed).standard_normal(want.shape).astype(
        np.float32)

    def loss(p, *xs):
        a = list(jargs)
        for i, x in zip(diff, xs):
            a[i] = x
        return jnp.sum(pick(jm.apply({"params": p}, *a)).astype(jnp.float32) * cot)

    jgrads = jax.grad(loss, argnums=tuple(range(1 + len(diff))))(
        params, *[jargs[i] for i in diff])
    load_jax_params(tm, params)
    targs = [torch.tensor(a).to(tdt) if a.dtype == np.float32
             else torch.tensor(a) for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    got = pick(tm(*targs))
    _assert_close(got, want, dtype, "forward")
    (got.float() * torch.tensor(cot)).sum().backward()
    for n, (i, g) in enumerate(zip(diff, jgrads[1:])):
        _assert_close(targs[i].grad, g, dtype, f"input {n} gradient", True)
    jflat = flatten_tree(jax.device_get(jgrads[0]))
    tparams = dict(tm.named_parameters())
    names = _peft_leaves(jflat)
    for name in names:
        _assert_close(tparams[name].grad, jflat[name], dtype, name, True)
    return names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_dense_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    jm = JaxLoRA(48, rank=4, dtype=jdt)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 1)
    assert np.abs(params["lora_B"]).min() > 0
    names = _check_module(jm, LoRADense(64, 48, 4, tdt), params, [x], dtype)
    assert names == ["lora_A", "lora_B"]


def test_lora_dense_init_and_rank_zero():
    g = torch.Generator().manual_seed(0)
    m = LoRADense(256, 32, 16, generator=g)
    assert set(dict(m.named_parameters())) == {"base.kernel", "base.bias",
                                               "lora_A", "lora_B"}
    assert not m.lora_B.any() and m.lora_A.shape == (256, 16)
    bound = float(np.sqrt(6.0 / 256))
    assert m.lora_A.abs().max() <= bound and m.lora_A.abs().max() > 0.9 * bound
    # at init the delta is exactly zero: the layer is its base
    x = torch.randn(4, 256, generator=g)
    torch.testing.assert_close(m(x), m.base(x), rtol=0, atol=0)
    a = lora_a_init((8, 2), generator=torch.Generator().manual_seed(3))
    assert a.shape == (8, 2) and a.abs().max() <= np.sqrt(6.0 / 8)
    assert set(dict(LoRADense(8, 4, 0).named_parameters())) == {"base.kernel",
                                                               "base.bias"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
def test_houlsby_adapter_matches_jax(dtype, activation):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(2).standard_normal((3, 5, 64)).astype(np.float32)
    jm = JaxHoulsby(8, activation, jdt)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], 3)
    names = _check_module(jm, HoulsbyAdapter(64, 8, activation, tdt), params,
                          [x], dtype)
    assert names == []  # the adapter's own leaves carry no "adapter" prefix
    tm = HoulsbyAdapter(64, 8, activation, tdt)
    load_jax_params(tm, params)
    xt = torch.tensor(x).to(tdt)
    tm(xt).float().sum().backward()
    jg = flatten_tree(jax.device_get(jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x, jdt))
                          .astype(jnp.float32)))(params)))
    for name, p in tm.named_parameters():
        _assert_close(p.grad, jg[name], dtype, name, True)


def test_houlsby_adapter_init():
    m = HoulsbyAdapter(512, 64, generator=torch.Generator().manual_seed(0))
    for fc in (m.fc_down, m.fc_up):
        assert not fc.bias.any()
        assert abs(float(fc.kernel.detach().std()) - 1e-2) < 1e-3


def _bert_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), np.int32)
    mask[1, 4:] = 0
    return [ids, mask]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("peft", list(PEFT))
def test_bert_encoder_with_peft_matches_jax(peft, dtype):
    jdt, tdt = DTYPES[dtype]
    args = _bert_inputs()
    jm = JaxBert(vocab_size=1000, dtype=jdt, collect="cls", **DIMS, **PEFT[peft])
    params = _perturbed(jm.init(jax.random.PRNGKey(0), *args)["params"], 4)
    tm = BertEncoder(vocab_size=1000, dtype=tdt, collect="cls", **DIMS,
                     **PEFT[peft])
    names = _check_module(jm, tm, params, args, dtype)
    per_layer = 4 if peft == "lora" else 8
    assert len(names) == 2 * per_layer, names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("peft", list(PEFT))
def test_vit_encoder_with_peft_matches_jax(peft, dtype):
    jdt, tdt = DTYPES[dtype]
    images = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    jm = JaxViT(image_size=32, dtype=jdt, collect="cls", **DIMS, **PEFT[peft])
    params = _perturbed(jm.init(jax.random.PRNGKey(0), images)["params"], 5)
    tm = ViTEncoder(image_size=32, dtype=tdt, collect="cls", **DIMS, **PEFT[peft])
    # (the images' gradient, summed over the patch projection, is not
    # compared: no baseline trains its input)
    names = _check_module(jm, tm, params, [images], dtype, grad_inputs=False)
    per_layer = 4 if peft == "lora" else 8
    assert len(names) == 2 * per_layer, names


def test_lora_layers_leave_the_subblock_route():
    """A LoRA layer built with a subblock route runs the module path of
    q and v (``fused_mha`` on the card), as the JAX layers do."""
    from iisan_tpu_torch.models.bert import subblock_route

    for route in ("subblock", "subblock_v2"):
        enc = BertEncoder(vocab_size=50, fused_attention=route, lora_rank=4,
                          **DIMS)
        assert not subblock_route(enc.fused, enc.quant, enc.lora_rank)
        assert subblock_route(route, "none", 0)
        ids = torch.ones((2, 6), dtype=torch.long)
        last, _ = enc(ids, torch.ones_like(ids))
        assert torch.isfinite(last).all()


SMALL = dict(embedding_dim=16, side_adapter_vit_list="0,1",
             side_adapter_bert_list="0,1", word_embedding_dim=128,
             image_embedding_dim=128, text_layers=2, image_layers=2,
             CV_resize=32, num_words_title=6, max_seq_len=4,
             bert_adapter_down_size=8, cv_adapter_down_size=4)
OWN = {"lora": ("lora_A", "lora_B"),
       "houslby": ("attention_adapter", "output_adapter"),
       "houlsby": (), "bitfit": ("bias",)}


@pytest.mark.parametrize("method", list(OWN))
def test_trainable_mask_finds_each_methods_parameters(method):
    cfg = IISANConfig(**SMALL, adapter_type=method, adding_adapter_to="all")
    model, got_method = build_uncached_model(cfg)
    assert got_method == method
    mask = trainable_mask(model, method)
    want = flatten_tree(jax_trainable_mask(export_jax_params(model), method))
    assert mask == {k: bool(v) for k, v in want.items()}
    tower = {n: v for n, v in mask.items() if ".bert." in n or ".vit." in n}
    own = {n for n in tower if any(m in n for m in OWN[method])}
    assert all(tower[n] for n in own) and not any(
        v for n, v in tower.items() if n not in own)
    assert (len(own) > 0) == (method != "houlsby")
    if method in ("lora", "houslby"):
        # the built model's tree is the JAX model's, name for name
        jmodel, _ = jax_build(JaxConfig(**SMALL, adapter_type=method,
                                        adding_adapter_to="all"))
        L = cfg.max_seq_len
        jparams = jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((2, L + 1), jnp.int32), jnp.zeros((2 * (L + 1), 32, 32, 3)),
            jnp.zeros((2 * (L + 1), 12), jnp.int32), jnp.zeros((2, L)),
            jnp.ones((21,)) / 21, deterministic=True)["params"]
        jshapes = {k: tuple(v.shape) for k, v in flatten_tree(
            jax.device_get(jparams)).items()}
        assert jshapes == {n: tuple(p.shape) for n, p in model.named_parameters()}
