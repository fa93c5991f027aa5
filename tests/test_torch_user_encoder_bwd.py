"""Port parity for the fused user encoder under autograd, and the Philox
dropout bits its train mode draws.

- ``FusedEncoderFn`` on the CPU (plain forward, plain backward) against
  ``jax.grad`` through the JAX ``apply_fused_encoder`` run in interpret
  mode, eval mode (JAX's on-chip dropout bits cannot be reproduced):
  fp32 rtol 5e-4 atol 5e-5 (the JAX package's own kernel-vs-module
  gradient tolerance); bf16 |diff| <= 5e-2 * (max|want| + |want|), per
  tensor (the cast chains round at different places in the two
  frameworks' autodiff).
- ``user_encoder_bwd_plain`` against ``torch.autograd`` of
  ``user_encoder_fwd_plain`` with the same Philox masks, dropout on, fp32:
  |diff| <= 1e-5 * max|want| per tensor (summation order only).
- The regression tests for the two autograd faults the kernels had: a
  kernel result is a tensor written outside autograd, which these tests
  stand in for with the plain result, detached.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iisan_tpu.models.user_encoder import causal_additive_mask as jax_mask
from iisan_tpu.models.user_encoder import UserEncoder as JaxUserEncoder
from iisan_tpu.ops import fused_user_encoder as jfue
from iisan_tpu_torch.models import modules
from iisan_tpu_torch.models.user_encoder import (UserEncoder,
                                                 causal_additive_mask)
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.ops import philox
from iisan_tpu_torch.utils.jax_params import flatten_tree, load_jax_params

B, L, D, H = 16, 10, 64, 2


@pytest.fixture()
def interpret_pallas():
    """Force pallas_call into interpreter mode (CPU-runnable kernels)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def _setup(NL, masked, seed=0, seq=L, batch=B):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, seq, D)) * 0.5).astype(np.float32)
    log_mask = np.ones((batch, seq), np.float32)
    if masked:
        log_mask = (rng.random((batch, seq)) > 0.2).astype(np.float32)
        log_mask[:, -1] = 1.0
        log_mask[0] = 0.0  # an all-pad row: the uniform softmax
    jue = JaxUserEncoder(max_seq_len=seq, num_attention_heads=H, n_layers=NL,
                         dropout=0.0, dtype=jnp.float32, fused=False)
    params = jue.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                      jnp.asarray(log_mask))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    proj = rng.standard_normal((batch, seq, D)).astype(np.float32)
    tue = UserEncoder(D, seq, H, NL, 0.0)
    load_jax_params(tue, params)
    return params, tue, x, log_mask, proj


def _jax_grads(params, x, log_mask, proj, NL, dtype):
    def loss(p, xx):
        y = jfue.apply_fused_encoder(
            p, xx.astype(dtype), jax_mask(jnp.asarray(log_mask)), n_layers=NL,
            n_heads=H, drop_rate=0.0, compute_dtype=dtype)
        return jnp.sum(y.astype(jnp.float32) * proj)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params["transformer_encoder"],
                                            jnp.asarray(x))
    return gp, gx


def _torch_grads(tue, x, log_mask, proj, NL, dtype):
    xx = torch.from_numpy(x).requires_grad_(True)
    flat = fue.flatten_encoder_params(tue.transformer_encoder, NL)
    packed = fue.pack_encoder_params(flat, dtype, differentiable=True)
    y = fue.apply_fused_encoder(packed, xx, causal_additive_mask(
        torch.from_numpy(log_mask)), n_layers=NL, n_heads=H, d_ff=4 * D,
        n_position=x.shape[1], compute_dtype=dtype)
    (y.float() * torch.from_numpy(proj)).sum().backward()
    grads = {n: p.grad for n, p in tue.transformer_encoder.named_parameters()}
    return grads, xx.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("NL,masked", [(1, False), (1, True), (2, False),
                                       (2, True)])
def test_gradients_match_jax_kernel(interpret_pallas, NL, masked, dtype):
    params, tue, x, log_mask, proj = _setup(NL, masked)
    gp_j, gx_j = _jax_grads(params, x, log_mask, proj, NL, dtype)
    gp_t, gx_t = _torch_grads(tue, x, log_mask, proj, NL, getattr(torch, dtype))
    want = {k.replace(".", "/"): np.asarray(v, np.float32)
            for k, v in flatten_tree(gp_j).items()}
    got = {k.replace(".", "/"): v.numpy() for k, v in gp_t.items()}
    got["x"], want["x"] = gx_t.float().numpy(), np.asarray(gx_j, np.float32)
    assert got.keys() == want.keys()
    for name in want:
        assert np.isfinite(got[name]).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                       atol=5e-5, err_msg=name)
        else:
            bound = 5e-2 * (np.abs(want[name]).max() + np.abs(want[name]))
            assert (np.abs(got[name] - want[name]) <= bound).all(), name


@pytest.mark.parametrize("seq", [20, 50])
def test_gradients_match_jax_kernel_long_sequences(interpret_pallas, seq):
    """L = 20 and 50, fp32, two blocks, padded rows."""
    params, tue, x, log_mask, proj = _setup(2, True, seed=1, seq=seq, batch=8)
    gp_j, gx_j = _jax_grads(params, x, log_mask, proj, 2, "float32")
    gp_t, gx_t = _torch_grads(tue, x, log_mask, proj, 2, torch.float32)
    want = {k.replace(".", "/"): np.asarray(v, np.float32)
            for k, v in flatten_tree(gp_j).items()}
    got = {k.replace(".", "/"): v.numpy() for k, v in gp_t.items()}
    got["x"], want["x"] = gx_t.numpy(), np.asarray(gx_j, np.float32)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def _plain_setup(NL=2, seed=3):
    gen = torch.Generator().manual_seed(seed)
    enc = UserEncoder(D, L, H, NL, 0.0, generator=gen)
    x = torch.randn(B, L, D, generator=gen)
    lm = (torch.rand(B, L, generator=gen) > 0.3).float()
    lm[:, -1] = 1.0
    lm[1] = 0.0
    mask3 = causal_additive_mask(lm).reshape(B, L, L)
    packed = fue.pack_encoder_params(
        fue.flatten_encoder_params(enc.transformer_encoder, NL))
    gout = torch.randn(B, L, D, generator=gen)
    return x, mask3, packed, gout, dict(n_layers=NL, n_heads=H, d_ff=4 * D,
                                        n_position=L)


def test_plain_backward_is_autograd_of_plain_forward_with_dropout():
    x, mask3, packed, gout, kw = _plain_setup()
    xx, pp = x.clone().requires_grad_(True), packed.clone().requires_grad_(True)
    y = fue.user_encoder_fwd_plain(xx, mask3, pp, seed=1234, rate=0.1, **kw)
    want = torch.autograd.grad((y * gout).sum(), (xx, pp))
    got = fue.user_encoder_bwd_plain(x, mask3, packed, gout, seed=1234,
                                     rate=0.1, **kw)
    other = fue.user_encoder_bwd_plain(x, mask3, packed, gout, seed=1235,
                                       rate=0.1, **kw)
    for g, o, w in zip(got, other, want):
        bound = 1e-5 * w.abs().max()
        assert torch.isfinite(g).all()
        assert (g - w).abs().max() <= bound
        assert (o - w).abs().max() > 100 * bound  # another seed's masks


def test_train_mode_forward_applies_the_masks():
    x, mask3, packed, _, kw = _plain_setup()
    eval_out = fue.user_encoder_fwd_plain(x, mask3, packed, **kw)
    a = fue.user_encoder_fwd_plain(x, mask3, packed, seed=7, rate=0.1, **kw)
    assert torch.equal(a, fue.user_encoder_fwd_plain(x, mask3, packed, seed=7,
                                                     rate=0.1, **kw))
    assert not torch.equal(a, eval_out)
    assert not torch.equal(a, fue.user_encoder_fwd_plain(
        x, mask3, packed, seed=8, rate=0.1, **kw))


# --- Philox -------------------------------------------------------------


def test_philox_known_answer_and_determinism():
    # Random123's published known-answer vector for Philox4x32-10 with an
    # all-zero counter and key.
    z = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in philox.philox4x32_10(z, z, z, z, 0, 0)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rows = torch.arange(4)
    assert torch.equal(philox.random_bits(99, 3, rows, 1000),
                       philox.random_bits(99, 3, rows, 1000))


def test_philox_keep_fraction_within_four_sigma():
    n, rate = 10 ** 6, 0.1
    keep = philox.dropout_mask(2024, 5, 10, (n // 10,), rate) > 0
    p = 1.0 - rate
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(keep.float().mean()) - p) < 4 * sigma
    kept = philox.dropout_mask(2024, 5, 1, (16,), rate)
    assert set(kept.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.9))}


def test_philox_sites_and_sequences_are_decorrelated():
    n = 200_000
    u = {}
    for key, (site, row) in {"a": (1, 0), "site": (2, 0), "seq": (1, 1),
                             "seed": (1, 0)}.items():
        seed = 11 if key != "seed" else 12
        bits = philox.random_bits(seed, site, torch.tensor([row]), n)[0]
        u[key] = (bits >> 8).double() / 2 ** 24
    for key in ("site", "seq", "seed"):
        corr = torch.corrcoef(torch.stack([u["a"], u[key]]))[0, 1]
        assert abs(float(corr)) < 5 / n ** 0.5, key
        assert float((u["a"] == u[key]).double().mean()) < 1e-3


def test_philox_masks_do_not_depend_on_the_batch_layout():
    full = fue.dropout_masks(31, 0.1, 12, L, D, H, 2)
    head = fue.dropout_masks(31, 0.1, 4, L, D, H, 2)
    # rows 4..11 drawn as their own chunk: the counter holds the absolute
    # sequence index, so the chunk's masks are rows 4..11 of the whole
    chunk = philox.dropout_mask(31, 0, 8, (L, D), 0.1, batch_offset=4)
    assert torch.equal(full["input"][4:], chunk)
    assert torch.equal(full["input"][:4], head["input"])
    assert torch.equal(full["blocks"][1]["probs"][:4], head["blocks"][1]["probs"])
    sites = philox.encoder_sites(2, H)
    numbers = [sites["input"]] + [s for blk in sites["blocks"] for s in
                                  blk["probs"] + [blk["attn_out"], blk["ffn_out"]]]
    assert sorted(numbers) == list(range(len(numbers)))


# --- faults of the previous slice, repaired -----------------------------


def _detached(fn):
    """A stand-in for a kernel launch: the same values, outside autograd."""
    def run(*args, **kwargs):
        return fn(*args, **kwargs).detach()
    return run


def test_encoder_kernel_path_gives_gradients(monkeypatch):
    params, tue, x, log_mask, proj = _setup(2, True)
    module = UserEncoder(D, L, H, 2, 0.0)
    load_jax_params(module, params)
    monkeypatch.setattr(fue, "user_encoder_fwd", _detached(fue.user_encoder_fwd_plain))
    monkeypatch.setattr(UserEncoder, "_use_fused", lambda self, x: True)
    xs, lm = torch.from_numpy(x), torch.from_numpy(log_mask)
    xf, xm = xs.clone().requires_grad_(True), xs.clone().requires_grad_(True)
    (tue(xf, lm) * torch.from_numpy(proj)).sum().backward()
    module.fused = False
    (module(xm, lm) * torch.from_numpy(proj)).sum().backward()
    for (name, p), (_, q) in zip(tue.named_parameters(), module.named_parameters()):
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, q.grad, rtol=5e-4, atol=5e-5)
    torch.testing.assert_close(xf.grad, xm.grad, rtol=5e-4, atol=5e-5)


def test_encoder_train_mode_needs_a_generator_and_follows_it(monkeypatch):
    _, tue, x, log_mask, _ = _setup(1, True)
    tue.dropout = 0.1
    monkeypatch.setattr(UserEncoder, "_use_fused", lambda self, x: True)
    xs, lm = torch.from_numpy(x), torch.from_numpy(log_mask)
    with pytest.raises(ValueError, match="Generator"):
        tue(xs, lm, deterministic=False)
    a = tue(xs, lm, False, torch.Generator().manual_seed(5))
    b = tue(xs, lm, False, torch.Generator().manual_seed(5))
    c = tue(xs, lm, False, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_module_path_dropout_uses_only_its_generator():
    _, tue, x, log_mask, _ = _setup(2, True)
    enc = UserEncoder(D, L, H, 2, 0.1)
    enc.load_state_dict(tue.state_dict())
    xs, lm = torch.from_numpy(x), torch.from_numpy(log_mask)
    state = torch.get_rng_state()
    a = enc(xs, lm, False, torch.Generator().manual_seed(5))
    b = enc(xs, lm, False, torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)  # the global RNG is untouched
    assert torch.equal(a, b)
    assert not torch.equal(a, enc(xs, lm, True))
    h = torch.ones(1000)
    dropped = modules._dropout(h, 0.25, False, torch.Generator().manual_seed(0))
    assert set(dropped.unique().tolist()) <= {0.0, float(h[0] / 0.75)}
    with pytest.raises(ValueError, match="Generator"):
        modules._dropout(h, 0.25, False)
