"""The reference against the port on the CPU at a tiny size.

The port runs its plain versions on CPU tensors.  With the compute dtype
float32 and dropout off, each training cell's compared numbers read the
arithmetic's rounding alone; the dropout draws the reference makes again
(hidden ``torch.rand`` masks, Philox masks of the attention and of the
user encoder) are held to the port's own at their addresses.
"""

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.reference import model as M
from h100_bench.reference.philox import keep_mask

TOWER = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 1,
         "intermediate_size": 256}


def tiny(workload: str, dtype: str = "float32") -> dict:
    """Overrides that shrink a cell to seconds on the CPU, widths and all."""
    if "serve" in workload:
        return {"config": {"user_encoder": {"dropout": 0.0}},
                "traffic": {"catalogue_rows": 500, "batch_users": 8, "requests": 4,
                            "check_requests": 2, "reference_block": 4}}
    config = {"text_tower": dict(TOWER, title_tokens=8, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0),
              "image_tower": dict(TOWER, image_size=32),
              "user_encoder": {"dropout": 0.0}, "compute_dtype": dtype,
              "corpus": {"users": 40, "items": 30, "title_vocab": 1000}}
    if workload.startswith("iisan"):
        config["san"] = {"taps": [0, 1, 2]}
    return {"config": config, "traffic": {"batch_users": 4, "order_steps": 16,
                                          "reference_block": 8}}


@pytest.mark.parametrize("workload", ["iisan-base.uncached-train", "fft-base.train-b32"])
def test_training_cell_matches_the_port_in_float32(workload):
    line = harness.run_cell(workload, 2 ** 31 + 5, 0.3, False, device="cpu",
                            overrides=tiny(workload))
    check = {k: v[0] for k, v in line["check"].items()}
    assert line["correct"]
    assert check["loss_gap"] < 1e-5 and check["grad_norm_gap"] < 1e-5
    assert check["change_norm_gap"] < 1e-5 and check["frozen_change"] == 0.0


def test_serving_cell_matches_the_port():
    line = harness.run_cell("iisan-base.serve-topk-4m", 2 ** 33 + 1, 0.3, False,
                            device="cpu", overrides=tiny("iisan-base.serve-topk-4m"))
    assert line["correct"] and line["check"]["rank_gap"][0] < 1e-6


def test_philox_masks_are_the_ports():
    from iisan_tpu_torch.ops import philox

    for seed, site, rate in ((7, 0, 0.1), (2 ** 31 - 2, 37, 0.5), (12345, 143, 0.1)):
        want = philox.dropout_mask(seed, site, 5, (30, 30), rate, batch_offset=3) > 0
        got = keep_mask(seed, [site], torch.arange(3, 8), (30, 30), rate)[:, 0]
        assert torch.equal(got, want)


def test_hidden_dropout_draws_are_the_ports():
    from iisan_tpu_torch.models.modules import _dropout

    port = torch.Generator().manual_seed(99)
    ours = M.Dropout(99, "cpu")
    for shape in ((4, 8, 16), (3, 5)):
        kept = _dropout(torch.ones(shape), 0.1, False, port) != 0
        assert torch.equal(ours.hidden(shape, 0.1), kept)
    assert ours.kernel_seed() == int(torch.randint(0, 2 ** 31 - 1, (1,), generator=port))


def test_attention_dropout_is_the_kernels():
    """The reference's attention with the Philox masks of (seed, layer) is
    the port's plain version of the train-mode attention kernel."""
    from iisan_tpu_torch.ops.fused_attention import mha_fwd_plain

    g = torch.Generator().manual_seed(0)
    B, T, D, H, layer, seed, rate = 3, 17, 128, 2, 5, 4242, 0.1
    q, k, v = (torch.randn((B, T, D), generator=g) for _ in range(3))
    bias = torch.where(torch.rand((B, T), generator=g) < 0.2, -1e9, 0.0)
    want = mha_fwd_plain(q, k, v, bias, n_heads=H, seed=seed, rate=rate, layer=layer)
    keep = keep_mask(seed, range(layer * H, layer * H + H), torch.arange(B), (T, T), rate)
    got = M.attention(q, k, v, H, M.Precision(), bias[:, None, None, :], keep, rate)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_user_encoder_dropout_is_the_kernels():
    """The reference SASRec in train mode is the port's plain version of
    the fused encoder kernel under the same seed."""
    from iisan_tpu_torch.models.user_encoder import UserEncoder, causal_additive_mask
    from iisan_tpu_torch.ops import fused_user_encoder as fue

    from h100_bench.weights import _user_encoder_spec, make_weights

    E, L, blocks, heads, seed, rate = 64, 10, 2, 2, 777, 0.1
    W = make_weights(_user_encoder_spec(E, L, blocks), 3, "cpu")
    enc = UserEncoder(E, L, heads, blocks, rate, torch.float32, fused=False)
    params = dict(enc.named_parameters(prefix="user_encoder"))
    with torch.no_grad():
        for n, w in W.items():
            params[n].copy_(w)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((6, L, E), generator=g)
    log_mask = torch.ones((6, L))
    log_mask[:, :3] = 0
    packed = fue.pack_encoder_params(
        fue.flatten_encoder_params(enc.transformer_encoder, blocks), torch.float32)
    want = fue.user_encoder_fwd_plain(
        x, causal_additive_mask(log_mask)[:, 0], packed, n_layers=blocks,
        n_heads=heads, d_ff=4 * E, n_position=L, seed=seed, rate=rate)
    ue = {"blocks": blocks, "heads": heads, "dropout": rate, "layer_norm_eps": 1e-6}
    got = M.user_encoder(W, x, log_mask, ue, M.Precision(), seed)
    assert np.allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
