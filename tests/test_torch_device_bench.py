"""``UncachedTrainer.device_bench`` and the kernels' operation counts
(``iisan_tpu_torch/utils/flops.py``).

An independent count: a dispatch mode written here adds 2 M K N for every
matrix product PyTorch runs (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
``convolution``).

- For each kernel, ``utils/flops.py``'s count of a launch equals that
  count of its plain version at the same shapes (the kernels run outside
  the dispatcher on the card, so the count is added from the shapes).
- ``device_bench`` at a tiny configuration (2 layers, width 128, batch 4;
  IISAN and FFT) on the CPU returns the JAX ``device_bench``'s keys (read
  from its source) with finite positive values, its ``flops_per_step``
  within 1% of the independent count of one training step on its staged
  batch, and leaves the model's parameters, the optimizer and the dropout
  generator as they were.
"""

import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.ops import fused_attention as fa
from iisan_tpu_torch.ops import fused_attn_subblock as fsb
from iisan_tpu_torch.ops import fused_san as fs
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.ops import fused_w8a8 as fw
from iisan_tpu_torch.train.uncached import UncachedTrainer
from iisan_tpu_torch.utils import flops

aten = torch.ops.aten


class ProductCount(TorchDispatchMode):
    """2 M K N for every matrix product dispatched."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm):
            a, b = args[:2] if op in (aten.mm, aten.bmm) else args[1:3]
            batch = a.shape[0] if a.dim() == 3 else 1
            self.total += 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
        elif op is aten.convolution:
            self.total += 2 * out.numel() * args[1][0].numel()
        return out


def _count(fn):
    with ProductCount() as c:
        fn()
    return c.total


def _randn(*shape):
    return torch.randn(*shape, generator=GEN)


GEN = torch.Generator().manual_seed(0)
B, T, D, H, L, F, NL = 3, 7, 16, 4, 5, 32, 2


def _encoder_args():
    flat = [_randn(*s) * 0.1 for s in fue.param_shapes(D, F, NL, L)]
    return (_randn(B, L, D), torch.zeros(B, L, L),
            fue.pack_encoder_params(flat))


def _case(name):
    """(the plain version's call, utils/flops.py's count of a launch)."""
    q, k, v, g = (_randn(B, T, D) for _ in range(4))
    enc = dict(n_layers=NL, n_heads=2, d_ff=F, n_position=L)
    if name == "mha_fwd":
        return (lambda: fa.mha_fwd_plain(q, k, v, None, n_heads=H),
                flops.mha(B, T, D, H))
    if name == "mha_bwd":
        return (lambda: fa.mha_bwd_plain(q, k, v, None, g, n_heads=H),
                flops.mha(B, T, D, H, bwd=True))
    if name == "user_encoder_fwd":
        x, mask3, params = _encoder_args()
        return (lambda: fue.user_encoder_fwd_plain(x, mask3, params, **enc),
                flops.encoder(B, L, D, F, NL))
    if name == "user_encoder_bwd":
        x, mask3, params = _encoder_args()
        return (lambda: fue.user_encoder_bwd_plain(x, mask3, params, x, **enc),
                flops.encoder(B, L, D, F, NL, bwd=True))
    if name == "san_cascade_fwd":
        S, N, K, R = 2, 9, 3, 4
        args = (torch.ones(S, K), torch.ones(S, K), _randn(S, N, K, D),
                _randn(S, K, D, R), _randn(S, K, R), _randn(S, K, R, D),
                _randn(S, K, D), _randn(S, N, D))
        return lambda: fs.san_cascade_fwd_plain(*args), flops.cascade(S, N, K, D, R)
    if name in ("fused_attn_subblock", "fused_attn_subblock_v2"):
        x = _randn(B, T, D)
        w = (_randn(D, 3 * D), _randn(3 * D), _randn(D, D), _randn(D))
        return (lambda: fsb.subblock_fwd_plain(x, *w, None, n_heads=H,
                                               v2=name.endswith("v2")),
                flops.subblock(B, T, D, H))
    M, Kp, N = 11, 32, 24
    xq = torch.randint(-127, 128, (M, Kp), dtype=torch.int8, generator=GEN)
    wt = torch.randint(-127, 128, (N, Kp), dtype=torch.int8, generator=GEN)
    return (lambda: fw.w8a8_gemm_plain(xq, torch.ones(M), wt, torch.ones(N),
                                       None, torch.float32),
            flops.w8a8(M, Kp, N))


def test_every_counting_wrapper_has_a_case():
    names = sorted(w.__name__ for w in flops.kernel_wrappers())
    assert names == sorted(KERNELS + ["san_cascade_streamed_fwd"])


KERNELS = ["mha_fwd", "mha_bwd", "user_encoder_fwd", "user_encoder_bwd",
           "san_cascade_fwd", "fused_attn_subblock", "fused_attn_subblock_v2",
           "w8a8_gemm"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_count_is_its_plain_versions_products(name):
    fn, want = _case(name)
    assert _count(fn) == want > 0


ITEMS, WORDS, IMAGE = 20, 6, 32
SMALL = dict(batch_size=4, epoch=1, embedding_dim=16,
             side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
             word_embedding_dim=128, image_embedding_dim=128, text_layers=2,
             image_layers=2, CV_resize=IMAGE, num_words_title=WORDS,
             max_seq_len=4, compute_dtype="float32", bert_adapter_down_size=8,
             cv_adapter_down_size=8, eval_batch_size=8, lr=1e-3,
             adapter_cv_lr=1e-3, adapter_bert_lr=1e-3, fine_tune_lr_image=1e-3,
             fine_tune_lr_text=1e-3, num_workers=2)
IISAN = dict(adapter_type="IISAN", adding_adapter_to="all", fine_tune_to="None")
JAX_KEYS = ("seconds_per_step", "flops_per_step", "users_per_sec", "memory_bytes")


def test_jax_device_bench_returns_these_keys():
    from iisan_tpu.train.uncached import UncachedTrainer as JaxTrainer

    src = inspect.getsource(JaxTrainer.device_bench)
    returned = src[src.rindex("return {"):]
    assert [k for k in JAX_KEYS if f'"{k}"' in returned] == list(JAX_KEYS)
    assert returned.count('":') == len(JAX_KEYS)


@pytest.mark.parametrize("method", ["iisan", "fft"])
def test_device_bench_counts_the_step_and_restores_the_trainer(method):
    cfg = IISANConfig(pipeline="uncached", tower_dropout=0.0, drop_rate=0.0,
                      **SMALL, **(IISAN if method == "iisan" else {}))
    corpus = synthetic_corpus(n_users=3, item_num=ITEMS, max_seq_len=4, seed=0)
    tr = UncachedTrainer(cfg, corpus, synthetic_token_table(ITEMS, WORDS, seed=0, vocab=500),
                         SyntheticImageStore(IMAGE), device="cpu")
    tr.run_epoch(1)  # Adam has state to put back
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    moments = {k: v["exp_avg"].clone() for k, v in tr.optimizer.state.items()}
    gen = tr.generator.get_state()
    res = tr.device_bench(3)
    assert set(JAX_KEYS) <= res.keys() and res["device"] == "cpu"
    assert all(np.isfinite(res[k]) for k in JAX_KEYS)
    assert res["seconds_per_step"] > 0 and res["memory_bytes"] == 0
    assert res["users_per_sec"] == pytest.approx(4 / res["seconds_per_step"])
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, before[n]), n
    for k, v in tr.optimizer.state.items():
        assert torch.equal(v["exp_avg"], moments[k])
    assert torch.equal(tr.generator.get_state(), gen)
    # the staged batch: the corpus's training rows wrapped to the batch
    seqs = np.resize(corpus.train_seqs, (4, 5))
    images = np.random.default_rng(0).integers(0, 256, (20, IMAGE, IMAGE, 3), np.uint8)
    batch = (torch.as_tensor(seqs), torch.as_tensor(images),
             torch.as_tensor(tr.token_table[seqs.reshape(-1)]),
             torch.as_tensor(np.resize(corpus.train_log_mask, (4, 4))))
    want = _count(lambda: tr.train_step(*batch))
    assert abs(res["flops_per_step"] - want) <= 0.01 * want
