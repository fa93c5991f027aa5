"""The port's spans (``utils/profiling.annotate``) on the CPU.

Under a ``torch.profiler`` with CPU activity, one uncached IISAN and one
FFT ``train_step`` record ``iisan.step`` and, inside it and in this order,
the step's phases: ``iisan.inputs``, the two towers, ``iisan.san``
(IISAN only), ``iisan.user_encoder``, ``iisan.loss``, ``iisan.optimizer``
(``zero_grad``), ``iisan.backward`` and ``iisan.optimizer`` again.  The
CPU runs the module paths of the tower attention and the user encoder, so
no ``iisan.attention`` is recorded there and the backward holds no span;
the autograd functions of the fused paths (whose kernels run only on the
card; here their plain versions) record theirs in the forward and in the
backward.  One ``Recommender.top_k`` records its phases inside
``iisan.top_k``.  The profiler changes no result: the loss, the updated
weights and the returned ids and scores are bitwise those of a run without
it.  Sizes are those of ``test_torch_train_uncached.py`` and
``test_torch_serve.py``.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
from iisan_tpu_torch.data.synthetic import synthetic_corpus
from iisan_tpu_torch.models.model import IISANRecModel
from iisan_tpu_torch.ops import fused_attention as fa
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.serve import Recommender
from iisan_tpu_torch.train.uncached import UncachedTrainer

ITEMS, WORDS, IMAGE = 20, 6, 32
SMALL = dict(batch_size=4, epoch=1, embedding_dim=16,
             side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
             word_embedding_dim=128, image_embedding_dim=128, text_layers=2,
             image_layers=2, CV_resize=IMAGE, num_words_title=WORDS,
             max_seq_len=4, compute_dtype="float32", bert_adapter_down_size=8,
             cv_adapter_down_size=8, eval_batch_size=8, lr=1e-3,
             adapter_cv_lr=1e-3, adapter_bert_lr=1e-3, fine_tune_lr_image=1e-3,
             fine_tune_lr_text=1e-3, num_workers=1)
METHODS = {"iisan": dict(adapter_type="IISAN", adding_adapter_to="all",
                         fine_tune_to="None"),
           "fft": {}}
TOWERS = ("iisan.image_tower", "iisan.text_tower")


def host_spans(prof):
    """The host's ``iisan.`` ranges (the profiler mirrors each on the
    device's timeline too, where the card is traced)."""
    return [e for e in prof.events()
            if e.name.startswith("iisan.") and e.device_type == DeviceType.CPU]


def spans(prof):
    """[(name, parent)] of every ``iisan.`` range, in start order; the
    parent is the innermost ``iisan.`` range around it (None at the top)."""
    out = []
    for e in sorted(host_spans(prof), key=lambda e: e.time_range.start):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("iisan."):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer(method, device="cpu"):
    cfg = IISANConfig(pipeline="uncached", **SMALL, **METHODS[method])
    corpus = synthetic_corpus(n_users=8, item_num=ITEMS, max_seq_len=4, seed=0)
    tokens = synthetic_token_table(ITEMS, WORDS, seed=0, vocab=500)
    tr = UncachedTrainer(cfg, corpus, tokens, SyntheticImageStore(IMAGE),
                         device=device)
    users = np.arange(SMALL["batch_size"])
    flat = corpus.train_seqs[users].reshape(-1)
    images = next(iter(tr.loader.iter_batches([tr._names(flat)])))
    batch = (tr._put(corpus.train_seqs[users]), tr._put(images),
             tr._put(tr.token_table[flat]), tr._put(corpus.train_log_mask[users]))
    return tr, batch


@pytest.mark.parametrize("method", ["iisan", "fft"])
def test_train_step_records_its_phases_and_changes_nothing(method):
    plain, batch = _trainer(method)
    traced, _ = _trainer(method)
    loss = plain.train_step(*batch)
    with cpu_profile() as prof:
        traced_loss = traced.train_step(*batch)
    assert torch.equal(loss, traced_loss)
    for (name, p), q in zip(plain.model.named_parameters(),
                            traced.model.parameters()):
        assert torch.equal(p, q), name

    got = spans(prof)
    assert got[0] == ("iisan.step", None)
    top = [n for n, parent in got if parent == "iisan.step"]
    san = ["iisan.san"] if method == "iisan" else []
    assert top == (["iisan.inputs", *TOWERS, *san, "iisan.user_encoder",
                    "iisan.loss", "iisan.optimizer", "iisan.backward",
                    "iisan.optimizer"])
    assert all(parent in (None, "iisan.step") for _, parent in got)
    assert [n for n, _ in got].count("iisan.step") == 1
    # the CPU runs the plain attention and encoder: no span in the backward
    assert "iisan.attention" not in {n for n, _ in got}


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["iisan", "fft"])
def test_fused_paths_record_their_spans_in_the_backward_on_the_card(method):
    """On the card the towers' attention and the user encoder run their
    autograd functions: their spans open in the forward inside the towers'
    and the encoder's, and, where the towers train, again in the backward
    (on the autograd engine's thread), inside ``iisan.backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    tr, batch = _trainer(method, "cuda")
    tr.train_step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(*batch)
        torch.cuda.synchronize()
    events = host_spans(prof)
    (bwd,) = [e.time_range for e in events if e.name == "iisan.backward"]
    inside = [e.name for e in events
              if e.name != "iisan.backward" and bwd.start <= e.time_range.start <= bwd.end]
    forward = [n for n, parent in spans(prof) if n == "iisan.attention"
               and parent in TOWERS]
    assert forward and "iisan.user_encoder" in inside
    if method == "fft":
        assert inside.count("iisan.attention") == len(forward)
    else:
        assert "iisan.attention" not in inside


def test_fused_autograd_functions_record_their_spans_forward_and_backward():
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 5, 16, requires_grad=True) for _ in range(3))
    with cpu_profile() as prof:
        fa.fused_mha(q, k, v, 2).sum().backward()
    assert spans(prof) == [("iisan.attention", None)] * 2

    d, L = 16, 4
    enc = IISANRecModel(san=None, embedding_dim=d, max_seq_len=L,
                        num_attention_heads=2, transformer_block=1,
                        drop_rate=0.0).user_encoder
    x = torch.randn(3, L, d, requires_grad=True)
    packed = fue.pack_encoder_params(
        fue.flatten_encoder_params(enc.transformer_encoder, 1), torch.float32,
        differentiable=True)
    mask = torch.zeros(3, 1, L, L)
    with cpu_profile() as prof:
        fue.apply_fused_encoder(packed, x, mask, n_layers=1, n_heads=2,
                                d_ff=4 * d, n_position=L,
                                compute_dtype=torch.float32).sum().backward()
    assert spans(prof) == [("iisan.user_encoder", None)]
    assert x.grad is not None


def test_top_k_records_its_phases_and_changes_nothing():
    torch.manual_seed(0)
    d, L = 16, 4
    model = IISANRecModel(san=None, embedding_dim=d, max_seq_len=L,
                          num_attention_heads=2, transformer_block=2,
                          drop_rate=0.0).eval()
    table = torch.randn(50, d)
    table[0] = 0.0
    rec = Recommender(model, table, L)
    seqs = [[1, 5, 9], [2, 2, 7, 12, 3], list(range(1, 14)), [49]]
    ids, scores = rec.top_k(seqs, k=5)
    with cpu_profile() as prof:
        traced_ids, traced_scores = rec.top_k(seqs, k=5)
    assert np.array_equal(ids, traced_ids) and np.array_equal(scores, traced_scores)
    got = spans(prof)
    assert got == [("iisan.top_k", None),
                   ("iisan.top_k.prep", "iisan.top_k"),
                   ("iisan.top_k.upload", "iisan.top_k"),
                   ("iisan.top_k.encode", "iisan.top_k"),
                   ("iisan.user_encoder", "iisan.top_k.encode"),
                   ("iisan.top_k.score", "iisan.top_k"),
                   ("iisan.top_k.mask", "iisan.top_k"),
                   ("iisan.top_k.select", "iisan.top_k"),
                   ("iisan.top_k.fetch", "iisan.top_k")]
