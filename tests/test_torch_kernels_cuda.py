"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere (the
kernels have no CPU mode).  The file imports no JAX, so on a machine
without it the tests run with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX).

Shapes cover the serving and training paths' and awkward ones: batch 1
and 3, all-pad sequences, one block, row counts that are not a multiple of
the cascade kernels' 64-row tile (1, 37, 63, 65), widths that are not a
multiple of 64 or 8, bottlenecks from 1 to 320 (48 and 96 do not divide
256), and the geometries the cascade kernels once refused (D = 3,584 and
4,096 bf16, 2,048 fp32, R = 320).  Train mode uses the
same Philox masks in kernel and plain version, so it is held to the same
bounds as eval mode.

Tolerances.  fp32: |kernel - plain| <= 1e-4 * (1 + |plain|) (summation
order differs over up to 768 terms).  bf16 user encoder: the same form at
5e-2, as the JAX package's own bf16 encoder test (a value may round to the
neighbouring bf16 number, 2^-8 relative, and LayerNorm carries it on).
Encoder backward: gx and each parameter gradient per tensor, |diff| <=
tol * (max|plain| + |plain|), tol 1e-4 fp32 and 5e-2 bf16 (the kernel
sums each sequence's gradient then the sequences; the plain version sums
all rows at once).  In bf16 a ReLU input that rounds across zero on one
side only passes or stops a whole element of the FFN's gradient, which can
put one weight- or bias-gradient column past that bound by itself: at
20 x 128 the bf16 cases of the CUDA-core kernel broke it (4 and 16
sequences, dropout on) while fp32 agreed to 1e-4 on the same shapes and
code path, so 20 x 128 is held in fp32 only
(``test_user_encoder_train_kernels_match_plain_l20_d128``).  The
tensor-core kernel's products round like the plain version's cuBLAS ones
in all but a few elements, and those differences, one bf16 ulp each, move
2-4 of the 164K ReLU decisions of a 64-sequence batch (at |pre| <=
0.0044); so the bf16 backward is held to the plain backward taken at the
kernel's own ReLU decisions (``_bwd_reference``), which the plain version
accepts only where the kernel's FFN input (read back) explains them,
within four bf16 ulps of the operands' scale and for at most 16 elements
or one in 4,096 (``iisan_tpu_torch.testing``; its CPU tests plant
decisions past each limit), and to the same bound.  bf16 cascade: element by element, four bf16 ulps of the row's largest
|carry| plus 1e-3 (``fused_san.carry_tolerance``): the carry is additive
across the K steps, so a one-ulp rounding difference at a large
intermediate value survives into a final value that may be small.  The
cascade inputs make every term move the carry by O(1) (wd ~ N(0, 1/D),
wu ~ N(0, 1/R), biases ~ N(0, 0.25)), so a wrong term breaks the bound;
tests/test_torch_fused_san.py shows that it does for planted faults.
Both cascade kernels repeat bit for bit (z is summed over a cluster in
rank order), and #3's planted faults (bd dropped, GELU for ReLU, step 0's
weights, one cluster rank's partial of z dropped) break the bound.
The streamed cascade (bf16 only) is held to the same bound at the Versa
text geometry (K=7, D=8192, R=64 and 128), the eva width (K=6, D=5120)
and at awkward ones (D odd, R from 1 to 320), repeats bit for bit, and
four planted faults (bd dropped, the other activation, step 0's weights,
g and 1-g swapped) break it; ``fused_cascade`` launches the kernel the
JAX package's dispatch names, at the once-refused geometries too.
Attention kernels (mha_fwd, mha_bwd): per tensor, |diff| <= tol * (max|plain|
+ |plain|), tol 1e-4 fp32 and 2e-2 (forward) / 5e-2 (backward) bf16: a
probability may round to the neighbouring bf16 value on one side only; the
mask replay kernel is bit-equal to its plain version.  The bf16 backward
runs its cluster design at every edge of it, one to eight key blocks (1
to 512 keys), and its split design (a query-tile and a key-tile kernel)
past it (513 to 4,097 keys, and ViT-tiny's 192 wide at 577), each case's
design asserted and two launches bit-equal; every #6 instance has HGMMA
(wgmma) and no HMMA (mma.sync) in its SASS; every cluster instance can be
scheduled, and one that cannot raises with no launch.  Planted faults (the key bias
dropped on a padded batch, the backward run with another seed, the
softmax row term dropped from the backward; the dkv kernel's dropout
element transposed, the row term taken as FlashAttention's rowsum(g * o),
another head's statistics read in dkv; and of the cluster design, block
0's partial of the rows' sums or of gQ dropped, each block's own row
term) must break those bounds, and the backward repeats bit for bit.
The bf16 forward runs on wgmma (HGMMA in the SASS of every instance, no
HMMA) and is held to its plain version in eval and train mode, with and
without the key bias, at every edge of its tiling (1 to 4,097 keys), an
image's output bit-equal to a launch of its own; a train-mode forward and
#6's gradient of it hold at 197 and 257 keys.
Shapes reach past the first kernels' limits: 257 keys (a 256-pixel ViT),
1024, the fp32 backward at ViT's 197 (CUDA cores), #10 at any K and N,
the user encoder at L=20 and 50, at 6 layers (global scratch) and at
widths that are not a multiple of 8 (D = 36 and 12, which the JAX kernel
takes), and at the widths the kernels took before (forward D = 5,461 with
43 heads, backward D = 1,820); the Python plan equals the layout the
library computes; one cached step at max_seq_len=20 and one fp32 FFT step at 197
tokens run through the kernels, and a LoRA BERT at BERT-base width through
#5 / #6 agrees with its module path and with its rematerialised runs
(``test_lora_bert_through_the_attention_kernels_and_remat``).  The
encoder backward repeats bit for bit on both routes; on the bf16 route
(tensor cores) its device memory at the
training geometry stays under 4 MB, and its weight-gradient pass run
without one layer's gq|gk|gv rows breaks the bound on that layer's wq, wk
and wv.
W8A8 linear (#10, a quantise kernel and an int8 wgmma GEMM): bit-equal to
``int8_matmul`` (the int32 sums are exact and every other step rounds as
the plain version does) at the six tower shapes at the step's ViT and
BERT rows, BERT-large's, K = 6,336 and 8,192, ViT-tiny's D = 192, ragged M,
K and N, fp32 and bf16 in and out, zero rows and 3-D input; the quantise
kernel alone bit-equal to ``quantize_rows``; a dropped bias, rounding
toward zero, one per-tensor activation scale, the last K slice dropped and
the weight read MN-major each break equality.  Attention subblocks
(#8, #9, bf16): the forward tolerance of the attention kernels, in eval and
train mode, against the explicit-mask oracle, bit for bit on a repeat, from
1 to 1024 keys (past the earlier 320), at D = 192 with three heads and v2 at
3 and 6 heads on #8's counter; the key bias dropped, one head's rows of Wo
skipped and another seed's masks must break the bound.  Their projection
GEMM alone (``qkv_projection``, wgmma) is held to one bf16 rounding of the
fp32 product, |diff| <= 2^-7 |plain| + 1e-4 max|plain|, with a partial last
128-row tile and N = 3D at D = 192, 768 and 1024; a head's k taken from its
neighbour's columns and the partial tile not stored must break that
bound.
The cache builder at its batch (128 titles x 30 tokens, 128 images x 197,
BERT- and ViT-base width, 2 layers) launches #5 twice a batch, and a build
in three shards on one store is the single build bit for bit (every
launch has the same M).  A Llama layer (GQA 8 / 2) in bf16 stays within
max |diff| / max |fp32| < 0.05 of its fp32 copy.
The run path (``train.pipelines.run_from_config``) trains the cached and
the ID pipelines through both encoder kernels on a tiny TSV dataset, and
one epoch, a checkpoint, a resume and one more epoch are the two-epoch
run bit for bit.
"""

import math

import pytest
import torch

from iisan_tpu_torch import testing as et
from iisan_tpu_torch.models.user_encoder import UserEncoder, causal_additive_mask
from iisan_tpu_torch.ops import fused_attention as fa
from iisan_tpu_torch.ops import fused_attn_subblock as fsb
from iisan_tpu_torch.ops import fused_san as fs
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.ops import fused_w8a8 as fw
from iisan_tpu_torch.ops import philox
from iisan_tpu_torch.ops.int8_linear import (Int8Dense, int8_matmul,
                                             quantize_kernel, quantize_rows)

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_close(got, want, dtype, carry=False):
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    if carry and dtype == torch.bfloat16:
        bound = fs.carry_tolerance(want)
    else:
        bound = TOL[dtype] * (1 + want.abs())
    assert (err <= bound).all(), f"max |diff| {err.max()}"


def _encoder_inputs(device, B, L, D, H, n_layers, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    enc = UserEncoder(D, L, H, n_layers, 0.0, generator=gen)
    with torch.no_grad():  # move LayerNorms and biases off their init
        for p in enc.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(B, L, D, generator=gen).to(device, dtype)
    lengths = torch.randint(0, L + 1, (B,), generator=gen)
    lengths[0] = 0  # an all-pad row: the uniform softmax, not NaN
    log_mask = (torch.arange(L)[None] >= L - lengths[:, None]).float()
    mask3 = causal_additive_mask(log_mask.to(device)).reshape(B, L, L)
    return enc.to(device), x, mask3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,D,H,NL", [(1, 10, 64, 2, 2), (256, 10, 64, 2, 2),
                                         (37, 7, 48, 3, 1), (5, 20, 128, 4, 3),
                                         (8, 20, 64, 2, 2), (4, 50, 64, 2, 2),
                                         (4, 50, 128, 2, 2), (3, 10, 64, 2, 6),
                                         (8, 10, 36, 2, 2), (6, 10, 12, 3, 1)])
def test_user_encoder_kernel_matches_plain(cuda_device, dtype, B, L, D, H, NL):
    enc, x, mask3 = _encoder_inputs(cuda_device, B, L, D, H, NL, dtype)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L)
    before = fue.user_encoder_fwd.launches
    got = fue.user_encoder_fwd(x, mask3, enc.packed_params(x.dtype), **kw)
    want = fue.user_encoder_fwd_plain(x, mask3, enc.packed_params(x.dtype), **kw)
    torch.cuda.synchronize()
    assert fue.user_encoder_fwd.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_user_encoder_dispatch_reaches_kernel(cuda_device):
    enc, x, mask3 = _encoder_inputs(cuda_device, 3, 10, 64, 2, 2,
                                    torch.bfloat16)
    log_mask = (mask3[:, -1] == 0).float()
    before = fue.user_encoder_fwd.launches
    with torch.no_grad():
        fused = enc(x, log_mask)
        enc.fused = False
        module = enc(x, log_mask)
    assert fue.user_encoder_fwd.launches == before + 1
    _assert_close(fused, module, torch.bfloat16)


@pytest.mark.cuda
def test_user_encoder_dispatch_raises_on_unsupported_shape(cuda_device):
    # A sequence longer than the position table: on the card the module
    # raises instead of running the module path.  (D=36, once refused,
    # runs the kernels: test_user_encoder_kernel_matches_plain.)
    enc, x, mask3 = _encoder_inputs(cuda_device, 2, 10, 36, 2, 1,
                                    torch.float32)
    x = torch.cat([x, x[:, :1]], 1)
    log_mask = torch.ones(2, 11, device=cuda_device)
    before = fue.user_encoder_fwd.launches
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        enc(x, log_mask)
    assert fue.user_encoder_fwd.launches == before


@pytest.mark.cuda
def test_user_encoder_wrapper_rejects_bad_input(cuda_device):
    enc, x, mask3 = _encoder_inputs(cuda_device, 2, 10, 64, 2, 2,
                                    torch.float32)
    kw = dict(n_layers=2, n_heads=2, d_ff=256, n_position=10)
    with pytest.raises(TypeError):
        fue.user_encoder_fwd(x.half(), mask3, enc.packed_params(x.dtype), **kw)
    with pytest.raises(ValueError):
        fue.user_encoder_fwd(x, mask3[:1], enc.packed_params(x.dtype), **kw)
    with pytest.raises(ValueError):
        fue.user_encoder_fwd(x, mask3, enc.packed_params(torch.float32)[:-1], **kw)


def _cascade_inputs(device, S, N, K, D, R, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    a = torch.sigmoid(0.1 * torch.randn(S, K, generator=gen)
                      / fs.GATE_TEMPERATURE)
    a[-1] = 1.0  # the last branch is additive
    b = 1.0 - a
    b[-1] = 1.0
    return (a.to(device), b.to(device), rand(S, N, K, D),
            rand(S, K, D, R, scale=D ** -0.5), rand(S, K, R, scale=0.5),
            rand(S, K, R, D, scale=R ** -0.5), rand(S, K, D, scale=0.5),
            rand(S, N, D))


# #3's shapes: the main path's (the cached step S=1 N=704 D=768 and the
# Versa image side D=192; a table chunk S=3 N=8192), ragged N, the
# geometries the kernel once refused (D past 3,312 bf16 / 1,656 fp32, R not
# dividing 256 or above it) and awkward ones.
CASCADE_SHAPES = [(3, 8192, 7, 768, 64), (1, 704, 7, 768, 64), (1, 704, 7, 192, 64),
                  (1, 37, 3, 96, 8), (1, 63, 7, 768, 64), (1, 65, 7, 768, 64),
                  (2, 100, 5, 300, 128), (3, 16, 1, 64, 256), (1, 1, 2, 32, 1),
                  (1, 40, 1, 4096, 64), (2, 40, 2, 3584, 64), (1, 40, 1, 2048, 64),
                  (1, 65, 7, 768, 48), (1, 50, 3, 768, 96), (1, 30, 2, 2048, 320),
                  (1, 5, 1, 1001, 3), (1, 20, 1, 20480, 64)]  # the last: carry in `out`


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
@pytest.mark.parametrize("S,N,K,D,R", CASCADE_SHAPES)
def test_cascade_kernel_matches_plain(cuda_device, dtype, activation, S, N, K,
                                      D, R):
    args = _cascade_inputs(cuda_device, S, N, K, D, R, dtype)
    before = fs.san_cascade_fwd.launches
    got = fs.san_cascade_fwd(*args, activation=activation)
    want = fs.san_cascade_fwd_plain(*args, activation=activation)
    torch.cuda.synchronize()
    assert fs.san_cascade_fwd.launches == before + 1
    _assert_close(got, want, dtype, carry=True)
    # a fixed summation order (z summed over the cluster in rank order):
    # the kernel repeats bit for bit
    assert torch.equal(got, fs.san_cascade_fwd(*args, activation=activation))


def _drop_rank(wd, plan, rank):
    """wd with the rows of cluster rank ``rank``'s D slice zeroed: what the
    kernel would compute if that rank's partial of z were dropped."""
    wd = wd.clone()
    wd[..., rank * plan.d_slice:(rank + 1) * plan.d_slice, :] = 0
    return wd


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["bd dropped", "GELU for ReLU", "step-0 weights",
                                   "one rank's partial dropped"])
def test_cascade_planted_faults_break_the_bound(cuda_device, fault):
    # The cached step's shape (a 12-block cluster); each fault, made by the
    # kernel itself from altered arguments, must break the bound in every
    # branch that the true kernel meets.
    args = list(_cascade_inputs(cuda_device, 2, 704, 7, 768, 64, torch.bfloat16))
    want = fs.san_cascade_fwd_plain(*args)
    assert _carry_ratio(fs.san_cascade_fwd(*args), want) <= 1.0
    activation = "GELU" if fault == "GELU for ReLU" else "RELU"
    if fault == "bd dropped":
        args[4] = torch.zeros_like(args[4])
    elif fault == "step-0 weights":
        for j in (3, 4, 5, 6):
            args[j] = args[j][:, :1].expand_as(args[j]).contiguous()
    elif fault == "one rank's partial dropped":
        plan = fs.cascade_plan(2, 704, 7, 768, 64, torch.bfloat16)
        assert plan.cluster > 1
        args[3] = _drop_rank(args[3], plan, plan.cluster // 2)
    got = fs.san_cascade_fwd(*args, activation=activation)
    for branch in range(2):
        assert _carry_ratio(got[branch], want[branch]) > 1.0


@pytest.mark.cuda
def test_fused_cascade_is_the_kernel_at_s1(cuda_device):
    args = _cascade_inputs(cuda_device, 1, 50, 4, 64, 16, torch.bfloat16)
    gates = torch.randn(4, device=cuda_device)
    a, b = fs.cascade_coefs(gates, True)
    got = fs.fused_cascade(gates, *[t[0] for t in args[2:]])
    want = fs.san_cascade_fwd(a[None], b[None], *args[2:])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _streamed_inputs(device, N, K, D, R, gated=True, seed=0):
    """One branch's bf16 inputs in which every term moves the carry by O(1)."""
    args = _cascade_inputs(device, 1, N, K, D, R, torch.bfloat16, seed)
    gates = (0.1 * torch.randn(K, generator=torch.Generator().manual_seed(seed))
             ).to(device)
    a, b = fs.cascade_coefs(gates, gated)
    return (a, b) + tuple(t[0] for t in args[2:])


def _carry_ratio(got, want):
    """Largest |got - want| / carry_tolerance(want); inf if not finite."""
    if not torch.isfinite(got.float()).all():
        return float("inf")
    return float(((got.float() - want.float()).abs()
                  / fs.carry_tolerance(want)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
@pytest.mark.parametrize("N,K,D,R", [(704, 7, 8192, 64), (96, 7, 8192, 128),
                                     (37, 3, 96, 8), (1, 2, 1001, 4),
                                     (50, 4, 600, 256), (17, 1, 64, 2),
                                     (1, 7, 8192, 64), (63, 7, 8192, 64),
                                     (65, 7, 8192, 64), (704, 6, 5120, 64),
                                     (40, 7, 2048, 48), (40, 7, 2048, 96),
                                     (40, 7, 2048, 320), (37, 7, 4096, 1),
                                     (40, 2, 12288, 64)])  # carry in the scratch
def test_streamed_cascade_kernel_matches_plain(cuda_device, gated, activation,
                                               N, K, D, R):
    args = _streamed_inputs(cuda_device, N, K, D, R, gated)
    before = fs.san_cascade_streamed_fwd.launches
    got = fs.san_cascade_streamed_fwd(*args, activation=activation)
    want = fs.san_cascade_streamed_fwd_plain(*args, activation=activation)
    torch.cuda.synchronize()
    assert fs.san_cascade_streamed_fwd.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (N, D)
    assert _carry_ratio(got, want) <= 1.0
    # no atomics and a fixed summation order: the kernel repeats bit for bit
    assert torch.equal(got, fs.san_cascade_streamed_fwd(*args,
                                                        activation=activation))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["bd dropped", "other activation",
                                   "step-0 weights", "gates swapped"])
def test_streamed_cascade_planted_faults_break_the_bound(cuda_device, fault):
    a, b, taps, wd, bd, wu, bu, c0 = _streamed_inputs(cuda_device, 704, 7,
                                                      8192, 64)
    # gates far from 0.5, so swapping g and 1 - g changes every step
    a = torch.sigmoid(torch.linspace(-2, 2, 7, device=cuda_device))
    b = 1.0 - a
    want = fs.san_cascade_streamed_fwd_plain(a, b, taps, wd, bd, wu, bu, c0)
    activation = "GELU" if fault == "other activation" else "RELU"
    if fault == "bd dropped":
        bd = torch.zeros_like(bd)
    elif fault == "step-0 weights":
        wd, bd, wu, bu = (w[:1].expand_as(w) for w in (wd, bd, wu, bu))
    elif fault == "gates swapped":
        a, b = b, a
    got = fs.san_cascade_streamed_fwd(a, b, taps, wd, bd, wu, bu, c0,
                                      activation=activation)
    assert _carry_ratio(got, want) > 1.0


@pytest.mark.cuda
def test_fused_cascade_follows_the_jax_dispatch(cuda_device):
    counters = (fs.san_cascade_fwd, fs.san_cascade_streamed_fwd)
    cases = [((7, 8192, 64), torch.bfloat16, (0, 1)),
             ((7, 192, 64), torch.bfloat16, (1, 0)),
             ((7, 8192, 64), torch.float32, (0, 0)),
             ((7, 768, 64), torch.float32, (1, 0)),
             ((2, 3584, 64), torch.bfloat16, (1, 0)),
             ((1, 4096, 64), torch.bfloat16, (1, 0)),
             ((1, 2048, 64), torch.float32, (1, 0)),
             ((7, 768, 48), torch.bfloat16, (1, 0)),
             ((7, 2048, 320), torch.bfloat16, (0, 1))]
    for (K, D, R), dtype, want in cases:
        args = _cascade_inputs(cuda_device, 1, 40, K, D, R, dtype)
        gates = torch.zeros(K, device=cuda_device)
        before = [c.launches for c in counters]
        out = fs.fused_cascade(gates, *[t[0] for t in args[2:]])
        torch.cuda.synchronize()
        assert tuple(c.launches - n for c, n in zip(counters, before)) == want
        assert out.dtype == dtype and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_streamed_wrapper_rejects_fp32_and_cascade_takes_wide_d(cuda_device):
    args = _streamed_inputs(cuda_device, 8, 2, 256, 16)
    before = fs.san_cascade_streamed_fwd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fs.san_cascade_streamed_fwd(*args[:2], *[t.float() for t in args[2:]])
    assert fs.san_cascade_streamed_fwd.launches == before
    # #3 at D=8192 (once refused for its shared memory): its own chain
    wide = _cascade_inputs(cuda_device, 1, 16, 7, 8192, 64, torch.bfloat16)
    got = fs.san_cascade_fwd(*wide)
    _assert_close(got, fs.san_cascade_fwd_plain(*wide), torch.bfloat16, carry=True)


@pytest.mark.cuda
def test_cascade_wrapper_rejects_bad_input(cuda_device):
    args = list(_cascade_inputs(cuda_device, 1, 8, 2, 64, 1473, torch.bfloat16))
    before = fs.san_cascade_fwd.launches
    with pytest.raises(ValueError, match="R=1473"):
        fs.san_cascade_fwd(*args)
    assert fs.san_cascade_fwd.launches == before
    args = list(_cascade_inputs(cuda_device, 1, 8, 2, 64, 16, torch.float32))
    args[3] = args[3].half()
    with pytest.raises(TypeError):
        fs.san_cascade_fwd(*args)


def _assert_grad_close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    bound = TOL[dtype] * (want.abs().max() + want.abs())
    assert ((got - want).abs() <= bound).all(), f"max |diff| {(got - want).abs().max()}"


def _bwd_reference(x, mask3, params, gout, kw):
    """The plain backward; in bf16 at the tensor-core kernel's own FFN ReLU
    decisions (``iisan_tpu_torch.testing.plain_bwd_at_kernel_decisions``)."""
    return et.plain_bwd_at_kernel_decisions(x, mask3, params, gout, **kw)[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,D,H,NL", [(64, 10, 64, 2, 2), (1, 10, 64, 2, 2),
                                         (3, 10, 64, 2, 1), (37, 7, 48, 3, 1),
                                         (8, 20, 64, 2, 2), (4, 50, 64, 2, 2),
                                         (4, 50, 128, 2, 2), (3, 10, 64, 2, 6),
                                         (8, 10, 36, 2, 2), (6, 10, 12, 3, 1)])
def test_user_encoder_train_kernels_match_plain(cuda_device, dtype, B, L, D, H, NL):
    enc, x, mask3 = _encoder_inputs(cuda_device, B, L, D, H, NL, dtype)
    gout = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(
        cuda_device, dtype)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L, seed=4242,
              rate=0.1)
    params = enc.packed_params(dtype)
    f0, b0 = fue.user_encoder_fwd.launches, fue.user_encoder_bwd.launches
    got = fue.user_encoder_fwd(x, mask3, params, **kw)
    want = fue.user_encoder_fwd_plain(x, mask3, params, **kw)
    gx, gp = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    gx_p, gp_p = _bwd_reference(x, mask3, params, gout, kw)
    torch.cuda.synchronize()
    assert fue.user_encoder_fwd.launches == f0 + 1
    assert fue.user_encoder_bwd.launches == b0 + 1
    _assert_close(got, want, dtype)
    assert gx.dtype == dtype and gp.dtype == torch.float32
    _assert_grad_close(gx, gx_p, dtype)
    for g, w in zip(fue.unpack_encoder_params(gp, D, 4 * D, NL, L),
                    fue.unpack_encoder_params(gp_p, D, 4 * D, NL, L)):
        _assert_grad_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 16])
def test_user_encoder_train_kernels_match_plain_l20_d128(cuda_device, B):
    # L=20 at width 128 in fp32: the backward's stash in its global scratch
    test_user_encoder_train_kernels_match_plain(cuda_device, torch.float32, B, 20,
                                                128, 2, 2)


@pytest.mark.cuda
def test_philox_matches_curand(cuda_device):
    for seed, site in ((0, 0), (12345, 7), (2 ** 31 - 2, 33)):
        ours, theirs = philox.curand_check(seed, site, 5, 1001, cuda_device)
        plain = philox.random_bits(seed, site, torch.arange(5), 1001)
        assert torch.equal(ours.cpu(), theirs.cpu())
        assert torch.equal(ours.cpu(), plain)


@pytest.mark.cuda
def test_encoder_loss_backward_reaches_every_parameter(cuda_device):
    enc, x, mask3 = _encoder_inputs(cuda_device, 8, 10, 64, 2, 2, torch.float32)
    log_mask = (mask3[:, -1] == 0).float()
    proj = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(
        cuda_device)
    grads = []
    for fused in (None, False):
        enc.fused = fused
        enc.zero_grad()
        xx = x.clone().requires_grad_(True)
        b0 = fue.user_encoder_bwd.launches
        (enc(xx, log_mask) * proj).sum().backward()
        assert fue.user_encoder_bwd.launches == b0 + (fused is None)
        grads.append([xx.grad] + [p.grad for p in enc.parameters()])
    for g, w in zip(*grads):
        assert g is not None
        _assert_grad_close(g, w, torch.float32)


@pytest.mark.cuda
def test_cascade_loss_backward_reaches_every_input(cuda_device):
    args = _cascade_inputs(cuda_device, 1, 300, 4, 96, 16, torch.float32)
    # gates well inside sigmoid(g / 0.1)'s range: a saturated gate (fp32
    # sigmoid of 20 is exactly 1) has, rightly, no gradient, nor has c0
    gates = (0.1 * torch.randn(4, generator=torch.Generator().manual_seed(4))
             ).to(cuda_device)
    inputs = [gates] + [t[0] for t in args[2:]]
    proj = torch.randn(300, 96, generator=torch.Generator().manual_seed(3)).to(
        cuda_device)
    grads = []
    for run in (fs.fused_cascade, fs.reference_cascade):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        before = fs.san_cascade_fwd.launches
        (run(*leaves) * proj).sum().backward()
        assert fs.san_cascade_fwd.launches == before + (run is fs.fused_cascade)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert g is not None and g.abs().sum() > 0
        _assert_grad_close(g, w, torch.float32)


@pytest.mark.cuda
def test_user_encoder_bwd_raises_on_unsupported_shape(cuda_device):
    # Six blocks' stash goes to a global scratch; a hidden width whose
    # packed parameters pass the stated limit (2^31 entries) is refused
    # before anything is read.
    assert fue.bwd_supported(2, 10, 64, 2, 256, 6, 10)
    assert fue.bwd_plan(10, 64, 2, 256, 6)[0] == fue.SLOTS_GLOBAL
    enc, x, mask3 = _encoder_inputs(cuda_device, 2, 10, 64, 2, 1, torch.float32)
    kw = dict(n_layers=1, n_heads=2, d_ff=2 ** 24, n_position=10)
    params = enc.packed_params(torch.float32)
    assert not fue.bwd_supported(2, 10, 64, 2, 2 ** 24, 1, 10)
    before = fue.user_encoder_bwd.launches
    for dtype in DTYPES:
        with pytest.raises(ValueError, match="does not take"):
            fue.user_encoder_bwd(x.to(dtype), mask3, params,
                                 torch.zeros_like(x, dtype=dtype), **kw)
    assert fue.user_encoder_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H,F", [(64, 2, 16392), (1376, 2, 5504)])
def test_user_encoder_kernels_take_wide_weights(cuda_device, dtype, D, H, F):
    # Past the fp32 route's 16,384-float staging buffer: F > 16,384 (w1's
    # rows go in column panels) and 3F > 16,384 (w2^T's rows in panels),
    # which the bf16 route streams like any other width.
    B, L, NL = 3, 10, 1
    gen = torch.Generator().manual_seed(9)
    parts = [torch.randn(s, generator=gen) / s[0] ** 0.5 if len(s) == 2
             else 1.0 + 0.1 * torch.randn(s, generator=gen)
             for s in fue.param_shapes(D, F, NL, L)]
    params = torch.cat([t.reshape(-1) for t in parts]).to(cuda_device)
    x = torch.randn(B, L, D, generator=gen).to(cuda_device, dtype)
    gout = torch.randn(B, L, D, generator=gen).to(cuda_device, dtype)
    mask3 = causal_additive_mask(torch.ones(B, L, device=cuda_device)).reshape(B, L, L)
    kw = dict(n_layers=NL, n_heads=H, d_ff=F, n_position=L, seed=3, rate=0.1)
    _assert_close(fue.user_encoder_fwd(x, mask3, params, **kw),
                  fue.user_encoder_fwd_plain(x, mask3, params, **kw), dtype)
    got = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    want = _bwd_reference(x, mask3, params, gout, kw)
    _assert_grad_close(got[0], want[0], dtype)
    for g, w in zip(fue.unpack_encoder_params(got[1], D, F, NL, L),
                    fue.unpack_encoder_params(want[1], D, F, NL, L)):
        _assert_grad_close(g, w, dtype)


def _wide_params(device, D, F, NL, L, seed):
    # matrices ~ N(0, 1/fan_in), vectors 1 + N(0, 0.01), made on the card
    gen = torch.Generator(device).manual_seed(seed)
    parts = [torch.randn(s, generator=gen, device=device) / s[0] ** 0.5
             if len(s) == 2 else
             1.0 + 0.1 * torch.randn(s, generator=gen, device=device)
             for s in fue.param_shapes(D, F, NL, L)]
    return torch.cat([t.reshape(-1) for t in parts])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,H,backward", [(5461, 43, False), (1820, 4, True)])
def test_user_encoder_kernels_at_the_width_caps(cuda_device, dtype, D, H, backward):
    # The widths the kernels took before every width the heads divide was
    # taken: forward D = 5,461 (21,844 hidden: the fp32 route's weights in
    # panels, the areas spilled to device memory) and backward D = 1,820,
    # two sequences in train mode.
    B, L, NL, F = 2, 4, 1, 4 * D
    params = _wide_params(cuda_device, D, F, NL, L, 13)
    gen = torch.Generator(cuda_device).manual_seed(14)
    x = torch.randn(B, L, D, generator=gen, device=cuda_device).to(dtype)
    mask3 = causal_additive_mask(torch.ones(B, L, device=cuda_device)).reshape(B, L, L)
    kw = dict(n_layers=NL, n_heads=H, d_ff=F, n_position=L, seed=5, rate=0.1)
    assert fue.supported(B, L, D, H, F, L) and fue.bwd_supported(B, L, D, H, F, NL, L)
    _assert_close(fue.user_encoder_fwd(x, mask3, params, **kw),
                  fue.user_encoder_fwd_plain(x, mask3, params, **kw), dtype)
    if not backward:
        return
    gout = torch.randn(B, L, D, generator=gen, device=cuda_device).to(dtype)
    got = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    want = _bwd_reference(x, mask3, params, gout, kw)
    _assert_grad_close(got[0], want[0], dtype)
    for g, w in zip(fue.unpack_encoder_params(got[1], D, F, NL, L),
                    fue.unpack_encoder_params(want[1], D, F, NL, L)):
        _assert_grad_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,H,NL", [(1, 10, 64, 2, 2), (256, 10, 64, 2, 2),
                                         (64, 10, 64, 2, 2), (37, 7, 48, 3, 1),
                                         (5, 20, 128, 4, 3), (4, 50, 128, 2, 2),
                                         (3, 10, 64, 2, 6), (8, 10, 36, 2, 2),
                                         (6, 10, 12, 3, 1), (3, 10, 1376, 2, 1),
                                         (2, 4, 5461, 43, 1), (2, 4, 1820, 4, 1)])
def test_encoder_plan_matches_the_kernels_layout(cuda_device, B, L, D, H, NL):
    # The Python plan (which the wrappers allocate by and the CPU tests
    # check) against the layout the library computes, which the code that
    # reads the kernels' buffers uses.
    F = 4 * D
    lib = fue.library_tc_layout(B, L, D, H, F, NL)
    fwd = fue.encoder_plan(B, L, D, H, F, NL, torch.bfloat16)
    bwd = fue.encoder_plan(B, L, D, H, F, NL, torch.bfloat16, backward=True)
    assert (lib["fwd_place"], lib["fwd_smem"], lib["fwd_scratch"]) == fwd[1:4]
    assert (lib["bwd_place"], lib["bwd_smem"], lib["bwd_scratch"]) == bwd[1:4]
    assert lib["image"] == fue.tc_image_elems(D, F, NL)
    py = fue.tc_work_layout(B, L, D, F, NL, bwd.scratch_bytes)
    for key in ("xin", "ctx", "x1", "hf", "gqkv", "go2", "ghpre", "gh2", "layer",
                "part", "gx32", "scratch", "total"):
        assert lib[key] == py[key], key
    assert lib["total"] == bwd.work_bytes


@pytest.mark.cuda
def test_user_encoder_serving_reuses_its_weight_image(cuda_device):
    # Under no_grad the module keeps one bf16 weight image per parameter
    # version beside its packed vector, and the forward reads it.
    enc, x, mask3 = _encoder_inputs(cuda_device, 4, 10, 64, 2, 2, torch.bfloat16)
    enc.dtype = torch.bfloat16
    log_mask = (mask3[:, -1] == 0).float()
    kw = dict(n_layers=2, n_heads=2, d_ff=256, n_position=10)
    with torch.no_grad():
        first = enc(x, log_mask)
        packed, image = enc._serving_params(torch.bfloat16)
        assert torch.equal(enc(x, log_mask), first)
        assert enc._serving_params(torch.bfloat16)[1] is image
        assert torch.equal(first, fue.user_encoder_fwd(x, mask3, packed, **kw))
        with pytest.raises(ValueError, match="weight image"):
            fue.user_encoder_fwd(x, mask3, packed, image=image[1:], **kw)
        next(enc.parameters()).add_(0.5)
        assert enc._serving_params(torch.bfloat16)[1] is not image


def _train_case(device, dtype, B=64, L=10, D=64, H=2, NL=2):
    enc, x, mask3 = _encoder_inputs(device, B, L, D, H, NL, dtype)
    gout = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(
        device, dtype)
    kw = dict(n_layers=NL, n_heads=H, d_ff=4 * D, n_position=L, seed=4242,
              rate=0.1)
    return x, mask3, enc.packed_params(dtype), gout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_user_encoder_bwd_repeats_bit_for_bit(cuda_device, dtype):
    x, mask3, params, gout, kw = _train_case(cuda_device, dtype)
    first = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    second = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_user_encoder_bwd_bf16_memory_and_planted_fault(cuda_device):
    # The bf16 backward's device memory at the training geometry (no
    # (B, P) scratch): at most 4 MB beyond its inputs, outputs included.
    # Then its weight-gradient pass run on a buffer whose last layer lost
    # its gq|gk|gv rows: dwq, dwk and dwv break the bound.
    x, mask3, params, gout, kw = _train_case(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    gx, gp = fue.user_encoder_bwd(x, mask3, params, gout, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda_device) - before <= 4 * 2 ** 20
    want = _bwd_reference(x, mask3, params, gout, kw)
    B, L, D = x.shape
    NL, F = kw["n_layers"], kw["d_ff"]
    unpack = lambda t: fue.unpack_encoder_params(t, D, F, NL, L)  # noqa: E731
    for g, w in zip(unpack(gp), unpack(want[1])):
        _assert_grad_close(g, w, torch.bfloat16)
    gx2, faulty = et.wgrad_rows_dropped(x, mask3, params, gout, kw)
    torch.cuda.synchronize()
    assert torch.equal(gx2, gx)
    k0 = 3 + fue.PER_BLOCK * (NL - 1)
    for i, (g, w) in enumerate(zip(unpack(faulty), unpack(want[1]))):
        if k0 <= i < k0 + 3:
            with pytest.raises(AssertionError):
                _assert_grad_close(g, w, torch.bfloat16)
        else:
            _assert_grad_close(g, w, torch.bfloat16)


@pytest.mark.cuda
def test_cached_step_at_max_seq_len_20_runs_the_kernels(cuda_device):
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.train.cached import CachedTrainer

    L = 20
    cfg = IISANConfig(batch_size=16, epoch=1, embedding_dim=64, max_seq_len=L,
                      side_adapter_vit_list="1,3", side_adapter_bert_list="1,3",
                      word_embedding_dim=32, image_embedding_dim=32,
                      bert_adapter_down_size=8, cv_adapter_down_size=8)
    corpus = synthetic_corpus(n_users=16, item_num=200, max_seq_len=L)
    gen = torch.Generator().manual_seed(0)
    cv, text = (torch.randn(201, 3, 32, generator=gen) for _ in range(2))
    tr = CachedTrainer(cfg, corpus, cv, text, device=cuda_device)
    f0, b0 = fue.user_encoder_fwd.launches, fue.user_encoder_bwd.launches
    ids = torch.as_tensor(tr.epoch_permutation(1)[0], device=cuda_device).long()
    loss = tr.train_step(tr.train_seqs[ids], tr.train_log_mask[ids])
    torch.cuda.synchronize()
    assert tr.train_seqs.shape[1] == L + 1
    assert torch.isfinite(loss).all()
    assert fue.user_encoder_fwd.launches == f0 + 1
    assert fue.user_encoder_bwd.launches == b0 + 1


MHA_TOL = {(torch.float32, "fwd"): 1e-4, (torch.bfloat16, "fwd"): 2e-2,
           (torch.float32, "bwd"): 1e-4, (torch.bfloat16, "bwd"): 5e-2}


def _mha_inputs(device, B, T, D, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(B, T, D, generator=gen).to(device, dtype)
                  for _ in range(4))
    lengths = torch.randint(1, T + 1, (B,), generator=gen)
    lengths[0] = 0  # the pad item: every key carries the -1e9 bias
    keep = torch.arange(T)[None] < lengths[:, None]
    bias = torch.where(keep, 0.0, -1e9).to(device)
    return q, k, v, g, bias


def _mha_ratio(got, want):
    """max |got - want| / (max|want| + |want|) over tensors; inf if any
    value is not finite."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            return float("inf")
        bound = (b.abs().max() + b.abs()).clamp_min(1e-30)
        worst = max(worst, float(((a - b).abs() / bound).max()))
    return worst


# Key counts at the tensor-core tiles' edges (16-row m-tiles, 64-key tiles,
# 320 resident keys), BERT's 30, ViT's 197 and 257, and a long sequence.
MHA_SHAPES = ([(3, T, 768, 12) for T in (1, 16, 30, 63, 64, 65, 197, 257, 320, 321)]
              + [(1, 1000, 128, 2), (5, 77, 128, 2), (4, 33, 192, 3), (2, 1, 64, 1),
                 (1, 1024, 128, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,T,D,H", MHA_SHAPES)
def test_mha_kernels_match_plain(cuda_device, dtype, rate, with_bias, B, T, D, H):
    q, k, v, g, bias = _mha_inputs(cuda_device, B, T, D, dtype)
    bias = bias if with_bias else None
    kw = dict(n_heads=H, seed=977, rate=rate, layer=3)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    got = fa.mha_fwd(q, k, v, bias, **kw)
    want = fa.mha_fwd_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert fa.mha_fwd.launches == f0 + 1 and got.dtype == dtype
    assert _mha_ratio([got], [want]) <= MHA_TOL[dtype, "fwd"]
    assert fa.bwd_supported(B, T, D, H, q.element_size())
    grads = fa.mha_bwd(q, k, v, bias, g, **kw)
    plain = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert fa.mha_bwd.launches == b0 + 1
    assert _mha_ratio(grads, plain) <= MHA_TOL[dtype, "bwd"]
    # no atomics: the backward repeats bit for bit
    assert all(torch.equal(a, b) for a, b in
               zip(grads, fa.mha_bwd(q, k, v, bias, g, **kw)))


# Key counts at every edge of the bf16 forward's tiling (64-row query
# tiles, 64-key chunks, 8-key groups, 16-key product steps, 320 resident
# keys): one key, a ragged group, 63 / 64 / 65, two chunks, ViT's 197 (3 x
# 64 + 5), 256 and 257, the resident limit and one past it, and long
# streamed rows.
MHA_FWD_EDGES = ([(2, T, 768, 12) for T in (1, 5, 63, 64, 65, 128, 197, 256, 257, 320, 321)]
                 + [(1, 1000, 128, 2), (1, 4097, 128, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,T,D,H", MHA_FWD_EDGES)
def test_mha_fwd_matches_plain_at_the_tile_edges(cuda_device, rate, with_bias, B, T, D, H):
    q, k, v, _, bias = _mha_inputs(cuda_device, B, T, D, torch.bfloat16, seed=6)
    bias = bias if with_bias else None
    kw = dict(n_heads=H, seed=1234, rate=rate, layer=9)
    f0 = fa.mha_fwd.launches
    got = fa.mha_fwd(q, k, v, bias, **kw)
    want = fa.mha_fwd_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert fa.mha_fwd.launches == f0 + 1
    assert _mha_ratio([got], [want]) <= MHA_TOL[torch.bfloat16, "fwd"]
    if rate == 0.0 and B > 1:  # an image's output does not depend on its batch
        alone = fa.mha_fwd(q[1:], k[1:], v[1:], None if bias is None else bias[1:], **kw)
        assert torch.equal(got[1:], alone)


# Key counts at every edge of the bf16 backward's designs: the cluster
# design's one to eight blocks of 64 keys (1, 2, 16, 30, 63 and 64 in one
# block; 65 in two; 128, 192, 197 (ViT) in two to four; 257, 319 and 320 in
# five; 321 and 325 (ViT at CV_resize=288) and 384 in six; 385 and 448 in
# seven; 449, 511 and 512 in eight, up to fa.CLUSTER_KEYS), and the split
# design's 64-row query and 64-key tiles past it: one key past the cluster
# (513), nine whole tiles and one past (576, 577: ViT at CV_resize=384),
# ten and one past (640, 641), and at one image 16 tiles and a long row
# (1,024, 4,097).  Each at 768 wide (12 heads), and ViT-tiny's 192 (3
# heads) at 577 keys, where the JAX kernel itself runs.
MHA_BWD_EDGES = (1, 2, 16, 30, 63, 64, 65, 128, 192, 197, 257, 319, 320, 321, 325, 384,
                 385, 448, 449, 511, 512, 513, 576, 577, 640, 641)
MHA_BWD_CASES = ([(T, B, 12) for T in MHA_BWD_EDGES for B in (1, 88)]
                 + [(1024, 1, 12), (4097, 1, 12), (577, 88, 3)])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T,B,H", MHA_BWD_CASES)
def test_mha_bwd_designs_match_plain(cuda_device, T, B, H, with_bias, rate):
    """#6 in bf16 at each edge of its designs, one image and the FFT
    step's 88, eval and train mode, with and without the key bias: the
    design ``bwd_design`` names (one cluster of T / 64 rounded up blocks up
    to ``fa.CLUSTER_KEYS``, the split design beyond), one launch of the
    wrapper, the bf16 bound against ``mha_bwd_plain``, and two launches
    bit-equal.  ``bwd_design``, the CPU's copy, names what the library
    chooses in both dtypes."""
    dt = torch.bfloat16
    q, k, v, g, bias = _mha_inputs(cuda_device, B, T, 64 * H, dt, seed=T)
    bias = bias if with_bias else None
    kw = dict(n_heads=H, seed=4242, rate=rate, layer=7)
    assert fa.bwd_design(T, 2) == ("wgmma_cluster" if T <= fa.CLUSTER_KEYS
                                   else "wgmma_split")
    assert fa.library_bwd_design(T, 2) == fa.bwd_design(T, 2)
    assert fa.library_bwd_design(T, 4) == fa.bwd_design(T, 4) == "wgmma_tf32"
    b0 = fa.mha_bwd.launches
    got = fa.mha_bwd(q, k, v, bias, g, **kw)
    want = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert fa.mha_bwd.launches == b0 + 1
    assert _mha_ratio(got, want) <= MHA_TOL[dt, "bwd"]
    assert all(torch.equal(a, b) for a, b in zip(got, fa.mha_bwd(q, k, v, bias, g, **kw)))


# Key counts at every edge of the fp32 kernels' tiling (64-row query and
# key tiles, 8-key product steps, the forward's one streaming pass and the
# backward's pair at every T): one and two keys, 31 / 32 / 33 and 63 / 64
# / 65, ViT's 197, 257, 320 / 321 and 325, 512 / 513, 577 (ViT at
# CV_resize=384), and a long row (4,097 keys, 128 wide).
MHA_FP32_EDGES = (1, 2, 31, 32, 33, 63, 64, 65, 197, 257, 320, 321, 325, 512, 513, 577, 4097)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T", MHA_FP32_EDGES)
def test_mha_fp32_kernels_match_plain_at_the_tile_edges(cuda_device, T, with_bias, rate):
    """#5 and #6 in fp32 (three TF32 passes on wgmma) at each edge of
    their tiling, eval and train mode, with and without the key bias (the
    first image all padding): one launch of each wrapper, both within the
    fp32 bound (1e-4) of their plain versions, the backward's design
    ``"wgmma_tf32"``, and two launches of each bit-equal."""
    D, H = (768, 12) if T <= 577 else (128, 2)
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, T, D, torch.float32, seed=T)
    bias = bias if with_bias else None
    kw = dict(n_heads=H, seed=808, rate=rate, layer=4)
    assert fa.library_bwd_design(T, 4) == fa.bwd_design(T, 4) == "wgmma_tf32"
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    out = fa.mha_fwd(q, k, v, bias, **kw)
    grads = fa.mha_bwd(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert fa.mha_fwd.launches == f0 + 1 and fa.mha_bwd.launches == b0 + 1
    assert out.dtype == torch.float32
    assert _mha_ratio([out], [fa.mha_fwd_plain(q, k, v, bias, **kw)]) <= \
        MHA_TOL[torch.float32, "fwd"]
    assert _mha_ratio(grads, fa.mha_bwd_plain(q, k, v, bias, g, **kw)) <= \
        MHA_TOL[torch.float32, "bwd"]
    assert torch.equal(out, fa.mha_fwd(q, k, v, bias, **kw))
    assert all(torch.equal(a, b) for a, b in zip(grads, fa.mha_bwd(q, k, v, bias, g, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["mha_fwd_tf32_kernel", "mha_bwd_dq_tf32_kernel",
                                     "mha_bwd_dkv_tf32_kernel"])
def test_attention_fp32_kernels_run_on_wgmma(cuda_device, pattern):
    """Each fp32 attention kernel (eval and train) has HGMMA (wgmma) in
    its SASS and no HMMA (mma.sync): the products run on the tensor cores."""
    from iisan_tpu_torch.kernels import build

    counts = build.sass_mma_counts(pattern)
    assert len(counts) == 2
    assert all(n["HGMMA"] > 0 and n["HMMA"] == 0 for n in counts.values()), counts


@pytest.mark.cuda
def test_mha_fp32_raises_on_a_misaligned_view(cuda_device):
    """The fp32 kernels read q, k, v and g by TMA (16-byte aligned
    starts): a misaligned view raises in both wrappers with no launch."""
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 197, 768, torch.float32)
    flat = torch.zeros(q.numel() + 1, dtype=torch.float32, device=cuda_device)
    odd = flat[1:].view(q.shape).copy_(q)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.mha_fwd(odd, k, v, bias, n_heads=12)
    with pytest.raises(ValueError, match="16-byte"):
        fa.mha_bwd(q, k, v, bias, odd, n_heads=12)
    assert fa.mha_fwd.launches == f0 and fa.mha_bwd.launches == b0


@pytest.mark.cuda
def test_attention_backward_cluster_kernels_run_on_wgmma(cuda_device):
    """Each instance of #6's cluster design (one to eight key blocks, eval
    and train) has HGMMA (wgmma) in its SASS and no HMMA (mma.sync)."""
    from iisan_tpu_torch.kernels import build

    counts = build.sass_mma_counts("mha_bwd_cluster_kernel")
    assert len(counts) == 16
    assert all(n["HGMMA"] > 0 and n["HMMA"] == 0 for n in counts.values()), counts


@pytest.mark.cuda
def test_every_attention_backward_kernel_runs_on_wgmma(cuda_device):
    """Every #6 instance, of each design (the cluster's 16, the split
    design's query-tile and key-tile kernels, the fp32 pair; eval and
    train), has HGMMA (wgmma) in its SASS and no HMMA (mma.sync)."""
    from iisan_tpu_torch.kernels import build

    counts = build.sass_mma_counts("mha_bwd_")
    split = [name for name in counts if "_split_kernel" in name]
    assert len(counts) == 24 and len(split) == 4, sorted(counts)
    assert all(n["HGMMA"] > 0 and n["HMMA"] == 0 for n in counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("blocks", range(1, 9))
def test_every_cluster_instance_can_be_scheduled(cuda_device, blocks, train):
    """The card holds at least one cluster of each instance of #6's cluster
    design (``cudaOccupancyMaxActiveClusters``), from one block of 64 keys
    to eight (512 keys)."""
    assert fa.cluster_blocks(64 * blocks) == blocks
    assert fa.active_clusters(64 * blocks, train, cuda_device) > 0


@pytest.mark.cuda
def test_mha_bwd_raises_where_a_cluster_cannot_be_scheduled(cuda_device, monkeypatch):
    """A cluster the card cannot schedule raises, naming its blocks, with no
    launch: no other design runs in its place."""
    dt = torch.bfloat16
    q, k, v, g, bias = _mha_inputs(cuda_device, 1, 448, 768, dt)
    monkeypatch.setattr(fa, "active_clusters", lambda T, train, device=None: 0)
    b0 = fa.mha_bwd.launches
    with pytest.raises(RuntimeError, match="cluster of 7 blocks"):
        fa.mha_bwd(q, k, v, bias, g, n_heads=12)
    assert fa.mha_bwd.launches == b0


@pytest.mark.cuda
def test_mha_bwd_raises_on_a_misaligned_bf16_view_and_autograd_aligns_g(cuda_device):
    """The cluster design reads q, k, v and g by TMA (16-byte aligned
    starts): a misaligned view raises with no launch, and ``FusedMHAFn``
    hands the kernel an aligned copy of a misaligned incoming gradient."""
    dt = torch.bfloat16
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 197, 768, dt)
    flat = torch.zeros(g.numel() + 1, dtype=dt, device=cuda_device)
    odd = flat[1:].view(g.shape).copy_(g)
    b0 = fa.mha_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.mha_bwd(q, k, v, bias, odd, n_heads=12)
    assert fa.mha_bwd.launches == b0
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.fused_mha(*leaves, 12, key_bias=bias).backward(odd)
    assert fa.mha_bwd.launches == b0 + 1
    want = fa.mha_bwd_plain(q, k, v, bias, g, n_heads=12)
    assert _mha_ratio([t.grad for t in leaves], want) <= MHA_TOL[dt, "bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [197, 257])
def test_train_mode_forward_and_its_gradient_through_both_kernels(cuda_device, T):
    """fused_mha in train mode at ViT's token counts: #5's forward and #6's
    gradient of it, each against its plain version (the same Philox
    masks)."""
    dt = torch.bfloat16
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, T, 768, dt, seed=7)
    kw = dict(n_heads=12, seed=99, rate=0.1, layer=4)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.fused_mha(*leaves, 12, key_bias=bias, drop_rate=0.1, seed=99, layer=4)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa.mha_fwd.launches == f0 + 1 and fa.mha_bwd.launches == b0 + 1
    assert _mha_ratio([out.detach()], [fa.mha_fwd_plain(q, k, v, bias, **kw)]) <= \
        MHA_TOL[dt, "fwd"]
    plain = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    assert _mha_ratio([t.grad for t in leaves], plain) <= MHA_TOL[dt, "bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["mha_fwd_resident_kernel", "mha_fwd_streamed_kernel",
                                     "subblock_attn_resident_kernel",
                                     "subblock_attn_streamed_kernel"])
def test_attention_forward_kernels_run_on_wgmma(cuda_device, pattern):
    """Each instance of the bf16 attention forward (resident at every key-
    chunk count, streamed; eval and train) has HGMMA (wgmma) in its SASS
    and no HMMA (mma.sync)."""
    from iisan_tpu_torch.kernels import build

    counts = build.sass_mma_counts(pattern)
    assert len(counts) == (10 if "resident" in pattern else 2)
    assert all(n["HGMMA"] > 0 and n["HMMA"] == 0 for n in counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T", [(8, 30), (2, 257), (1, 1024)])
def test_mha_train_mode_is_the_replayed_mask_oracle(cuda_device, dtype, B, T):
    D, H = 768 if T < 1024 else 128, 12 if T < 1024 else 2
    q, k, v, _, bias = _mha_inputs(cuda_device, B, T, D, dtype, seed=1)
    r0 = fa.mha_mask_replay.launches
    masks = fa.mha_mask_replay(555, B, T, H, 0.1, 7, cuda_device)
    assert fa.mha_mask_replay.launches == r0 + 1
    plain = fa.attention_dropout_masks(555, B, T, H, 0.1, 7, cuda_device)
    assert torch.equal(masks, plain)
    assert abs(float((masks > 0).float().mean()) - 0.9) < 0.01
    got = fa.mha_fwd(q, k, v, bias, n_heads=H, seed=555, rate=0.1, layer=7)
    want = fa.reference_mha_masked(q, k, v, bias, H, dtype, masks)
    assert _mha_ratio([got], [want]) <= MHA_TOL[dtype, "fwd"]


# (B, T, H, layer, rate, pad): every residue of T^2 mod 4 (197^2 and 257^2
# are 1 mod 4, so their planes start misaligned); more planes than grid y's
# 65,535 (5,462 x 12) and more rows (70,001); with pad, the masks go into a
# view of a buffer that starts ``pad`` floats in (1: misaligned, 4: 16
# bytes) with guard words on both sides.
MASK_REPLAY_CASES = (
    [(3, T, H, layer, rate, None) for T in (1, 2, 3, 5, 30, 197, 257) for H in (1, 12)
     for layer in (0, 11) for rate in (0.0, 0.1, 0.5)]
    + [(5462, 2, 12, 3, 0.1, None), (70001, 1, 1, 0, 0.5, None)]
    + [(4, T, 12, 5, 0.1, pad) for T in (30, 197) for pad in (1, 4)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,layer,rate,pad", MASK_REPLAY_CASES)
def test_mask_replay_is_bit_equal_to_the_plain_masks(cuda_device, B, T, H, layer, rate, pad):
    n = B * H * T * T
    r0 = fa.mha_mask_replay.launches
    if pad is None:
        got = fa.mha_mask_replay(97, B, T, H, rate, layer, cuda_device)
    else:
        buf = torch.full((n + pad + 7,), -7.0, device=cuda_device)
        view = buf[pad:pad + n].view(B, H, T, T)
        got = fa.mha_mask_replay(97, B, T, H, rate, layer, cuda_device, out=view)
        assert got.data_ptr() == view.data_ptr()
    want = fa.attention_dropout_masks(97, B, T, H, rate, layer, cuda_device)
    torch.cuda.synchronize()
    assert fa.mha_mask_replay.launches == r0 + 1
    assert torch.equal(got, want)
    if pad is not None:
        assert bool((buf[:pad] == -7).all()) and bool((buf[pad + n:] == -7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,T,D,H", [(torch.bfloat16, 8, 30, 768, 12),
                                           (torch.bfloat16, 4, 197, 768, 12),
                                           (torch.bfloat16, 2, 257, 768, 12),
                                           (torch.float32, 8, 30, 768, 12),
                                           (torch.float32, 2, 197, 768, 12),
                                           (torch.float32, 2, 257, 768, 12),
                                           (torch.float32, 2, 577, 768, 12)])
def test_mha_planted_faults_break_the_bounds(cuda_device, dtype, B, T, D, H):
    q, k, v, g, bias = _mha_inputs(cuda_device, B, T, D, dtype, seed=2)
    kw = dict(n_heads=H, seed=31, rate=0.1, layer=0)
    want = fa.mha_fwd_plain(q, k, v, bias, **kw)
    assert _mha_ratio([fa.mha_fwd(q, k, v, None, **kw)], [want]) > MHA_TOL[dtype, "fwd"]
    plain = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    assert _mha_ratio(fa.mha_bwd(q, k, v, bias, g, **dict(kw, seed=32)),
                      plain) > MHA_TOL[dtype, "bwd"]
    softmax_bwd = fa._softmax_bwd
    fa._softmax_bwd = lambda p32, gp: p32 * gp
    try:
        faulty = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    finally:
        fa._softmax_bwd = softmax_bwd
    assert _mha_ratio(faulty, fa.mha_bwd(q, k, v, bias, g, **kw)) > MHA_TOL[dtype, "bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rate,T", [(torch.bfloat16, 0.0, 197), (torch.bfloat16, 0.1, 197),
                                          (torch.float32, 0.1, 197), (torch.bfloat16, 0.1, 30),
                                          (torch.bfloat16, 0.0, 257), (torch.bfloat16, 0.1, 257),
                                          (torch.bfloat16, 0.1, 321), (torch.bfloat16, 0.1, 325),
                                          (torch.bfloat16, 0.0, 512), (torch.bfloat16, 0.1, 512),
                                          (torch.bfloat16, 0.1, 513), (torch.float32, 0.0, 197),
                                          (torch.float32, 0.1, 30), (torch.float32, 0.0, 577)])
def test_mha_bwd_repeats_bit_for_bit(cuda_device, dtype, rate, T):
    """Two launches on the same inputs (the FFT step's 88 images) give the
    same bits: no atomics, every sum in a fixed order (the cluster design
    combines its blocks' partials in rank order, from one block at 30 keys
    to five at 257, six at 321 and 325, eight at 512; the split design at
    513)."""
    q, k, v, g, bias = _mha_inputs(cuda_device, 88, T, 768, dtype, seed=4)
    kw = dict(n_heads=12, seed=5, rate=rate, layer=6)
    first = fa.mha_bwd(q, k, v, bias, g, **kw)
    second = fa.mha_bwd(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def mha_bwd_faulty(q, k, v, bias, g, fault, *, n_heads, seed=0, rate=0.0, layer=0):
    """``mha_bwd_plain``'s function with one planted fault of the bf16
    backward (fault None: the function itself).  Of the split design: the
    key-tile kernel's dropout element transposed to key * T + query; the
    row term taken as FlashAttention's rowsum(g * o); the key-tile kernel
    reading the statistics (max, sum, row term) of the neighbouring head.  Of the
    cluster design (blocks of 64 keys): block 0's partial of the rows'
    sums dropped; block 0's gQ partial dropped; each block's
    gS formed with its own partial row term instead of the cluster's."""
    dt = q.dtype
    B, T, D = q.shape
    H = n_heads
    inv = 1.0 / math.sqrt(D // H)
    qh, kh, vh, gh = (fa._split(t, H) for t in (q, k, v, g))
    s = (qh @ kh.transpose(-1, -2)) * inv
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    mx = s.amax(-1, keepdim=True)
    e = torch.exp(s - mx)
    first = slice(0, 64)  # the keys of the cluster's block 0
    total = e.sum(-1, keepdim=True)
    if fault == "cluster sum without block 0":
        total = total - e[..., first].sum(-1, keepdim=True)
    p32 = e / total
    masks = fa._masks(seed, rate, layer, B, T, H, q.device)
    if masks is None:
        masks = torch.ones_like(p32)
    g_pd = gh @ vh.transpose(-1, -2)
    term = (g_pd * masks * p32).sum(-1, keepdim=True)
    if fault == "flash row term":
        o = fa.mha_fwd_plain(q, k, v, bias, n_heads=H, seed=seed, rate=rate, layer=layer)
        term = (gh * fa._split(o, H)).sum(-1, keepdim=True)
    if fault == "cluster row term of each block alone":
        term = torch.cat([(g_pd * masks * p32)[..., j0:j0 + 64].sum(-1, keepdim=True)
                          .expand(*s.shape[:-1], min(64, T - j0))
                          for j0 in range(0, T, 64)], -1)

    def grad_s(p, m, t):
        return (p * (g_pd * m - t) * inv).to(dt).float()

    g_q = grad_s(p32, masks, term) @ kh
    if fault == "cluster gQ without block 0":
        g_q = g_q - grad_s(p32, masks, term)[..., first] @ kh[..., first, :]
    p_kv, m_kv, t_kv = p32, masks, term
    if fault == "dkv dropout transposed":
        m_kv = masks.transpose(-1, -2)
    elif fault == "dkv statistics of another head":
        p_kv = torch.exp(s - mx.roll(1, 1)) / total.roll(1, 1)
        t_kv = term.roll(1, 1)
    pd = (p_kv.to(dt).float() * m_kv).to(dt).float()
    g_v = pd.transpose(-1, -2) @ gh
    g_k = grad_s(p_kv, m_kv, t_kv).transpose(-1, -2) @ qh
    return fa._merge(g_q, dt), fa._merge(g_k, dt), fa._merge(g_v, dt)


# (T, fault): the split design's faults at one, four and six cluster
# blocks and on the split design itself (513), the cluster design's at
# four, five and eight blocks
MHA_BWD_FAULTS = (
    [(T, f) for T in (30, 197, 321, 513) for f in ("dkv dropout transposed", "flash row term",
                                                   "dkv statistics of another head")]
    + [(T, f) for T in (197, 257, 512) for f in ("cluster sum without block 0",
                                                 "cluster gQ without block 0",
                                                 "cluster row term of each block alone")])


@pytest.mark.cuda
@pytest.mark.parametrize("T,fault", MHA_BWD_FAULTS)
def test_mha_bwd_planted_faults_break_the_bound(cuda_device, T, fault):
    """Each fault breaks the bf16 bound that the kernels meet on the same
    inputs.  The dropout fault needs train mode.  FlashAttention's row term
    equals sum_j gP p up to the rounding of pd and o, and with random
    values the row term is small against gP (at 512 keys a block's partial
    in its place moves the gradients by 4.5% of their scale only), so the
    two row-term faults show where gP is nearly constant along a row:
    values that differ across keys by 1% of their size (eval mode)."""
    dt = torch.bfloat16
    q, k, v, g, bias = _mha_inputs(cuda_device, 4, T, 768, dt, seed=3)
    if fault in ("flash row term", "cluster row term of each block alone"):
        gen = torch.Generator().manual_seed(8)
        u = torch.randn(4, 1, 768, generator=gen).to(cuda_device)
        v = (u + 0.01 * v.float()).to(dt)
    rate = 0.1 if fault == "dkv dropout transposed" else 0.0
    kw = dict(n_heads=12, seed=41, rate=rate, layer=2)
    got = fa.mha_bwd(q, k, v, bias, g, **kw)
    plain = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert _mha_ratio(got, plain) <= MHA_TOL[dt, "bwd"]
    assert _mha_ratio(mha_bwd_faulty(q, k, v, bias, g, None, **kw), plain) == 0.0
    faulty = mha_bwd_faulty(q, k, v, bias, g, fault, **kw)
    assert _mha_ratio(faulty, got) > MHA_TOL[dt, "bwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [30, 197, 257, 577])
def test_mha_all_pad_rows_stay_finite(cuda_device, dtype, T):
    q, k, v, g, _ = _mha_inputs(cuda_device, 3, T, 768, dtype)
    bias = torch.full((3, T), -1e9, device=cuda_device)
    out = fa.mha_fwd(q, k, v, bias, n_heads=12)
    grads = fa.mha_bwd(q, k, v, bias, g, n_heads=12)
    assert all(torch.isfinite(t.float()).all() for t in (out, *grads))
    want = fa.mha_fwd_plain(q, k, v, bias, n_heads=12)
    assert _mha_ratio([out], [want]) <= MHA_TOL[dtype, "fwd"]
    # every key equally likely: each row is the mean of its head's values
    uniform = v.float().mean(1, keepdim=True).expand_as(out)
    assert _mha_ratio([out], [uniform.to(dtype)]) <= MHA_TOL[dtype, "fwd"]


@pytest.mark.cuda
def test_fused_mha_autograd_runs_both_kernels(cuda_device):
    q, k, v, g, bias = _mha_inputs(cuda_device, 4, 30, 256, torch.float32)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    grads = []
    for run in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if run == "kernel":
            out = fa.fused_mha(*leaves, 4, key_bias=bias, drop_rate=0.1, seed=5,
                               layer=2)
        else:
            masks = fa.attention_dropout_masks(5, 4, 30, 4, 0.1, 2, cuda_device)
            out = fa.reference_mha_masked(*leaves, bias, 4, torch.float32, masks)
        out.backward(g)
        grads.append([t.grad for t in leaves])
    assert fa.mha_fwd.launches == f0 + 1 and fa.mha_bwd.launches == b0 + 1
    assert _mha_ratio(grads[0], grads[1]) <= MHA_TOL[torch.float32, "bwd"]


@pytest.mark.cuda
def test_mha_fwd_raises_on_a_misaligned_bf16_view(cuda_device):
    """The bf16 forward reads q, k and v by TMA, which needs 16-byte
    aligned starts: a contiguous view one element into a buffer raises
    (no launch, no copy)."""
    q, k, v, _, bias = _mha_inputs(cuda_device, 2, 30, 768, torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    odd = flat[1:].view(q.shape).copy_(q)
    before = fa.mha_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.mha_fwd(odd, k, v, bias, n_heads=12)
    assert fa.mha_fwd.launches == before


@pytest.mark.cuda
def test_mha_raises_on_unsupported_shape(cuda_device):
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 30, 96, torch.float32)
    before, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    with pytest.raises(ValueError, match="does not take"):
        fa.mha_fwd(q, k, v, bias, n_heads=2)  # head width 48
    with pytest.raises(ValueError, match="does not take"):
        fa.mha_bwd(q, k, v, bias, g, n_heads=2)
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 197, 768, torch.float32)
    e = q[:, :0]  # no keys
    with pytest.raises(ValueError, match="does not take"):
        fa.mha_bwd(e, e, e, None, e, n_heads=12)
    assert fa.mha_fwd.launches == before and fa.mha_bwd.launches == b0


@pytest.mark.cuda
def test_fft_step_fp32_at_197_tokens_runs_the_kernels(cuda_device):
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
    from iisan_tpu_torch.data.synthetic import synthetic_corpus
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    corpus = synthetic_corpus(n_users=2, item_num=20, max_seq_len=4, seed=0)
    losses, state = {}, None
    for route in (True, False):
        cfg = IISANConfig(batch_size=2, epoch=1, embedding_dim=16,
                          word_embedding_dim=128, image_embedding_dim=128,
                          text_layers=2, image_layers=2, CV_resize=224,
                          num_words_title=6, max_seq_len=4,
                          side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
                          bert_adapter_down_size=8, cv_adapter_down_size=8,
                          compute_dtype="float32", tower_dropout=0.0, drop_rate=0.0,
                          fused_tower_attention=route)
        tr = UncachedTrainer(cfg, corpus, synthetic_token_table(20, 6),
                             SyntheticImageStore(224), device=cuda_device)
        assert tr.method == "fft"
        if state is None:
            state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        b0 = fa.mha_bwd.launches
        tr.run_epoch(1)
        losses[route] = float(tr._last_step_losses[-1])
        # 2 text + 2 image layers; the image layers' T is 197 (fp32: the
        # three-pass TF32 pair)
        assert fa.mha_bwd.launches - b0 == (4 if route else 0)
    assert abs(losses[True] - losses[False]) <= 1e-4 * abs(losses[False])


def _lora_bert_step(device, state, kw, cot, ids, mask, fused, remat):
    """One forward and backward of a LoRA BERT, the LoRA factors alone
    trainable (layer 0's input needs no gradient); returns (loss, the
    factors' gradients, mha_fwd and mha_bwd launches)."""
    from iisan_tpu_torch.models.bert import BertEncoder

    enc = BertEncoder(**kw, fused_attention=fused, remat=remat)
    enc.load_state_dict(state)
    enc.to(device)
    for n, p in enc.named_parameters():
        p.requires_grad_("lora_" in n)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    _, hiddens = enc(ids, mask, deterministic=False,
                     generator=torch.Generator(device).manual_seed(1))
    loss = (hiddens.float() * cot).sum()
    loss.backward()
    grads = {n: p.grad for n, p in enc.named_parameters() if "lora_" in n}
    return (loss.detach().reshape(1), grads,
            (fa.mha_fwd.launches - f0, fa.mha_bwd.launches - b0))


@pytest.mark.cuda
def test_lora_bert_through_the_attention_kernels_and_remat(cuda_device):
    """A 2-layer LoRA BERT at BERT-base width (rank 64 on q and v, bf16,
    dropout 0): through #5 / #6 and through the module path the loss and
    every ``lora_A`` / ``lora_B`` gradient agree within the bf16 bound
    (their only route to a gradient is #6's dq and dv); remat True and
    "mlp" give the no-remat kernel route's gradients within the same
    bound, #5 replayed in the backward."""
    from iisan_tpu_torch.models.bert import BertEncoder

    kw = dict(vocab_size=1000, hidden_dim=768, num_layers=2, num_heads=12,
              intermediate_dim=3072, dtype=torch.bfloat16, dropout=0.0,
              lora_rank=64, collect="cls")
    gen = torch.Generator().manual_seed(0)
    ref = BertEncoder(**kw, generator=gen)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            if n.endswith("lora_B"):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    state = ref.state_dict()
    ids = torch.randint(1, 1000, (16, 30), generator=gen).to(cuda_device)
    mask = torch.ones(16, 30, dtype=torch.long)
    mask[3, 17:] = 0
    mask = mask.to(cuda_device)
    cot = torch.randn((3, 16, 768), generator=gen).to(cuda_device)
    run = {}
    for name, fused, remat in (("module", False, False), ("kernels", True, False),
                               ("remat", True, True), ("mlp", True, "mlp")):
        run[name] = _lora_bert_step(cuda_device, state, kw, cot, ids, mask,
                                    fused, remat)
    assert run["module"][2] == (0, 0) and run["kernels"][2] == (2, 2)
    assert run["remat"][2] == (4, 2) and run["mlp"][2] == (4, 2)
    loss, grads, _ = run["kernels"]
    assert len(grads) == 8
    assert all(bool(g.abs().sum() > 0) for g in grads.values())
    _assert_grad_close(loss, run["module"][0], torch.bfloat16)
    for n, g in grads.items():
        _assert_grad_close(g, run["module"][1][n], torch.bfloat16)
    for other in ("remat", "mlp"):
        _assert_grad_close(run[other][0], loss, torch.bfloat16)
        for n, g in grads.items():
            _assert_grad_close(run[other][1][n], g, torch.bfloat16)


# ----------------------------------------------------------------------
# W8A8 linear (#10): bit-equal to int8_matmul on the card.
# ----------------------------------------------------------------------


def _w8a8_inputs(device, M, K, N, xdtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=gen, device=device) * 0.5
    x[min(1, M - 1)] = 0.0  # a zero row: its scale guard gives bias exactly
    w = torch.randn(K, N, generator=gen, device=device) * 0.05
    q, s = quantize_kernel(w.cpu().numpy())
    b = torch.randn(N, generator=gen, device=device)
    return (x.to(xdtype), torch.from_numpy(q).to(device),
            torch.from_numpy(s).to(device), b)


# (M, K, N, with_bias).  In bf16 only: the six tower shapes at the uncached
# step's ViT rows (704 x 197) and BERT rows (704 x 30), BERT-large's FFN,
# K past the earlier 6,272 limit, and ViT-tiny's D = 192 layers.
_W8A8_STEP = [(M, K, N, True) for M in (138688, 21120)
              for K, N in ((768, 768), (768, 3072), (3072, 768))] + [
    (21120, 4096, 1024, True), (21120, 1024, 4096, True), (3000, 8192, 1024, True),
    (513, 6336, 128, True), (138688, 192, 192, True), (138688, 192, 768, True),
    (138688, 768, 192, True)]
# In every dtype pair: ragged M (1, 127, 129, 300), K not a multiple of the
# 128-deep slice (320, 100, 77: K_p = 80 and a 1-element load path), N
# past a tile edge and not a multiple of 8 (200, 100, 37, 1), no bias.
_W8A8_EDGES = [(1, 256, 384, True), (127, 768, 768, True), (129, 768, 768, True),
               (300, 256, 384, True), (300, 320, 384, True), (300, 100, 256, True),
               (300, 77, 200, True), (129, 256, 100, True), (70, 192, 37, False),
               (33, 64, 1, True), (512, 128, 128, False), (7, 256, 256, False),
               (1000, 768, 3072, True), (513, 3072, 768, True)]
_W8A8_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype,odtype,M,K,N,with_bias", [
    (torch.bfloat16, torch.bfloat16, *shape) for shape in _W8A8_STEP] + [
    (*dt, *shape) for dt in _W8A8_DTYPES for shape in _W8A8_EDGES])
def test_w8a8_kernel_is_bit_equal_to_plain(cuda_device, xdtype, odtype, M, K, N,
                                           with_bias):
    x, q, s, b = _w8a8_inputs(cuda_device, M, K, N, xdtype)
    b = b if with_bias else None
    before = (fw.fused_w8a8_matmul.launches, fw.w8a8_quant_rows.launches,
              fw.w8a8_gemm.launches)
    got = fw.fused_w8a8_matmul(x, q, s, b, odtype)
    want = int8_matmul(x, q, s, b, odtype)
    torch.cuda.synchronize()
    assert (fw.fused_w8a8_matmul.launches, fw.w8a8_quant_rows.launches,
            fw.w8a8_gemm.launches) == tuple(n + 1 for n in before)
    assert got.dtype == odtype and got.shape == (M, N)
    assert torch.equal(got, want), f"{int((got != want).sum())} values differ"
    zero = want[min(1, M - 1)]
    assert torch.equal(zero, (b if with_bias else torch.zeros_like(s)).to(odtype))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K", [(300, 1), (300, 77), (300, 100), (1000, 768),
                                 (129, 3072), (33, 8192)])
def test_w8a8_quant_rows_is_bit_equal_to_quantize_rows(cuda_device, xdtype, M, K):
    x = _w8a8_inputs(cuda_device, M, K, 8, xdtype)[0]
    xq, sx = fw.w8a8_quant_rows(x)
    want_q, want_s = fw.w8a8_quant_rows_plain(x)
    torch.cuda.synchronize()
    assert xq.shape == (M, fw.padded_k(K)) and xq.dtype == torch.int8
    assert torch.equal(xq, want_q) and torch.equal(sx, want_s)
    assert not xq[:, K:].any()
    # rows that do not start on 16 bytes take the 1-element loads
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(M, K)
    assert flat.data_ptr() % 16
    xq1, sx1 = fw.w8a8_quant_rows(flat)
    assert torch.equal(xq1, want_q) and torch.equal(sx1, want_s)


@pytest.mark.cuda
def test_w8a8_3d_input_and_planted_faults(cuda_device):
    x, q, s, b = _w8a8_inputs(cuda_device, 4 * 75, 256, 128, torch.bfloat16, seed=3)
    x3 = x.reshape(4, 75, 256)
    got = fw.fused_w8a8_matmul(x3, q, s, b, torch.bfloat16)
    assert got.shape == (4, 75, 128)
    assert torch.equal(got, int8_matmul(x3, q, s, b, torch.bfloat16))
    xq, sx = quantize_rows(x)
    trunc = torch.clamp(torch.trunc(x.float() * (1 / sx.clamp_min(1e-30))), -127, 127)
    per_tensor = sx.max()
    faults = {
        "bias dropped": int8_matmul(x, q, s, None, torch.bfloat16),
        "rint -> toward zero": ((trunc.double() @ q.double()).float() * (sx * s)
                                + b).to(torch.bfloat16),
        "one activation scale": ((torch.round(x.float() / per_tensor).double()
                                  @ q.double()).float() * (per_tensor * s)
                                 + b).to(torch.bfloat16),
    }
    flat = fw.fused_w8a8_matmul(x, q, s, b, torch.bfloat16)
    for name, faulty in faults.items():
        assert not torch.equal(flat, faulty), name


def _w8a8_layout_faults(xq, sx, wt, s, b, dtype):
    """What the GEMM would give with the last 128-deep K slice dropped, and
    with each 128 x 128 block of the (N, K_p) weight read MN-major (as
    sm90_gemm.cuh's bf16 ``desc_w`` would read it): transposed."""
    N, Kp = wt.shape
    assert N % 128 == 0 and Kp % 128 == 0
    dropped = xq.clone()
    dropped[:, Kp - 128:] = 0
    mn_major = wt.reshape(N // 128, 128, Kp // 128, 128).transpose(1, 3).reshape(N, Kp)
    return {"last K slice dropped": fw.w8a8_gemm_plain(dropped, sx, wt, s, b, dtype),
            "B read MN-major": fw.w8a8_gemm_plain(xq, sx, mn_major, s, b, dtype)}


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1000, 768, 768), (300, 3072, 768)])
def test_w8a8_planted_layout_faults_break_equality(cuda_device, M, K, N):
    x, q, s, b = _w8a8_inputs(cuda_device, M, K, N, torch.bfloat16, seed=4)
    got = fw.fused_w8a8_matmul(x, q, s, b, torch.bfloat16)
    xq, sx = fw.w8a8_quant_rows_plain(x)
    wt = fw.transposed_weight(q)
    assert torch.equal(got, fw.w8a8_gemm_plain(xq, sx, wt, s, b, torch.bfloat16))
    for name, faulty in _w8a8_layout_faults(xq, sx, wt, s, b, torch.bfloat16).items():
        assert not torch.equal(got, faulty), name


@pytest.mark.cuda
def test_w8a8_raises_on_unsupported_geometry(cuda_device):
    """What is still refused: another dtype, inputs on two devices, a
    weight that does not match x or is not the padded transpose."""
    x, q, s, b = _w8a8_inputs(cuda_device, 8, 200, 128, torch.float32)
    before = (fw.fused_w8a8_matmul.launches, fw.w8a8_gemm.launches)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fw.fused_w8a8_matmul(x.half(), q, s, b, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fw.fused_w8a8_matmul(x, q, s, b, torch.float16)
    with pytest.raises(ValueError, match="one device"):
        fw.fused_w8a8_matmul(x, q.cpu(), s, b, torch.float32)
    with pytest.raises(ValueError, match="features"):
        fw.fused_w8a8_matmul(x[:, :100], q, s, b, torch.float32)
    with pytest.raises(ValueError, match="transpose"):  # (N, K), not (N, K_p)
        fw.fused_w8a8_matmul(x, q, s, b, torch.float32, kernel_qt=q.t().contiguous())
    with pytest.raises(ValueError, match="float32"):
        fw.fused_w8a8_matmul(x, q, s.double(), b, torch.float32)
    assert (fw.fused_w8a8_matmul.launches, fw.w8a8_gemm.launches) == before


@pytest.mark.cuda
def test_int8_dense_runs_the_kernel_and_its_gradient(cuda_device):
    dense = Int8Dense(256, 384, torch.bfloat16,
                      generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.randn(33, 256, device=cuda_device).to(torch.bfloat16)
    before = fw.fused_w8a8_matmul.launches
    y = dense(x)
    assert fw.fused_w8a8_matmul.launches == before + 1
    dense.fused = False
    assert torch.equal(y, dense(x))
    dense.fused = True
    leaf = x.float().requires_grad_(True)
    dense(leaf).float().sum().backward()
    plain = x.float().requires_grad_(True)
    int8_matmul(plain, dense.kernel_q, dense.kscale, dense.bias,
                torch.bfloat16).float().sum().backward()
    assert torch.allclose(leaf.grad, plain.grad, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Attention subblocks (#8, #9)
# ----------------------------------------------------------------------


def _subblock_inputs(device, B, T, D, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, D, generator=gen).to(device, torch.bfloat16)
    wqkv = (torch.randn(D, 3 * D, generator=gen) / D ** 0.5).to(device, torch.bfloat16)
    bqkv = (torch.randn(3 * D, generator=gen) * 0.3).to(device)
    wo = (torch.randn(D, D, generator=gen) / D ** 0.5).to(device, torch.bfloat16)
    bo = (torch.randn(D, generator=gen) * 0.3).to(device)
    lengths = torch.randint(1, T + 1, (B,), generator=gen)
    lengths[0] = 0
    bias = torch.where(torch.arange(T)[None] < lengths[:, None], 0.0, -1e9).to(device)
    return x, wqkv, bqkv, wo, bo, bias


SUBBLOCK = {False: fsb.fused_attn_subblock, True: fsb.fused_attn_subblock_v2}


def _counter(v2, H):
    """The launch counter a call counts on: v2 with heads that split into
    no groups of 4 runs #8's kernels (the JAX op's fallback)."""
    return SUBBLOCK[v2 and H % fsb.GROUP == 0]


def _qkv_ratio(got, want):
    """max |got - want| / (2^-7 |want| + 1e-4 max|want|): within 1 where
    the two differ by at most one bf16 rounding of each value (fp32 sums in
    another order round to a neighbouring bf16 number)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return float("inf")
    bound = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
    return float(((got - want).abs() / bound).max())


# The projection GEMM alone: row counts with a partial last 128-row tile
# (300, 1000) and whole ones (256, and BERT's step rows, 704 x 30 =
# 165 x 128), N = 3D at D = 192, 768 and 1024; #9's biases rounded to bf16.
@pytest.mark.cuda
@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("M,D", [(300, 192), (1000, 768), (256, 768), (21120, 768),
                                 (300, 1024), (1, 64)])
def test_qkv_projection_matches_fp32_product(cuda_device, rounded, M, D):
    gen = torch.Generator().manual_seed(M + D)
    x = torch.randn(M, D, generator=gen).to(cuda_device, torch.bfloat16)
    w = (torch.randn(D, 3 * D, generator=gen) / D ** 0.5).to(cuda_device, torch.bfloat16)
    b = (torch.randn(3 * D, generator=gen) * 0.3).to(cuda_device)
    if rounded:
        b = b.to(torch.bfloat16).float()
    before = fsb.qkv_projection.launches
    got = fsb.qkv_projection(x, w, b)
    want = fsb.qkv_projection_plain(x, w, b)
    torch.cuda.synchronize()
    assert fsb.qkv_projection.launches == before + 1
    assert got.shape == (3, M, D) and got.dtype == torch.bfloat16
    assert _qkv_ratio(got, want) <= 1.0
    assert torch.equal(got, fsb.qkv_projection(x, w, b))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["k from the neighbour head", "ragged tile not stored"])
def test_qkv_projection_planted_faults_break_the_bound(cuda_device, fault):
    M, D = 1000, 768  # 7 whole 128-row tiles and 104 rows
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(M, D, generator=gen).to(cuda_device, torch.bfloat16)
    w = (torch.randn(D, 3 * D, generator=gen) / D ** 0.5).to(cuda_device, torch.bfloat16)
    b = torch.randn(3 * D, generator=gen).to(cuda_device)
    got = fsb.qkv_projection(x, w, b)
    want = fsb.qkv_projection_plain(x, w, b)
    assert _qkv_ratio(got, want) <= 1.0
    bad = got.clone()
    if fault == "k from the neighbour head":
        bad[1, :, 64:128] = got[1, :, 128:192]
    else:
        bad[:, 896:] = 0
    assert _qkv_ratio(bad, want) > 1.0, fault


# Key counts at the tiles' edges and past the earlier 320-key limit (325:
# CV_resize=288, 577: 384 pixels, and 1024, through #5's streamed keys),
# D = 192 with three heads, and v2 at 3 and 6 heads (#8's function on #8's
# counter).
@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,D,H", [(6, 30, 768, 12), (3, 197, 768, 12),
                                     (5, 77, 256, 4), (2, 1, 256, 4),
                                     (4, 33, 512, 8), (2, 256, 256, 4),
                                     (2, 257, 768, 12), (1, 320, 256, 4),
                                     (2, 325, 768, 12), (1, 577, 768, 12),
                                     (1, 1024, 128, 2), (4, 33, 192, 3), (3, 50, 384, 6)])
def test_subblock_kernels_match_plain(cuda_device, v2, rate, B, T, D, H):
    x, wqkv, bqkv, wo, bo, bias = _subblock_inputs(cuda_device, B, T, D)
    op, counter = SUBBLOCK[v2], _counter(v2, H)
    before = counter.launches
    kw = dict(n_heads=H, seed=977, rate=rate, layer=3)
    got = op(x, wqkv, bqkv, wo, bo, H, key_bias=bias, drop_rate=rate,
             seed=977 if rate else None, layer=3)
    want = fsb.subblock_fwd_plain(x, wqkv, bqkv, wo, bo, bias, v2=v2, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and got.dtype == torch.bfloat16
    assert _mha_ratio([got], [want]) <= MHA_TOL[torch.bfloat16, "fwd"]
    # no atomics: the kernels repeat bit for bit
    assert torch.equal(got, op(x, wqkv, bqkv, wo, bo, H, key_bias=bias,
                               drop_rate=rate, seed=977 if rate else None, layer=3))


@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("B,T", [(8, 30), (2, 197), (2, 257), (2, 325), (1, 577)])
def test_subblock_train_mode_is_the_replayed_mask_oracle(cuda_device, v2, B, T):
    D, H = 768, 12
    x, wqkv, bqkv, wo, bo, bias = _subblock_inputs(cuda_device, B, T, D, seed=1)
    masks = fa.mha_mask_replay(555, B, T, H, 0.1, 7, cuda_device)
    dt = torch.bfloat16
    if v2:
        wg, bg, wog = fsb.group_weights(wqkv, bqkv.to(dt).float(), wo, H)
        want = fsb.reference_subblock_v2(x, wg, bg, wog, bo.to(dt).float(), bias,
                                         H, fsb.GROUP, dt, masks).to(dt)
    else:
        want = fsb.reference_subblock(x, wqkv, bqkv, wo, bo, bias, H, dt, masks)
    got = SUBBLOCK[v2](x, wqkv, bqkv, wo, bo, H, key_bias=bias, drop_rate=0.1,
                       seed=555, layer=7)
    assert _mha_ratio([got], [want]) <= MHA_TOL[dt, "fwd"]


@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("T", [30, 325])
def test_subblock_planted_faults_break_the_bound(cuda_device, v2, T):
    B, D, H = 8 if T == 30 else 2, 768, 12
    x, wqkv, bqkv, wo, bo, bias = _subblock_inputs(cuda_device, B, T, D, seed=2)
    op = SUBBLOCK[v2]
    kw = dict(n_heads=H, seed=31, rate=0.1, layer=0, v2=v2)
    want = fsb.subblock_fwd_plain(x, wqkv, bqkv, wo, bo, bias, **kw)
    skipped = wo.clone()
    skipped[64:128] = 0  # head 1's rows of Wo
    faults = {
        "key bias dropped": op(x, wqkv, bqkv, wo, bo, H, key_bias=None,
                               drop_rate=0.1, seed=31),
        "one head's Wo rows skipped": op(x, wqkv, bqkv, skipped, bo, H,
                                         key_bias=bias, drop_rate=0.1, seed=31),
        "masks of another seed": op(x, wqkv, bqkv, wo, bo, H, key_bias=bias,
                                    drop_rate=0.1, seed=32),
    }
    for name, got in faults.items():
        assert _mha_ratio([got], [want]) > MHA_TOL[torch.bfloat16, "fwd"], name


@pytest.mark.cuda
def test_subblock_all_pad_rows_stay_finite_and_shapes_raise(cuda_device):
    x, wqkv, bqkv, wo, bo, _ = _subblock_inputs(cuda_device, 3, 197, 768)
    bias = torch.full((3, 197), -1e9, device=cuda_device)
    for op in SUBBLOCK.values():
        assert torch.isfinite(op(x, wqkv, bqkv, wo, bo, 12, key_bias=bias).float()).all()
    before = fsb.fused_attn_subblock.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fsb.fused_attn_subblock(x.float(), wqkv, bqkv, wo, bo, 12)
    with pytest.raises(ValueError, match="does not take"):
        fsb.fused_attn_subblock(x[:, :, :96], wqkv[:96, :288], bqkv[:288],
                                wo[:96, :96], bo[:96], 2)  # head width 48
    with pytest.raises(ValueError, match="does not take"):
        fsb.fused_attn_subblock_v2(x, wqkv, bqkv, wo, bo, 6)  # 6 heads of 128
    x = torch.zeros(1, fsb.MAX_KEYS + 1, 768, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):  # past 46,340 keys
        fsb.fused_attn_subblock(x, wqkv, bqkv, wo, bo, 12)
    assert fsb.fused_attn_subblock.launches == before


@pytest.mark.cuda
def test_subblock_v2_without_whole_groups_runs_8_on_its_counter(cuda_device):
    """v2 at 6 heads (D = 384) and 3 heads (D = 192) is #8's function with
    the original biases, launched through #8's kernels and counted there."""
    for B, T, D, H in ((3, 50, 384, 6), (4, 33, 192, 3)):
        x, wqkv, bqkv, wo, bo, bias = _subblock_inputs(cuda_device, B, T, D, seed=4)
        n8, n9 = fsb.fused_attn_subblock.launches, fsb.fused_attn_subblock_v2.launches
        got = fsb.fused_attn_subblock_v2(x, wqkv, bqkv, wo, bo, H, key_bias=bias)
        assert fsb.kernel_for(True, B, T, D, H) == "attn_subblock_fwd"
        assert (fsb.fused_attn_subblock.launches, fsb.fused_attn_subblock_v2.launches) \
            == (n8 + 1, n9)
        assert torch.equal(got, fsb.fused_attn_subblock(x, wqkv, bqkv, wo, bo, H,
                                                        key_bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True])
def test_subblock_eval_backward_is_the_plain_gradient(cuda_device, v2):
    x, wqkv, bqkv, wo, bo, bias = _subblock_inputs(cuda_device, 4, 30, 256, seed=3)
    g = torch.randn_like(x)
    grads = []
    for run in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (x, wqkv, bqkv, wo, bo)]
        if run == "kernel":
            out = SUBBLOCK[v2](*leaves, 4, key_bias=bias)
        else:
            out = fsb.subblock_fwd_plain(*leaves, bias, n_heads=4, v2=v2)
        out.backward(g)
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    leaves = [t.clone().requires_grad_(True) for t in (x, wqkv, bqkv, wo, bo)]
    with pytest.raises(NotImplementedError, match="dropout"):
        SUBBLOCK[v2](*leaves, 4, key_bias=bias, drop_rate=0.1, seed=5).backward(g)


def _cache_tower(kind, device):
    """A BERT-base- or ViT-base-wide tower of 2 layers, bf16, the attention
    through #5 (``towers_from_config``'s tower settings)."""
    from iisan_tpu_torch.models.bert import BertEncoder
    from iisan_tpu_torch.models.vit import ViTEncoder

    gen = torch.Generator(device).manual_seed(7)
    kw = dict(hidden_dim=768, num_layers=2, num_heads=12, intermediate_dim=3072,
              dtype=torch.bfloat16, fused_attention=True, collect="cls",
              device=device, generator=gen)
    return (BertEncoder(dropout=0.1, **kw) if kind == "text"
            else ViTEncoder(dropout=0.0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text", "image"])
def test_cache_build_runs_mha_fwd_and_shards_are_bit_equal(cuda_device, kind, tmp_path):
    """The cache builder's batch (128 titles x 30 tokens, 128 images x 197)
    through #5, two launches a batch; a build in three shards on one store
    is the single build bit for bit (every launch has the same M)."""
    import numpy as np

    from iisan_tpu_torch import cache_builder as cb
    from iisan_tpu_torch.data.cache_store import HiddenStateCache
    from iisan_tpu_torch.data.images import SyntheticImageStore, synthetic_token_table
    from iisan_tpu_torch.tools.build_caches import shard_range

    n = 300
    enc = _cache_tower(kind, cuda_device)
    tokens = synthetic_token_table(n - 1, 30, seed=1)
    tokens[1::3, 20:30] = 0  # padded titles: the key bias matters
    names = ["<pad>"] + [f"item{i}" for i in range(1, n)]
    images = SyntheticImageStore(224)

    def build(path, **kw):
        if kind == "text":
            return cb.build_text_cache(enc, tokens, str(path), batch=128,
                                       device=cuda_device, **kw)
        return cb.build_image_cache(enc, names, images, str(path), batch=128,
                                    device=cuda_device, **kw)

    before = fa.mha_fwd.launches
    single = build(tmp_path / "single")
    assert fa.mha_fwd.launches - before == 2 * 3  # 3 batches of 128
    for shard in range(3):
        lo, hi = shard_range(n, shard, 3)
        build(tmp_path / "shared", start_item=lo, end_item=hi)
    shared = HiddenStateCache.open(str(tmp_path / "shared"))
    assert np.array_equal(np.asarray(shared._arr), np.asarray(single._arr))
    rows = single.load_full()
    assert np.isfinite(rows).all() and not rows[0].any() and rows[1:].any()


@pytest.mark.cuda
def test_llama_layer_bf16_matches_fp32(cuda_device):
    """One Llama layer (GQA 8 / 2, rope theta 5e5) in bf16 on the card
    against the same weights in fp32: max |diff| / max |fp32| < 0.05."""
    from iisan_tpu_torch.models.llama import LlamaEncoder

    kw = dict(vocab_size=1000, hidden_dim=1024, num_layers=1, num_heads=8,
              num_kv_heads=2, intermediate_dim=2816, rope_theta=500000.0,
              device=cuda_device)
    ref = LlamaEncoder(dtype=torch.float32,
                       generator=torch.Generator(cuda_device).manual_seed(3), **kw)
    low = LlamaEncoder(dtype=torch.bfloat16, **kw)
    low.load_state_dict(ref.state_dict())
    g = torch.Generator(cuda_device).manual_seed(4)
    ids = torch.randint(0, 1000, (16, 30), device=cuda_device, generator=g)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        want = ref(ids, mask)[1].float()
        got = low(ids, mask)[1].float()
    assert torch.isfinite(got).all() and got.shape == (2, 16, 30, 1024)
    assert float((got - want).abs().max() / want.abs().max()) < 0.05


def _write_run_dataset(root, cached: bool):
    """The tiny TSV dataset of the CPU run-path tests (30 items, 15 users)
    and, for the cached pipeline, two fp32 stores of width 32."""
    import numpy as np

    from iisan_tpu_torch.data.cache_store import HiddenStateCache

    rng = np.random.default_rng(0)
    with open(root / "items.tsv", "w") as f:
        for i in range(30):
            f.write(f"I{i:04d}\tTitle of item {i}\n")
    with open(root / "users.tsv", "w") as f:
        for u in range(15):
            seq = " ".join(f"I{int(x):04d}" for x in
                           rng.integers(0, 30, size=int(rng.integers(5, 12))))
            f.write(f"U{u}\t{seq}\n")
    if cached:
        for name in ("bert_outputs", "vit_outputs"):
            st = HiddenStateCache.create(str(root / "vecs" / f"{name}.memmap"),
                                         31, 13, 32, "float32")
            st.write_rows(1, rng.standard_normal((30, 13, 32)).astype("float32"))
            st.flush()


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["cached", "id"])
def test_run_from_config_trains_through_the_encoder_kernels_and_resumes(
        cuda_device, pipeline, tmp_path):
    """run_from_config on the card (bf16): both encoder kernels launch a
    step, and 1 epoch + checkpoint + resume + 1 epoch is the 2-epoch run
    bit for bit (parameters and Adam moments)."""
    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.train.pipelines import run_from_config

    _write_run_dataset(tmp_path, pipeline == "cached")
    base = IISANConfig(
        root_data_dir=str(tmp_path), dataset="", behaviors="users.tsv",
        news="items.tsv", batch_size=8, embedding_dim=64,
        side_adapter_vit_list="1,3", side_adapter_bert_list="1,3",
        word_embedding_dim=32, image_embedding_dim=32,
        bert_adapter_down_size=8, cv_adapter_down_size=8, eval_batch_size=16,
        stored_vector_path=str(tmp_path / "vecs"), log_dir=str(tmp_path / "logs"),
        item_tower="id" if pipeline == "id" else "modal")

    def run(name, **kw):
        cfg = base.replace(ckpt_dir=str(tmp_path / name), **kw)
        return run_from_config(cfg, device=cuda_device)

    f0, b0 = fue.user_encoder_fwd.launches, fue.user_encoder_bwd.launches
    straight, res = run("straight", epoch=2)
    assert res.epochs_run == 2 and all(math.isfinite(x) for x in res.losses)
    steps = 2 * straight.epoch_permutation(1).shape[0]
    assert fue.user_encoder_bwd.launches - b0 == steps
    assert fue.user_encoder_fwd.launches - f0 >= steps  # + the evaluations

    run("split", epoch=1)
    resumed, res2 = run("split", epoch=1, load_ckpt_name="epoch-1")
    assert res2.epochs_run == 2
    for (name, a), b in zip(straight.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    for sa, sb in zip(straight.optimizer.state.values(),
                      resumed.optimizer.state.values()):
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert resumed.evaluate_split("test") == straight.evaluate_split("test")


@pytest.mark.cuda
def test_one_rank_nccl_group_serves_and_trains_as_one_process(cuda_device):
    """On a one-rank NCCL group: ``ShardedRecommender`` (fp32 and int8
    tables) gives ``Recommender.top_k``'s ids (up to ties) and scores
    within 1e-5, and a ``data:1`` cached trainer, through the collectives
    of the data axis, the losses and parameters of the same trainer
    without a process group bit for bit."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from iisan_tpu_torch.config import IISANConfig
    from iisan_tpu_torch.data.synthetic import synthetic_corpus, synthetic_taps
    from iisan_tpu_torch.models.model import IISANRecModel
    from iisan_tpu_torch.serve import Recommender, ShardedRecommender
    from iisan_tpu_torch.train.cached import CachedTrainer

    cfg = IISANConfig(batch_size=16, embedding_dim=64, side_adapter_vit_list="1,3",
                      side_adapter_bert_list="1,3", word_embedding_dim=32,
                      image_embedding_dim=32, bert_adapter_down_size=8,
                      cv_adapter_down_size=8, eval_batch_size=32)
    corpus = synthetic_corpus(n_users=64, item_num=300, seed=1)
    taps = synthetic_taps(300, 3, 32, 1), synthetic_taps(300, 3, 32, 2)

    def train(mesh_shape):
        tr = CachedTrainer(cfg.replace(mesh_shape=mesh_shape), corpus, *taps,
                           device=cuda_device)
        losses = [tr.run_epoch(e) for e in (1, 2)]
        return tr, losses, tr._last_step_losses.cpu()

    plain, plain_losses, plain_steps = train("")
    model = IISANRecModel(None, 64, 10, 2, 2, 0.0, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    table = torch.randn(1000, 64, device=cuda_device)
    seqs = [[1, 2, 999], [500, 501, 3, 4], list(range(10, 40)), [998]]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        for rec in (Recommender(model, table, 10),
                    Recommender(model, table, 10).quantize_table()):
            want = rec.top_k(seqs, k=20)
            got = ShardedRecommender(rec).top_k(seqs, k=20)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
            for row in range(len(seqs)):
                for j in np.flatnonzero(got[0][row] != want[0][row]):
                    assert np.isclose(got[1][row, j], want[1][row, j], rtol=1e-5)
        ranked, ranked_losses, ranked_steps = train("data:1")
        assert ranked.shard is not None and ranked.shard.group is not None
        ranked_eval = ranked.evaluate_split("valid")  # gathered over the axis
    finally:
        dist.destroy_process_group()
    assert ranked_losses == plain_losses
    assert torch.equal(ranked_steps, plain_steps)
    for (name, a), b in zip(plain.model.named_parameters(),
                            ranked.model.parameters()):
        assert torch.equal(a, b), name
    assert ranked_eval == plain.evaluate_split("valid")


@pytest.mark.cuda
def test_bitfit_layer_norm_bias_gradient_at_vit_batch_32_rows(cuda_device):
    """BitFit's ViT at batch 32 normalises 352 x 197 = 69,344 rows with a
    frozen scale and a trained bias, where PyTorch 2.11's CUDA backward
    returns an empty bias gradient: the port's LayerNorm gives the bias
    the sum of its output gradient, and x the gradient of the route with
    both parameters trained."""
    from iisan_tpu_torch.models.modules import LayerNorm

    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(352, 197, 768, generator=gen).to(cuda_device, torch.bfloat16)
    cot = torch.randn(352, 197, 768, generator=gen).to(cuda_device)
    grads = {}
    for trains_scale in (False, True):
        ln = LayerNorm(768, device=cuda_device)
        ln.scale.requires_grad_(trains_scale)
        x = x0.clone().requires_grad_()
        (ln(x) * cot).sum().backward()
        grads[trains_scale] = (x.grad.float(), ln.bias.grad)
    assert grads[False][1].shape == (768,)
    want = cot.sum((0, 1))
    assert torch.allclose(grads[False][1], want, rtol=1e-4, atol=1e-2)
    assert torch.allclose(grads[False][1], grads[True][1], rtol=1e-4, atol=1e-2)
    assert torch.allclose(grads[False][0], grads[True][0], rtol=2**-7, atol=1e-6)
