"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere (the
kernels have no CPU mode).  The file imports no JAX, so on a machine
without it the tests run with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX).

Shapes cover the serving and training paths' and awkward ones: batch 1
and 3, all-pad sequences, one block, row counts that are not a multiple of
the cascade kernel's 16-row tile, widths that are not a multiple of its
256 threads, and every bottleneck that divides 256.  Train mode uses the
same Philox masks in kernel and plain version, so it is held to the same
bounds as eval mode.

Tolerances.  fp32: |kernel - plain| <= 1e-4 * (1 + |plain|) (summation
order differs over up to 768 terms).  bf16 user encoder: the same form at
5e-2, as the JAX package's own bf16 encoder test (a value may round to the
neighbouring bf16 number, 2^-8 relative, and LayerNorm carries it on).
Encoder backward: gx and each parameter gradient per tensor, |diff| <=
tol * (max|plain| + |plain|), tol 1e-4 fp32 and 5e-2 bf16 (the kernel
sums each sequence's gradient then the sequences; the plain version sums
all rows at once).  bf16 cascade: element by element, four bf16 ulps of the row's largest
|carry| plus 1e-3 (``fused_san.carry_tolerance``): the carry is additive
across the K steps, so a one-ulp rounding difference at a large
intermediate value survives into a final value that may be small.  The
cascade inputs make every term move the carry by O(1) (wd ~ N(0, 1/D),
wu ~ N(0, 1/R), biases ~ N(0, 0.25)), so a wrong term breaks the bound;
tests/test_torch_fused_san.py shows that it does for planted faults.
Attention kernels (mha_fwd, mha_bwd): per tensor, |diff| <= tol * (max|plain|
+ |plain|), tol 1e-4 fp32 and 2e-2 (forward) / 5e-2 (backward) bf16: a
probability may round to the neighbouring bf16 value on one side only; the
mask replay kernel is bit-equal to its plain version.  Planted faults (the
key bias dropped on a padded batch, the backward run with another seed,
the softmax row term dropped from the backward) must break those bounds.
"""

import pytest
import torch

from iisan_tpu_torch.models.user_encoder import UserEncoder, causal_additive_mask
from iisan_tpu_torch.ops import fused_attention as fa
from iisan_tpu_torch.ops import fused_san as fs
from iisan_tpu_torch.ops import fused_user_encoder as fue
from iisan_tpu_torch.ops import philox

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
                                         (37, 7, 48, 3, 1), (5, 20, 128, 4, 3)])
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
    # D=36 is not a multiple of 8: on the card the module raises instead of
    # running the module path.
    enc, x, mask3 = _encoder_inputs(cuda_device, 2, 10, 36, 2, 1,
                                    torch.float32)
    log_mask = (mask3[:, -1] == 0).float()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["RELU", "GELU"])
@pytest.mark.parametrize("S,N,K,D,R", [(3, 8192, 7, 768, 64), (1, 37, 3, 96, 8),
                                       (2, 100, 5, 300, 128), (3, 16, 1, 64, 256),
                                       (1, 1, 2, 32, 1)])
def test_cascade_kernel_matches_plain(cuda_device, dtype, activation, S, N, K,
                                      D, R):
    args = _cascade_inputs(cuda_device, S, N, K, D, R, dtype)
    before = fs.san_cascade_fwd.launches
    got = fs.san_cascade_fwd(*args, activation=activation)
    want = fs.san_cascade_fwd_plain(*args, activation=activation)
    torch.cuda.synchronize()
    assert fs.san_cascade_fwd.launches == before + 1
    _assert_close(got, want, dtype, carry=True)


@pytest.mark.cuda
def test_fused_cascade_is_the_kernel_at_s1(cuda_device):
    args = _cascade_inputs(cuda_device, 1, 50, 4, 64, 16, torch.bfloat16)
    gates = torch.randn(4, device=cuda_device)
    a, b = fs.cascade_coefs(gates, True)
    got = fs.fused_cascade(gates, *[t[0] for t in args[2:]])
    want = fs.san_cascade_fwd(a[None], b[None], *args[2:])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cascade_wrapper_rejects_bad_input(cuda_device):
    args = list(_cascade_inputs(cuda_device, 1, 8, 2, 64, 48, torch.float32))
    with pytest.raises(ValueError, match="bottleneck"):
        fs.san_cascade_fwd(*args)
    args = list(_cascade_inputs(cuda_device, 1, 8, 2, 64, 16, torch.float32))
    args[3] = args[3].half()
    with pytest.raises(TypeError):
        fs.san_cascade_fwd(*args)


def _assert_grad_close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    bound = TOL[dtype] * (want.abs().max() + want.abs())
    assert ((got - want).abs() <= bound).all(), f"max |diff| {(got - want).abs().max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,D,H,NL", [(64, 10, 64, 2, 2), (1, 10, 64, 2, 2),
                                         (3, 10, 64, 2, 1), (37, 7, 48, 3, 1)])
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
    gx_p, gp_p = fue.user_encoder_bwd_plain(x, mask3, params, gout, **kw)
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
    # Six blocks' recompute stash does not fit one block's shared memory.
    enc, x, mask3 = _encoder_inputs(cuda_device, 2, 10, 64, 2, 6, torch.float32)
    kw = dict(n_layers=6, n_heads=2, d_ff=256, n_position=10)
    params = enc.packed_params(torch.float32)
    assert fue.supported(2, 10, 64, 2, 256, 10)
    assert not fue.bwd_supported(2, 10, 64, 2, 256, 6, 10)
    before = fue.user_encoder_bwd.launches
    with pytest.raises(ValueError, match="does not take"):
        fue.user_encoder_bwd(x, mask3, params, torch.zeros_like(x), **kw)
    assert fue.user_encoder_bwd.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,D,H", [(6, 30, 768, 12), (3, 197, 768, 12),
                                     (5, 77, 128, 2), (2, 1, 64, 1),
                                     (4, 33, 192, 3)])
def test_mha_kernels_match_plain(cuda_device, dtype, rate, B, T, D, H):
    q, k, v, g, bias = _mha_inputs(cuda_device, B, T, D, dtype)
    kw = dict(n_heads=H, seed=977, rate=rate, layer=3)
    f0, b0 = fa.mha_fwd.launches, fa.mha_bwd.launches
    got = fa.mha_fwd(q, k, v, bias, **kw)
    want = fa.mha_fwd_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert fa.mha_fwd.launches == f0 + 1 and got.dtype == dtype
    assert _mha_ratio([got], [want]) <= MHA_TOL[dtype, "fwd"]
    if not fa.bwd_supported(B, T, D, H, q.element_size()):
        assert dtype == torch.float32 and T > 166
        return
    grads = fa.mha_bwd(q, k, v, bias, g, **kw)
    plain = fa.mha_bwd_plain(q, k, v, bias, g, **kw)
    torch.cuda.synchronize()
    assert fa.mha_bwd.launches == b0 + 1
    assert _mha_ratio(grads, plain) <= MHA_TOL[dtype, "bwd"]
    # no atomics: the backward repeats bit for bit
    assert all(torch.equal(a, b) for a, b in
               zip(grads, fa.mha_bwd(q, k, v, bias, g, **kw)))


@pytest.mark.cuda
def test_mha_train_mode_is_the_replayed_mask_oracle(cuda_device):
    B, T, D, H, dtype = 8, 30, 768, 12, torch.bfloat16
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(8, 30, 768, 12), (4, 197, 768, 12)])
def test_mha_planted_faults_break_the_bounds(cuda_device, B, T, D, H):
    dtype = torch.bfloat16
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
def test_mha_all_pad_rows_stay_finite(cuda_device):
    q, k, v, g, _ = _mha_inputs(cuda_device, 3, 197, 768, torch.bfloat16)
    bias = torch.full((3, 197), -1e9, device=cuda_device)
    out = fa.mha_fwd(q, k, v, bias, n_heads=12)
    grads = fa.mha_bwd(q, k, v, bias, g, n_heads=12)
    assert all(torch.isfinite(t.float()).all() for t in (out, *grads))
    want = fa.mha_fwd_plain(q, k, v, bias, n_heads=12)
    assert _mha_ratio([out], [want]) <= MHA_TOL[torch.bfloat16, "fwd"]


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
def test_mha_raises_on_unsupported_shape(cuda_device):
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 30, 96, torch.float32)
    before = fa.mha_fwd.launches
    with pytest.raises(ValueError, match="does not take"):
        fa.mha_fwd(q, k, v, bias, n_heads=2)  # head width 48
    q, k, v, g, bias = _mha_inputs(cuda_device, 2, 197, 768, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        fa.mha_bwd(q, k, v, bias, g, n_heads=12)  # fp32 block too large
    assert fa.mha_fwd.launches == before
