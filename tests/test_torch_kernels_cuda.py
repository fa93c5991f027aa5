"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere (the
kernels have no CPU mode).  The file imports no JAX, so on a machine
without it the tests run with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX).

Shapes cover the serving path's and awkward ones: batch 1, all-pad
sequences, row counts that are not a multiple of the kernel's 16-row
tile, widths that are not a multiple of its 256 threads, and every
bottleneck that divides 256.

Tolerances.  fp32: |kernel - plain| <= 1e-4 * (1 + |plain|) (summation
order differs over up to 768 terms).  bf16 user encoder: the same form at
5e-2, as the JAX package's own bf16 encoder test (a value may round to the
neighbouring bf16 number, 2^-8 relative, and LayerNorm carries it on).
bf16 cascade: element by element, four bf16 ulps of the row's largest
|carry| plus 1e-3 (``fused_san.carry_tolerance``): the carry is additive
across the K steps, so a one-ulp rounding difference at a large
intermediate value survives into a final value that may be small.  The
cascade inputs make every term move the carry by O(1) (wd ~ N(0, 1/D),
wu ~ N(0, 1/R), biases ~ N(0, 0.25)), so a wrong term breaks the bound;
tests/test_torch_fused_san.py shows that it does for planted faults.
"""

import pytest
import torch

from iisan_tpu_torch.models.user_encoder import UserEncoder, causal_additive_mask
from iisan_tpu_torch.ops import fused_san as fs
from iisan_tpu_torch.ops import fused_user_encoder as fue

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
