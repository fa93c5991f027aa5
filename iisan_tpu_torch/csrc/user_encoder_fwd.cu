// Fused SASRec user-encoder forward (eval mode), one launch for the whole
// post-LN encoder: positional add, input LayerNorm, then per block bias-free
// Q/K/V/O attention with an fp32 softmax over the additive mask, post-LN,
// ReLU FFN, post-LN.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_encoder_fwd_body` in
// iisan_tpu/ops/fused_user_encoder.py (called with train=False).
//
// What bounds it on the H100: neither the card's bytes nor its FLOPs.  At
// the serving geometry (L=10, D=64, H=2, F=256, 2 blocks) a sequence is 640
// activations and about 1 M multiply-adds, and the unfused module path is
// some forty small launches per call.  One launch removes those; what is
// left is the latency of a chain of small products on one SM, since a
// block of 256 threads runs one sequence.  So every activation stays in
// shared memory for the whole encoder; each weight matrix, which every
// output row reads, is staged in shared memory once per block instead of
// being read from L2 once per row (see linear()); and the weights arrive
// pre-rounded to T, so the inner loops convert nothing.  Batch 1 is a
// single block; batch 256 is about two blocks per SM.
//
// Cast chain (that of `_encoder_fwd_body` and `_attn_fwd`): products take
// T-rounded operands with fp32 accumulation and are rounded to T; the FFN
// bias adds in T; the scores are fp32 products of T-valued q and k; the
// softmax is fp32 and its probabilities are rounded to T before PV;
// LayerNorm statistics are fp32.  The mask is additive 0 / -1e9, so a query
// row whose keys are all masked gets the uniform softmax, never NaN.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace iisan {
namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;

struct EncoderDims {
  int L, D, H, F, n_layers, n_position;
};

constexpr int kWBuf = 16384;  // floats of shared memory for staged weights

// For each of n_mat matrices W_m = W + m*K*N (outputs at out + m*L*N):
// out_m[l, j] = round_T(sum_d in[l, d] * W_m[d, j]), then, with a bias,
// round_T(out + bias[j]) and optionally ReLU.  W and bias hold values
// already rounded to T (pack_encoder_params rounds them); N % 4 == 0 and W,
// out 16-byte aligned.
//
// Every row of the output reads every weight, so the weights are staged in
// shared memory (`wbuf`, kWBuf floats) first, as many rows of all n_mat
// matrices as fit (at the serving geometry, whole matrices): the block
// reads each weight from L2 once, all threads copying at once.  Then
// a thread computes four adjacent columns of one row: per step one
// broadcast load of x and one 16-byte load of W feed four independent FMA
// chains.  With K in several chunks, the fp32 partial sums wait in `out`;
// a thread owns the same outputs in every chunk, so they need no barrier.
template <typename T>
__device__ void linear(const float* in, const float* __restrict__ W,
                       const float* __restrict__ bias, float* out, float* wbuf,
                       int n_mat, int L, int K, int N, bool relu) {
  const int ng = N / 4, per_mat = L * ng;
  const int kc_max = max(1, min(K, kWBuf / (n_mat * N)));
  float4* wbuf4 = reinterpret_cast<float4*>(wbuf);
  for (int k0 = 0; k0 < K; k0 += kc_max) {
    const int kc = min(kc_max, K - k0);
    const int chunk4 = kc * ng;  // float4s of one matrix's chunk
    __syncthreads();             // the previous contents of wbuf are used
    // Asynchronous 16-byte copies: a thread has all of its copies in
    // flight at once instead of one load-then-store at a time.
    for (int idx = threadIdx.x; idx < n_mat * chunk4; idx += blockDim.x) {
      const int m = idx / chunk4, e = idx - m * chunk4;
      __pipeline_memcpy_async(
          wbuf4 + idx,
          reinterpret_cast<const float4*>(W + static_cast<size_t>(m) * K * N +
                                          static_cast<size_t>(k0) * N) + e,
          sizeof(float4));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const bool last = k0 + kc == K;
    for (int idx = threadIdx.x; idx < n_mat * per_mat; idx += blockDim.x) {
      const int m = idx / per_mat, rem = idx - m * per_mat;
      const int r = rem / ng, j4 = rem - r * ng;
      const float* x = in + r * K + k0;
      const float4* w = wbuf4 + m * chunk4 + j4;
      float4* o = reinterpret_cast<float4*>(out + m * L * N + r * N) + j4;
      float4 acc = k0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *o;
#pragma unroll 8
      for (int d = 0; d < kc; ++d) {
        const float xv = x[d];
        const float4 wv = w[d * ng];
        acc.x = fmaf(xv, wv.x, acc.x);
        acc.y = fmaf(xv, wv.y, acc.y);
        acc.z = fmaf(xv, wv.z, acc.z);
        acc.w = fmaf(xv, wv.w, acc.w);
      }
      if (last) {
        acc = make_float4(round_to<T>(acc.x), round_to<T>(acc.y),
                          round_to<T>(acc.z), round_to<T>(acc.w));
        if (bias != nullptr) {
          const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + j4);
          acc = make_float4(round_to<T>(acc.x + b.x), round_to<T>(acc.y + b.y),
                            round_to<T>(acc.z + b.z), round_to<T>(acc.w + b.w));
        }
        if (relu)
          acc = make_float4(fmaxf(acc.x, 0.f), fmaxf(acc.y, 0.f), fmaxf(acc.z, 0.f),
                            fmaxf(acc.w, 0.f));
      }
      *o = acc;
    }
  }
}

// out[l] = round_T(LN(pre[l]) * scale + bias), one warp per row, fp32
// statistics.  `out` may alias `pre`.
template <typename T>
__device__ void layer_norm_rows(const float* pre, const float* __restrict__ scale,
                                const float* __restrict__ bias, float* out, int L,
                                int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int l = warp; l < L; l += n_warps) {
    const float* x = pre + l * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += x[d];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = x[d] - mu;
      v = fmaf(c, c, v);
    }
    const float rstd = rsqrtf(warp_sum(v) / D + kEps);
    for (int d = lane; d < D; d += 32)
      out[l * D + d] = round_to<T>((x[d] - mu) * rstd * __ldg(scale + d) + __ldg(bias + d));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    user_encoder_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                            const float* __restrict__ params, T* __restrict__ out,
                            EncoderDims dims, float inv_sqrt_dk) {
  extern __shared__ __align__(16) float smem[];
  const int L = dims.L, D = dims.D, H = dims.H, F = dims.F;
  const int LD = L * D, dk = D / H;
  float* wbuf = smem;    // kWBuf staged weights, see linear()
  float* xs = wbuf + kWBuf;  // (L, D) block input / output, T-valued
  float* q = xs + LD;    // (L, D) queries; later the residual sums
  float* k = q + LD;     // (L, D)
  float* v = k + LD;     // (L, D)
  float* ctx = v + LD;   // (L, D) attention context
  float* hid = ctx + LD; // (L, F) FFN hidden
  float* sc = hid + L * F;  // (H, L, L) scores, then probabilities

  const size_t b = blockIdx.x;
  const T* xb = x + b * LD;
  const float* mb = mask + b * L * L;

  // Packed parameters, in the order of flatten_encoder_params.
  const float* pos = params;
  const float* ln0_s = pos + static_cast<size_t>(dims.n_position) * D;
  const float* ln0_b = ln0_s + D;
  const float* p = ln0_b + D;

  // x + pos in T arithmetic, then the input LayerNorm.
  for (int i = threadIdx.x; i < LD; i += blockDim.x)
    ctx[i] = round_to<T>(to_f32(xb[i]) + round_to<T>(__ldg(pos + i)));
  __syncthreads();
  layer_norm_rows<T>(ctx, ln0_s, ln0_b, xs, L, D);
  __syncthreads();

  for (int layer = 0; layer < dims.n_layers; ++layer) {
    const float* wq = p;
    const float* wk = wq + D * D;
    const float* wv = wk + D * D;
    const float* wo = wv + D * D;
    const float* ln1_s = wo + D * D;
    const float* ln1_b = ln1_s + D;
    const float* w1 = ln1_b + D;
    const float* b1 = w1 + D * F;
    const float* w2 = b1 + F;
    const float* b2 = w2 + F * D;
    const float* ln2_s = b2 + D;
    const float* ln2_b = ln2_s + D;
    p = ln2_b + D;

    // wq, wk, wv are consecutive in the packed vector, as q, k, v are in
    // shared memory: one call projects all three.
    linear<T>(xs, wq, nullptr, q, wbuf, 3, L, D, D, false);
    __syncthreads();

    for (int idx = threadIdx.x; idx < H * L * L; idx += blockDim.x) {
      const int h = idx / (L * L), r = idx - h * L * L;
      const int l = r / L, m = r - l * L;
      const float* qr = q + l * D + h * dk;
      const float* kr = k + m * D + h * dk;
      float acc = 0.f;
      // Start each key row at its own offset: neighbouring threads (other
      // keys m, rows D apart) then read distinct shared-memory banks.
      for (int i = 0; i < dk; ++i) {
        const int d = (i + m) % dk;
        acc = fmaf(qr[d], kr[d], acc);
      }
      sc[idx] = acc * inv_sqrt_dk + mb[r];
    }
    __syncthreads();

    for (int row = threadIdx.x; row < H * L; row += blockDim.x) {
      float* s = sc + row * L;
      float mx = s[0];
      for (int m = 1; m < L; ++m) mx = fmaxf(mx, s[m]);
      float sum = 0.f;
      for (int m = 0; m < L; ++m) {
        s[m] = expf(s[m] - mx);
        sum += s[m];
      }
      for (int m = 0; m < L; ++m) s[m] = round_to<T>(s[m] / sum);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < LD; idx += blockDim.x) {
      const int l = idx / D, c = idx - l * D, h = c / dk;
      const float* pr = sc + (h * L + l) * L;
      float acc = 0.f;
      for (int m = 0; m < L; ++m) acc = fmaf(pr[m], v[m * D + c], acc);
      ctx[idx] = round_to<T>(acc);
    }
    __syncthreads();

    linear<T>(ctx, wo, nullptr, q, wbuf, 1, L, D, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x) q[i] += xs[i];
    __syncthreads();
    layer_norm_rows<T>(q, ln1_s, ln1_b, xs, L, D);
    __syncthreads();

    linear<T>(xs, w1, b1, hid, wbuf, 1, L, D, F, true);
    __syncthreads();
    linear<T>(hid, w2, b2, q, wbuf, 1, L, F, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x) q[i] += xs[i];
    __syncthreads();
    layer_norm_rows<T>(q, ln2_s, ln2_b, xs, L, D);
    __syncthreads();
  }

  T* ob = out + b * LD;
  for (int i = threadIdx.x; i < LD; i += blockDim.x) ob[i] = from_f32<T>(xs[i]);
}

template <typename T>
cudaError_t launch(const void* x, const void* mask, const void* params, void* out,
                   int B, const EncoderDims& dims, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kWBuf + static_cast<size_t>(5) * dims.L * dims.D +
                       static_cast<size_t>(dims.L) * dims.F +
                       static_cast<size_t>(dims.H) * dims.L * dims.L);
  cudaError_t err = allow_smem(user_encoder_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(dims.D / dims.H)));
  user_encoder_fwd_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<T*>(out), dims, inv_sqrt_dk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// x (B, L, D) T; mask (B, L, L) fp32; params: the packed fp32 parameter
// vector; out (B, L, D) T.  T is bf16 when is_bf16, else fp32.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int iisan_user_encoder_fwd(const void* x, const void* mask, const void* params,
                                      void* out, int B, int L, int D, int H, int F,
                                      int n_layers, int n_position, int is_bf16,
                                      void* stream) {
  const iisan::EncoderDims dims{L, D, H, F, n_layers, n_position};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? iisan::launch<__nv_bfloat16>(x, mask, params, out, B, dims, s)
              : iisan::launch<float>(x, mask, params, out, B, dims, s);
  return static_cast<int>(err);
}
