// Fused SASRec user-encoder backward, fp32 route, on the CUDA cores:
// recompute the forward, then back-propagate through the whole encoder in
// one launch.  (The bf16 route, the main path, is user_encoder_bwd_tc.cu;
// the wrapper chooses by the compute type.)
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (with `_attn_bwd` and
// `_layernorm_bwd`) in iisan_tpu/ops/fused_user_encoder.py.  Like it, the
// only residuals are (x, mask, seed): a block reruns the forward of its
// sequence with user_encoder.cuh's code, so every value, and every Philox
// dropout bit, is the forward kernel's own, and keeps what the backward
// needs in shared memory, one slot per layer.  It then runs the backward
// sweep of `_bwd_kernel` with the same cast chain: the upstream gradient is
// T-valued; the weight-gradient and input-gradient products take
// T-rounded operands with fp32 accumulation and fp32 results; bias,
// LayerNorm and softmax gradients are fp32.  It writes gx in T and the
// parameter gradients in fp32, in the packed order.
//
// The TPU kernel sums the parameter gradients across its grid in place,
// relying on the grid's sequential order.  CUDA blocks run concurrently,
// so each block (one sequence) writes its whole gradient vector to row b
// of an fp32 (B, P) scratch, and a second kernel, grad_reduce, sums the
// rows in a fixed order: the result is deterministic, run to run.
//
// What bounds it on the H100: the latency of a chain of small products on
// one SM per sequence (one block has the stash of its sequence, the
// staged-weight buffer and the gradient working set, 161 KB at L=10, D=64,
// F=256, H=2, 2 blocks, so one block per SM).  The weight gradients are
// each a sum over the L rows of the sequence, written straight to the
// scratch row; the input gradients read each weight matrix through a
// column-chunked, bank-padded copy in shared memory (linear_t).
//
// The stash grows with depth and with L^2, so where it does not fit beside
// the rest, the per-layer slots go to a per-sequence scratch in global
// memory and shared memory keeps one layer's working set, as in the
// forward; where even that does not fit (L = 50 at D = 64 and 128),
// everything but the staged weights goes there (user_encoder.cuh's
// Placement).  The arithmetic and its order do not change, so results stay
// bit-repeatable.

#include "user_encoder.cuh"

namespace iisan {
namespace {

// The backward's working set (EncoderAreas' extra area), in floats.
struct BwdLayout {
  int g, ga, gb, gq, ghid, gsc, total;
  __host__ __device__ explicit BwdLayout(const EncoderLayout& lay) {
    g = 0;                    // the running gradient (L, D)
    ga = g + lay.LD;          // (L, D) scratch
    gb = ga + lay.LD;         // (L, D) scratch
    gq = gb + lay.LD;         // (L, D) x 3: gq, gk, gv
    ghid = gq + 3 * lay.LD;   // (L, F)
    gsc = ghid + lay.LF;      // (H, L, L)
    total = gsc + pad4(lay.HLL);
  }
};

// Weight gradients: out_m[k, j] = sum_l A[l, k] * G_m[l, j] for the n_mat
// matrices G_m = G + m*L*N (shared), out_m = out + m*K*N (global).
__device__ void grad_weight(const float* A, const float* G, float* __restrict__ out,
                            int n_mat, int L, int K, int N) {
  const int per = K * N;
  for (int idx = threadIdx.x; idx < n_mat * per; idx += blockDim.x) {
    const int m = idx / per, r = idx - m * per;
    const int k = r / N, j = r - k * N;
    const float* g = G + m * L * N + j;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(A[l * K + k], g[l * N], acc);
    out[idx] = acc;
  }
}

template <typename T>
__device__ void round_all(float* a, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = round_to<T>(a[i]);
}

// Input gradients: out[l, k] = sum_m sum_n G_m[l, n] * W_m[k, n]
// (+ addend[l, k]), the product with W transposed.  W_m = W + m*K*N are
// (K, N) matrices in global memory, already T-valued; G_m = G + m*L*N in
// shared memory.  The weights are staged in shared memory in chunks of nc
// columns with an odd row stride, so that neighbouring threads, which
// take neighbouring k, read distinct banks; where n_mat*K rows of at least
// two columns do not fit the buffer, the outputs k go in panels that do.
// Results are fp32.
__device__ void linear_t(const float* G, const float* __restrict__ W, const float* addend,
                         float* out, float* wbuf, int n_mat, int L, int K, int N) {
  const int kp_max = max(1, min(K, kWBuf / (n_mat * 4)));
  for (int kb = 0; kb < K; kb += kp_max) {
    const int kp = min(kp_max, K - kb);
    const int nc_max = max(1, min(N, kWBuf / (n_mat * kp) - 2));
    for (int n0 = 0; n0 < N; n0 += nc_max) {
      const int nc = min(nc_max, N - n0), ld = nc + 1 + (nc & 1);
      __syncthreads();  // the previous contents of wbuf are used
      for (int idx = threadIdx.x; idx < n_mat * kp * nc; idx += blockDim.x) {
        const int row = idx / nc, n = idx - row * nc;  // row = m*kp + k
        const int m = row / kp, k = row - m * kp;
        wbuf[row * ld + n] =
            __ldg(W + (static_cast<size_t>(m) * K + kb + k) * N + n0 + n);
      }
      __syncthreads();
      const bool last = n0 + nc == N;
      for (int idx = threadIdx.x; idx < L * kp; idx += blockDim.x) {
        const int l = idx / kp, k = idx - l * kp;
        float* o = out + l * K + kb + k;
        float acc = n0 == 0 ? 0.f : *o;
        for (int m = 0; m < n_mat; ++m) {
          const float* g = G + m * L * N + l * N + n0;
          const float* w = wbuf + (m * kp + k) * ld;
          for (int n = 0; n < nc; ++n) acc = fmaf(g[n], w[n], acc);
        }
        if (last && addend != nullptr) acc += addend[l * K + kb + k];
        *o = acc;
      }
    }
  }
}

template <typename T, int kPlace>
__global__ void __launch_bounds__(kThreads)
    user_encoder_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                            const float* __restrict__ params, const T* __restrict__ gout,
                            T* __restrict__ gx, float* __restrict__ part,
                            float* __restrict__ scratch, long long per_seq, EncoderDims dims,
                            float inv_sqrt_dk, Dropout drop, int P) {
  extern __shared__ __align__(16) float smem[];
  const EncoderLayout lay(dims);
  const BwdLayout bl(lay);
  const int L = dims.L, D = dims.D, H = dims.H, F = dims.F;
  const int LD = L * D, dk = D / H;
  const size_t b = blockIdx.x;
  const unsigned bu = static_cast<unsigned>(b);
  const EncoderAreas ar(static_cast<Placement>(kPlace), lay, dims.n_layers, smem, scratch, b,
                        per_seq);
  float* wbuf = ar.wbuf;
  float* sc = ar.head + lay.sc;
  float* g = ar.extra + bl.g;
  float* ga = ar.extra + bl.ga;
  float* gb = ar.extra + bl.gb;
  float* gq = ar.extra + bl.gq;
  float* gk = gq + LD;
  float* gv = gk + LD;
  float* ghid = ar.extra + bl.ghid;
  float* gsc = ar.extra + bl.gsc;

  // Forward recompute: layer i leaves its values in slot i (the output
  // itself is not needed; it lands in ga).
  encoder_forward<T>(x + b * LD, mask + b * L * L, params, dims, lay, inv_sqrt_dk, drop, bu,
                     ar, lay.slot, ga);
  for (int i = threadIdx.x; i < LD; i += blockDim.x) g[i] = to_f32(gout[b * LD + i]);
  __syncthreads();

  // This sequence's gradient row has the packed parameters' layout.
  float* pb = part + b * static_cast<size_t>(P);
  auto grad_of = [&](const float* prm) { return pb + (prm - params); };
  const float* ln0_s = params + static_cast<size_t>(dims.n_position) * D;
  const float* ln0_b = ln0_s + D;
  const int bsize = BlockParams::size(D, F);

  for (int layer = dims.n_layers - 1; layer >= 0; --layer) {
    const BlockParams w(ln0_b + D + layer * bsize, D, F);
    const float* s = ar.slots + static_cast<size_t>(layer) * lay.slot;
    const float* q = s + lay.q;
    const float* k = s + lay.k;
    const float* v = s + lay.v;
    const float* praw = s + lay.p;
    const float* hid = s + lay.hid;

    // x_out = LN2(x1 + dropout(hid @ w2 + b2))
    layer_norm_bwd(g, s + lay.xhat2, s + lay.rstd2, w.ln2_s, ga, grad_of(w.ln2_s),
                   grad_of(w.ln2_b), L, D);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x)
      gb[i] = drop.on ? ga[i] * drop.keep(site_ffn_out(layer, H), bu, i) : ga[i];
    __syncthreads();
    col_sum(gb, grad_of(w.b2), L, D);
    __syncthreads();
    round_all<T>(gb, LD);
    __syncthreads();
    grad_weight(hid, gb, grad_of(w.w2), 1, L, F, D);
    linear_t(gb, w.w2, nullptr, ghid, wbuf, 1, L, F, D);
    __syncthreads();
    for (int i = threadIdx.x; i < L * F; i += blockDim.x)
      if (!(hid[i] > 0.f)) ghid[i] = 0.f;
    __syncthreads();
    col_sum(ghid, grad_of(w.b1), L, F);
    __syncthreads();
    round_all<T>(ghid, L * F);
    __syncthreads();
    grad_weight(s + lay.x1, ghid, grad_of(w.w1), 1, L, D, F);
    linear_t(ghid, w.w1, ga, gb, wbuf, 1, L, D, F);  // gb: grad of x1
    __syncthreads();

    // x1 = LN1(x_in + dropout(ctx @ wo))
    layer_norm_bwd(gb, s + lay.xhat1, s + lay.rstd1, w.ln1_s, ga, grad_of(w.ln1_s),
                   grad_of(w.ln1_b), L, D);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x)
      gb[i] = round_to<T>(drop.on ? ga[i] * drop.keep(site_attn_out(layer, H), bu, i) : ga[i]);
    __syncthreads();
    grad_weight(s + lay.ctx, gb, grad_of(w.wo), 1, L, D, D);
    linear_t(gb, w.wo, nullptr, g, wbuf, 1, L, D, D);  // g: grad of the context, fp32
    __syncthreads();

    // Attention (`_attn_bwd`), all heads at once.  gsc = dL/dp through the
    // dropout; sc = the probabilities PV used (rounded, dropped out).
    for (int idx = threadIdx.x; idx < H * L * L; idx += blockDim.x) {
      const int h = idx / (L * L), r = idx - h * L * L;
      const int l = r / L, m = r - l * L;
      const float* gr = g + l * D + h * dk;
      const float* vr = v + m * D + h * dk;
      float acc = 0.f;
      for (int c = 0; c < dk; ++c) acc = fmaf(gr[c], vr[c], acc);
      const float pr = round_to<T>(praw[idx]);
      if (drop.on) {
        const float kp = drop.keep(site_probs(layer, h, H), bu, r);
        gsc[idx] = acc * kp;
        sc[idx] = pr * kp;
      } else {
        gsc[idx] = acc;
        sc[idx] = pr;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < LD; idx += blockDim.x) {
      const int m = idx / D, c = idx - m * D, h = c / dk;
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc = fmaf(sc[(h * L + l) * L + m], g[l * D + c], acc);
      gv[idx] = acc;
    }
    for (int row = threadIdx.x; row < H * L; row += blockDim.x) {
      float* gr = gsc + row * L;
      const float* pr = praw + row * L;
      float dot = 0.f;
      for (int m = 0; m < L; ++m) dot = fmaf(gr[m], pr[m], dot);
      for (int m = 0; m < L; ++m) gr[m] = pr[m] * (gr[m] - dot) * inv_sqrt_dk;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < LD; idx += blockDim.x) {
      const int r = idx / D, c = idx - r * D, h = c / dk;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < L; ++j) {
        aq = fmaf(gsc[(h * L + r) * L + j], k[j * D + c], aq);  // sum_m gs[r, m] k[m]
        ak = fmaf(gsc[(h * L + j) * L + r], q[j * D + c], ak);  // sum_l gs[l, r] q[l]
      }
      gq[idx] = round_to<T>(aq);
      gk[idx] = round_to<T>(ak);
      gv[idx] = round_to<T>(gv[idx]);
    }
    __syncthreads();
    // wq, wk, wv and their gradients are consecutive, as gq, gk, gv are.
    grad_weight(s, gq, grad_of(w.wq), 3, L, D, D);
    linear_t(gq, w.wq, ga, g, wbuf, 3, L, D, D);  // g = grad of x_in
    __syncthreads();
  }

  // Input dropout, input LayerNorm, positional rows.
  if (drop.on) {
    for (int i = threadIdx.x; i < LD; i += blockDim.x) g[i] *= drop.keep(0u, bu, i);
    __syncthreads();
  }
  layer_norm_bwd(g, ar.head + lay.xhat0, ar.head + lay.rstd0, ln0_s, ga, grad_of(ln0_s),
                 grad_of(ln0_b), L, D);
  __syncthreads();
  T* gxb = gx + b * LD;
  for (int i = threadIdx.x; i < LD; i += blockDim.x) {
    pb[i] = ga[i];
    gxb[i] = from_f32<T>(ga[i]);
  }
  for (int i = LD + threadIdx.x; i < dims.n_position * D; i += blockDim.x) pb[i] = 0.f;
}

// out[j] = sum_b part[b, j], b in order: deterministic.
__global__ void grad_reduce(const float* __restrict__ part, float* __restrict__ out, int B,
                            int P) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * P + j];
  out[j] = acc;
}

template <typename T, int kPlace>
cudaError_t launch_at(const void* x, const void* mask, const void* params, const void* gout,
                      void* gx, float* part, float* scratch, int B, const EncoderDims& dims,
                      const Dropout& drop, int P, cudaStream_t stream) {
  const EncoderLayout lay(dims);
  const int extra = BwdLayout(lay).total;
  const Placement pl = static_cast<Placement>(kPlace);
  const size_t smem = sizeof(float) * smem_floats(lay, pl, dims.n_layers, extra);
  const long long per_seq = scratch_floats(lay, pl, dims.n_layers, extra);
  if (per_seq > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(user_encoder_bwd_kernel<T, kPlace>, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(dims.D / dims.H)));
  user_encoder_bwd_kernel<T, kPlace><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(params), static_cast<const T*>(gout), static_cast<T*>(gx),
      part, scratch, per_seq, dims, inv_sqrt_dk, drop, P);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* mask, const void* params, const void* gout,
                   void* gx, float* part, float* scratch, long long scratch_bytes,
                   float* gparams, int B, const EncoderDims& dims, const Dropout& drop, int P,
                   cudaStream_t stream) {
  const EncoderLayout lay(dims);
  const int extra = BwdLayout(lay).total;
  const Placement pl = place(lay, dims.n_layers, extra);
  if (scratch_bytes < static_cast<long long>(B) * scratch_floats(lay, pl, dims.n_layers, extra) * 4)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (pl) {
    case kResident:
      err = launch_at<float, kResident>(x, mask, params, gout, gx, part, scratch, B, dims, drop,
                                        P, stream);
      break;
    case kSlotsGlobal:
      err = launch_at<float, kSlotsGlobal>(x, mask, params, gout, gx, part, scratch, B, dims,
                                           drop, P, stream);
      break;
    default:
      err = launch_at<float, kSpilled>(x, mask, params, gout, gx, part, scratch, B, dims, drop,
                                       P, stream);
  }
  if (err != cudaSuccess) return err;
  grad_reduce<<<(P + 255) / 256, 256, 0, stream>>>(part, gparams, B, P);
  return cudaGetLastError();
}

}  // namespace
}  // namespace iisan

// x (B, L, D) fp32; mask (B, L, L) fp32; params: the packed fp32 parameter
// vector (P floats); gout (B, L, D) fp32, the gradient of the output.
// Writes gx (B, L, D) fp32 and gparams (P) fp32, using part (B, P) fp32
// and scratch (scratch_bytes, checked: B times the per-sequence scratch,
// or null where the stash fits shared memory).  Dropout as
// iisan_user_encoder_fwd.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int iisan_user_encoder_bwd(const void* x, const void* mask, const void* params,
                                      const void* gout, void* gx, void* part, void* scratch,
                                      long long scratch_bytes, void* gparams, int B, int L, int D,
                                      int H, int F, int n_layers, int n_position, int seed,
                                      float rate, float scale, int P, void* stream) {
  const iisan::EncoderDims dims{L, D, H, F, n_layers, n_position};
  const iisan::Dropout drop = iisan::make_dropout(seed, rate, scale);
  const cudaError_t err = iisan::launch(
      x, mask, params, gout, gx, static_cast<float*>(part), static_cast<float*>(scratch),
      scratch_bytes, static_cast<float*>(gparams), B, dims, drop, P,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
