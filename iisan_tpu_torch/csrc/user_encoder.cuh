// The fused SASRec user encoder's forward body on the CUDA cores, the fp32
// route: shared by the forward kernel (user_encoder_fwd.cu) and the
// backward kernel's recompute (user_encoder_bwd.cu), so the two compute the
// same values by the same code.  (The bf16 route runs on the tensor cores,
// user_encoder_tc.cuh; the definitions below that both routes use are the
// dimensions, the dropout sites and the packed parameter order.)
// The function: positional add, input LayerNorm (+ dropout), then per block
// bias-free Q/K/V/O attention with an fp32 softmax over the additive mask
// (+ dropout of the probabilities and of the projected output), post-LN,
// ReLU FFN (+ dropout of its output), post-LN.
//
// Cast chain (that of `_encoder_fwd_body` and `_attn_fwd` in
// iisan_tpu/ops/fused_user_encoder.py): products take T-rounded operands
// with fp32 accumulation and are rounded to T; the FFN bias adds in T; the
// scores are fp32 products of T-valued q and k; the softmax is fp32 and
// its probabilities are rounded to T, then multiplied by the dropout keep
// factor in fp32 before PV; the dropout of the attention output and of the
// FFN output multiplies in fp32 and rounds to T; LayerNorm statistics are
// fp32.  The mask is additive 0 / -1e9, so a query row whose keys are all
// masked gets the uniform softmax, never NaN.  Dropout bits come from
// Philox (philox.cuh), addressed by (seed, sequence, site, element).
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"
#include "philox.cuh"

namespace iisan {

constexpr int kThreads = 256;
constexpr float kEps = 1e-6f;
constexpr int kWBuf = 16384;  // floats of shared memory for staged weights

struct EncoderDims {
  int L, D, H, F, n_layers, n_position;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Working layout, in floats, in three areas: the staged-weight buffer
// (kWBuf floats, always in shared memory), the "head" (the pre-LayerNorm
// sums, the scores and the input LayerNorm's stats), and the layer slots.
// One layer's slot holds what its forward leaves behind: the forward kernel
// reuses one slot for every layer; the backward kernel gives each layer its
// own, and the slots are its stash.  Where D and F are multiples of 4, so
// is every offset, and linear() stores float4s (else linear_scalar()).
//
// Where the areas fit one block's shared memory they all live there
// (kResident).  Otherwise the slots move to a per-sequence scratch in
// global memory that the wrapper allocates (kSlotsGlobal), and where the
// head does not fit beside the weight buffer either, it moves there too
// (kSpilled).  The code is the same; only the base pointers differ, and a
// sequence's scratch (tens to hundreds of KB) stays in the 50 MB L2.
enum Placement { kResident = 0, kSlotsGlobal = 1, kSpilled = 2 };
constexpr int kSmemFloats = 232448 / 4;  // shared memory a block may use

struct EncoderLayout {
  int LD, LF, HLL;
  // offsets inside a slot
  int q, k, v, ctx, xhat1, x1, xhat2, hid, p, rstd1, rstd2, slot;
  // offsets inside the head
  int res, sc, xhat0, rstd0, head;
  __host__ __device__ explicit EncoderLayout(const EncoderDims& d)
      : LD(d.L * d.D), LF(d.L * d.F), HLL(d.H * d.L * d.L) {
    // slot: x_in at 0, then q k v (consecutive: one linear() call
    // projects all three), ctx, the LayerNorm stats and outputs, the FFN
    // hidden, the raw probabilities, the two rstd vectors
    q = LD;
    k = 2 * LD;
    v = 3 * LD;
    ctx = 4 * LD;
    xhat1 = 5 * LD;
    x1 = 6 * LD;
    xhat2 = 7 * LD;
    hid = 8 * LD;
    p = hid + LF;
    rstd1 = p + HLL;
    rstd2 = rstd1 + d.L;
    slot = pad4(rstd2 + d.L);
    res = 0;
    sc = res + LD;
    xhat0 = sc + pad4(HLL);
    rstd0 = xhat0 + LD;
    head = rstd0 + pad4(d.L);
  }
};

// Where the areas go, given the slots (n_slots of them) and any further
// shared area (`extra` floats: the backward's working set) the kernel needs.
__host__ __device__ inline Placement place(const EncoderLayout& lay, int n_slots, int extra) {
  if (kWBuf + lay.head + static_cast<long long>(n_slots) * lay.slot + extra <= kSmemFloats)
    return kResident;
  if (kWBuf + lay.head + extra <= kSmemFloats) return kSlotsGlobal;
  return kSpilled;
}

// Floats of shared memory and of per-sequence global scratch at a placement
// (the extra area follows the head in shared memory, the slots in scratch).
__host__ __device__ inline long long smem_floats(const EncoderLayout& lay, Placement pl,
                                                 int n_slots, int extra) {
  if (pl == kResident) return kWBuf + lay.head + static_cast<long long>(n_slots) * lay.slot + extra;
  if (pl == kSlotsGlobal) return kWBuf + lay.head + extra;
  return kWBuf;
}
__host__ __device__ inline long long scratch_floats(const EncoderLayout& lay, Placement pl,
                                                    int n_slots, int extra) {
  if (pl == kResident) return 0;
  if (pl == kSlotsGlobal) return static_cast<long long>(n_slots) * lay.slot;
  return lay.head + static_cast<long long>(n_slots) * lay.slot + extra;
}

// The three areas' bases for sequence b: smem is the block's shared memory,
// scratch the per-sequence global scratch (scratch_floats each).
struct EncoderAreas {
  float *wbuf, *head, *slots, *extra;
  __device__ EncoderAreas(Placement pl, const EncoderLayout& lay, int n_slots, float* smem,
                          float* scratch, size_t b, long long per_seq) {
    float* gs = scratch + b * static_cast<size_t>(per_seq);
    wbuf = smem;
    if (pl == kResident) {
      head = smem + kWBuf;
      slots = head + lay.head;
      extra = slots + static_cast<size_t>(n_slots) * lay.slot;
    } else if (pl == kSlotsGlobal) {
      head = smem + kWBuf;
      extra = head + lay.head;
      slots = gs;
    } else {
      head = gs;
      slots = gs + lay.head;
      extra = slots + static_cast<size_t>(n_slots) * lay.slot;
    }
  }
};

// Dropout site numbers of one sequence (ops/philox.encoder_sites).
__device__ __forceinline__ unsigned site_probs(int layer, int h, int H) {
  return 1u + layer * (H + 2) + h;
}
__device__ __forceinline__ unsigned site_attn_out(int layer, int H) {
  return 1u + layer * (H + 2) + H;
}
__device__ __forceinline__ unsigned site_ffn_out(int layer, int H) {
  return 2u + layer * (H + 2) + H;
}

// Packed parameters of one block, in the order of flatten_encoder_params.
struct BlockParams {
  const float *wq, *wk, *wv, *wo, *ln1_s, *ln1_b, *w1, *b1, *w2, *b2, *ln2_s, *ln2_b;
  __device__ BlockParams(const float* p, int D, int F)
      : wq(p), wk(wq + D * D), wv(wk + D * D), wo(wv + D * D), ln1_s(wo + D * D),
        ln1_b(ln1_s + D), w1(ln1_b + D), b1(w1 + D * F), w2(b1 + F), b2(w2 + F * D),
        ln2_s(b2 + D), ln2_b(ln2_s + D) {}
  __device__ static int size(int D, int F) { return 4 * D * D + 2 * D * F + F + 5 * D; }
};

// For each of n_mat matrices W_m = W + m*K*N (outputs at out + m*L*N):
// out_m[l, j] = round_T(sum_d in[l, d] * W_m[d, j]), then, with a bias,
// round_T(out + bias[j]) and optionally ReLU.  W and bias hold values
// already rounded to T (this is the fp32 route, where rounding is the
// identity).
//
// Every row of the output reads every weight, so the weights are staged in
// shared memory (`wbuf`, kWBuf floats) first, as many rows of all n_mat
// matrices as fit (at the serving geometry, whole matrices): the block
// reads each weight from L2 once, all threads copying at once.  Then
// a thread computes four adjacent columns of one row: per step one
// broadcast load of x and one 16-byte load of W feed four independent FMA
// chains.  With K in several chunks, the fp32 partial sums wait in `out`;
// a thread owns the same outputs in every chunk, so they need no barrier.
//
// Where N is not a multiple of 4, or W or out is not 16-byte aligned (D or
// F not a multiple of 4 puts the packed matrices and the layout's areas off
// that grid), or n_mat rows of W do not fit the buffer, linear_scalar()
// does the same work a column a thread, in panels of columns that fit.
template <typename T>
__device__ void linear_scalar(const float* in, const float* __restrict__ W,
                              const float* __restrict__ bias, float* out, float* wbuf,
                              int n_mat, int L, int K, int N, bool relu) {
  const int np_max = max(1, min(N, kWBuf / n_mat));
  for (int n0 = 0; n0 < N; n0 += np_max) {
    const int np = min(np_max, N - n0);
    const int kc_max = max(1, min(K, kWBuf / (n_mat * np)));
    for (int k0 = 0; k0 < K; k0 += kc_max) {
      const int kc = min(kc_max, K - k0);
      const int chunk = kc * np;
      __syncthreads();  // the previous contents of wbuf are used
      for (int idx = threadIdx.x; idx < n_mat * chunk; idx += blockDim.x) {
        const int m = idx / chunk, e = idx - m * chunk;
        const int d = e / np, j = e - d * np;
        wbuf[idx] = __ldg(W + static_cast<size_t>(m) * K * N +
                          static_cast<size_t>(k0 + d) * N + n0 + j);
      }
      __syncthreads();
      const bool last = k0 + kc == K;
      for (int idx = threadIdx.x; idx < n_mat * L * np; idx += blockDim.x) {
        const int m = idx / (L * np), rem = idx - m * L * np;
        const int r = rem / np, j = rem - r * np;
        const float* x = in + r * K + k0;
        const float* w = wbuf + m * chunk + j;
        float* o = out + m * L * N + r * N + n0 + j;
        float acc = k0 == 0 ? 0.f : *o;
        for (int d = 0; d < kc; ++d) acc = fmaf(x[d], w[d * np], acc);
        if (last) {
          acc = round_to<T>(acc);
          if (bias != nullptr) acc = round_to<T>(acc + __ldg(bias + n0 + j));
          if (relu) acc = fmaxf(acc, 0.f);
        }
        *o = acc;
      }
    }
  }
}

template <typename T>
__device__ void linear(const float* in, const float* __restrict__ W,
                       const float* __restrict__ bias, float* out, float* wbuf,
                       int n_mat, int L, int K, int N, bool relu) {
  if (N % 4 != 0 || n_mat * N > kWBuf || reinterpret_cast<size_t>(W) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 16 != 0 ||
      (bias != nullptr && reinterpret_cast<size_t>(bias) % 16 != 0)) {
    linear_scalar<T>(in, W, bias, out, wbuf, n_mat, L, K, N, relu);
    return;
  }
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

// out[l] = round_T(xhat[l] * scale + bias) with xhat = (pre[l] - mean) *
// rstd, one warp per row, fp32 statistics; xhat and rstd are kept for the
// backward.  `out` must not alias `pre`.
template <typename T>
__device__ void layer_norm_rows(const float* pre, const float* __restrict__ scale,
                                const float* __restrict__ bias, float* out, float* xhat,
                                float* rstd_out, int L, int D) {
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
    if (lane == 0) rstd_out[l] = rstd;
    for (int d = lane; d < D; d += 32) {
      const float xh = (x[d] - mu) * rstd;
      xhat[l * D + d] = xh;
      out[l * D + d] = round_to<T>(xh * __ldg(scale + d) + __ldg(bias + d));
    }
  }
}

// out[j] = sum_l G[l, j] (a bias gradient), G (L, N) in shared or device memory.
__device__ inline void col_sum(const float* G, float* __restrict__ out, int L, int N) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc += G[l * N + j];
    out[j] = acc;
  }
}

// LayerNorm backward (`_layernorm_bwd`): gx = rstd * (gy*s - mean(gy*s) -
// xhat * mean(gy*s*xhat)) per row; the scale and bias gradients, column
// sums of gy*xhat and gy, go to gscale / gbias (global).
__device__ inline void layer_norm_bwd(const float* gy, const float* xhat, const float* rstd,
                                      const float* scale, float* gx, float* __restrict__ gscale,
                                      float* __restrict__ gbias, int L, int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f, t = 0.f;
    for (int l = 0; l < L; ++l) {
      const float v = gy[l * D + d];
      s = fmaf(v, xhat[l * D + d], s);
      t += v;
    }
    gscale[d] = s;
    gbias[d] = t;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int l = warp; l < L; l += n_warps) {
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float gh = gy[l * D + d] * scale[d];
      s1 += gh;
      s2 = fmaf(gh, xhat[l * D + d], s2);
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int d = lane; d < D; d += 32) {
      const float gh = gy[l * D + d] * scale[d];
      gx[l * D + d] = rstd[l] * (gh - m1 - xhat[l * D + d] * m2);
    }
  }
}

// The whole encoder forward of sequence b (xb, mb: its input and mask) in
// the areas `ar`, laid out as EncoderLayout.  Layer i works in the slot at
// `ar.slots + i * slot_stride` (stride 0: one slot for all layers); the last
// layer's output lands in `out`.  Ends with a barrier.
template <typename T>
__device__ void encoder_forward(const T* __restrict__ xb, const float* __restrict__ mb,
                                const float* __restrict__ params, const EncoderDims& dims,
                                const EncoderLayout& lay, float inv_sqrt_dk,
                                const Dropout& drop, unsigned b, const EncoderAreas& ar,
                                int slot_stride, float* out) {
  const int L = dims.L, D = dims.D, H = dims.H, F = dims.F;
  const int LD = L * D, dk = D / H;
  float* wbuf = ar.wbuf;
  float* res = ar.head + lay.res;  // (L, D) pre-LayerNorm sums
  float* sc = ar.head + lay.sc;    // (H, L, L) scores, then probabilities used by PV

  const float* pos = params;
  const float* ln0_s = pos + static_cast<size_t>(dims.n_position) * D;
  const float* ln0_b = ln0_s + D;
  const float* p = ln0_b + D;

  // x + pos in T arithmetic, then the input LayerNorm (and its dropout).
  for (int i = threadIdx.x; i < LD; i += blockDim.x)
    res[i] = round_to<T>(to_f32(xb[i]) + round_to<T>(__ldg(pos + i)));
  __syncthreads();
  float* x_in = ar.slots;
  layer_norm_rows<T>(res, ln0_s, ln0_b, x_in, ar.head + lay.xhat0, ar.head + lay.rstd0, L, D);
  __syncthreads();
  if (drop.on) {
    for (int i = threadIdx.x; i < LD; i += blockDim.x)
      x_in[i] = round_to<T>(x_in[i] * drop.keep(0u, b, i));
    __syncthreads();
  }

  for (int layer = 0; layer < dims.n_layers; ++layer) {
    const BlockParams w(p, D, F);
    p += BlockParams::size(D, F);
    float* s = ar.slots + static_cast<size_t>(layer) * slot_stride;
    float* q = s + lay.q;
    float* k = s + lay.k;
    float* v = s + lay.v;
    float* ctx = s + lay.ctx;
    float* praw = s + lay.p;
    float* x1 = s + lay.x1;
    float* hid = s + lay.hid;
    float* next = layer + 1 < dims.n_layers ? s + slot_stride : out;

    // wq, wk, wv are consecutive in the packed vector, as q, k, v are in
    // shared memory: one call projects all three.
    linear<T>(s, w.wq, nullptr, q, wbuf, 3, L, D, D, false);
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
      float* sr = sc + row * L;
      float mx = sr[0];
      for (int m = 1; m < L; ++m) mx = fmaxf(mx, sr[m]);
      float sum = 0.f;
      for (int m = 0; m < L; ++m) {
        sr[m] = expf(sr[m] - mx);
        sum += sr[m];
      }
      const int h = row / L, l = row - h * L;
      for (int m = 0; m < L; ++m) {
        const float pr = sr[m] / sum;
        praw[row * L + m] = pr;
        sr[m] = drop.on ? round_to<T>(pr) * drop.keep(site_probs(layer, h, H), b, l * L + m)
                        : round_to<T>(pr);
      }
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

    linear<T>(ctx, w.wo, nullptr, res, wbuf, 1, L, D, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x) {
      float o = res[i];
      if (drop.on) o = round_to<T>(o * drop.keep(site_attn_out(layer, H), b, i));
      res[i] = o + s[i];
    }
    __syncthreads();
    layer_norm_rows<T>(res, w.ln1_s, w.ln1_b, x1, s + lay.xhat1, s + lay.rstd1, L, D);
    __syncthreads();

    linear<T>(x1, w.w1, w.b1, hid, wbuf, 1, L, D, F, true);
    __syncthreads();
    linear<T>(hid, w.w2, w.b2, res, wbuf, 1, L, F, D, false);
    __syncthreads();
    for (int i = threadIdx.x; i < LD; i += blockDim.x) {
      float h2 = res[i];
      if (drop.on) h2 = round_to<T>(h2 * drop.keep(site_ffn_out(layer, H), b, i));
      res[i] = h2 + x1[i];
    }
    __syncthreads();
    layer_norm_rows<T>(res, w.ln2_s, w.ln2_b, next, s + lay.xhat2, s + lay.rstd2, L, D);
    __syncthreads();
  }
}

}  // namespace iisan
