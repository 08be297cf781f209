// Flash attention, forward, for Hopper (sm_90a) [K4].
//
// Replaces the TPU kernel _kernel and its wrapper flash_attention of
// repro/kernels/flash_attention/flash_attention.py.
//
// Contract (the TPU kernel's): for q (B, S, H, hd) and k, v (B, Sk, KV, hd)
// with H % KV == 0, query head h reads K/V head h / (H / KV) and
//   out[b, s, h, :] = sum_t softmax_t(q . k_t * hd^-1/2 + mask) v_t
// in q's dtype.  The causal mask keeps key t for query s when t <= s, both
// counted from 0 (the TPU kernel's assumption; the model calls it with
// Sk == S).  Numerics follow the TPU kernel: q is scaled in fp32 before the
// product, scores, running max and sum and the accumulator are fp32, a
// masked score is NEG_INF = -1e30 (not -inf), and the output is
// acc / max(l, 1e-30).
//
// Design.  The TPU kernel walks a sequential grid (B, H, S / block_q) and
// loops over K blocks with fori_loop, its accumulator in VMEM.  Here one
// CTA takes one (b, h, tile of BQ query rows); CTAs run in parallel and
// carry nothing between them, so the K loop is the CTA's own loop.  Inputs
// are read in place in their (B, S, H, hd) layout through the strides the
// wrapper passes: no transpose, and K/V are never replicated G times (the
// GQA fold is the index h / G).  Each K step stages a (BK, hd) tile of K
// and of V in shared memory as fp32; 256 threads form a 16 x 16 grid, a
// thread owning rows ty + 16 i (i < 4) of the query tile, score columns
// tx + 16 j and output columns tx + 16 j.  Row max and row sum reduce over
// the 16 threads of a row with warp shuffles (a row lies in one half-warp).
// The causal tile skip is the loop's upper bound, as on the TPU.  The
// ragged edges are masked, so S and Sk need not divide a tile: query rows
// past S are computed on zeros and not stored, keys past Sk score NEG_INF
// against zero V rows.
//
// Bound: operations.  A causal call does 4 B H hd (sum over s of the keys
// s may see) flops, about 8.2e11 at granite-20b's prefill shape (B=4,
// S=4096, H=48, hd=128), and moves only the bytes of q, k, v and out
// (~0.4 GB there), so the card's bound is its tensor-core rate.  This
// first kernel computes on the CUDA cores in scalar fp32 FMAs (each
// operand from shared memory, about two loads per FMA pair), so it runs
// far from that bound; wgmma, TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;           // query rows per CTA
constexpr int kThreads = 256;     // 16 x 16

template <int HD>
struct Tile {
  static constexpr int BK = HD <= 128 ? 64 : 32;    // keys per step
  static constexpr int QLD = HD + 1;                // padded row strides:
  static constexpr int KLD = HD + 1;                // rows read by the two
  static constexpr int VLD = HD;                    // halves of a warp fall
  static constexpr int PLD = BK + 1;                // in different banks
  static constexpr size_t smem_floats =
      (size_t)kBQ * QLD + (size_t)BK * KLD + (size_t)BK * VLD +
      (size_t)kBQ * PLD;
};

struct Strides {                  // elements; the head dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);     // round to nearest even, as torch casts
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int S, int Sk, int G,
          int causal, float scale, Strides st) {
  using TL = Tile<HD>;
  constexpr int BK = TL::BK;
  constexpr int NI = kBQ / 16;    // query rows per thread
  constexpr int NC = BK / 16;     // score columns per thread
  constexpr int NJ = HD / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // kBQ x QLD, pre-scaled
  float* Ks = Qs + kBQ * TL::QLD;          // BK x KLD
  float* Vs = Ks + BK * TL::KLD;           // BK x VLD
  float* Ps = Vs + BK * TL::VLD;           // kBQ x PLD, probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    Qs[r * TL::QLD + d] = s < S ? to_f32(qp[s * st.qs + d]) * scale : 0.f;
  }

  float acc[NI][NJ], m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {                   // tiles above the diagonal: never loaded
    const int q_last = min(q0 + kBQ, S) - 1;
    n_tiles = min(n_tiles, q_last / BK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();              // the last step's readers are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, s = k0 + r;
      const bool in = s < Sk;
      Ks[r * TL::KLD + d] = in ? to_f32(kp[s * st.ks + d]) : 0.f;
      Vs[r * TL::VLD + d] = in ? to_f32(vp[s * st.vs + d]) : 0.f;
    }
    __syncthreads();

    float sc[NI][NC];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[NI], kk[NC];
#pragma unroll
      for (int i = 0; i < NI; ++i) a[i] = Qs[(ty + 16 * i) * TL::QLD + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) kk[j] = Ks[(tx + 16 * j) * TL::KLD + d];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

    // mask, then the online-softmax recurrence of the TPU kernel
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Sk || (causal && kpos > qpos)) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[r * TL::PLD + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[NI], vv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) p[i] = Ps[(ty + 16 * i) * TL::PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * TL::VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[s * st.os + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Sk, int H, int KV, int causal,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = Tile<HD>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Sk, H / KV, causal,
      (float)(1.0 / sqrt((double)HD)), st);   // float32(hd ** -0.5)
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int S, int Sk, int H, int KV,
                        int causal, const Strides& st, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Sk, H, KV, causal, st, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Sk, H, KV, causal, st, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Sk, H, KV, causal, st, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Sk, H, KV, causal, st, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Sk, H, KV, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// sequence, head) of q, k, v and out in that order.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an unsupported dtype or hd).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int S, int Sk, int H, int KV, int hd, int causal,
    const long long* strides, void* stream) {
  Strides st;
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, out, B, S, Sk, H, KV, causal,
                                   st, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, Sk, H, KV,
                                           causal, st, s);
  return (int)cudaErrorInvalidValue;
}
