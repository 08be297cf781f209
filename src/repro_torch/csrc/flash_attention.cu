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
// Sk == S).  Scores, the running max and sum and the accumulator are fp32,
// a masked score is NEG_INF = -1e30 (not -inf), and the output is
// acc / max(l, 1e-30).
//
// Two bodies, chosen by the wrapper from (dtype, hd) alone
// (kernels/flash_attention/flash_attention.py, _route):
//
//   flash_fwd_tc<HD>    bfloat16, hd 16, 32, 64, 128, 256: tensor cores.
//   flash_fwd_simt<HD>  float32, the same head dims: CUDA cores.  The
//                       wrapper's fp32 tolerance (2e-5) is out of reach of
//                       the tensor cores' TF32 (about 1e-3).
//
// Bound, both bodies: operations.  A causal call does 4 B H hd (sum over s
// of the keys s may see) flops, about 8.2e11 at granite-20b's prefill shape
// (B=4, S=4096, H=48, hd=128), and moves only the bytes of q, k, v and out
// (~0.4 GB there), so the card's bound is its bf16 tensor-core rate.
//
// ---- flash_fwd_tc -----------------------------------------------------------
// One CTA takes one (b, h, tile of 128 query rows) and three warpgroups:
// warpgroup 0 is the producer, of which one thread issues every TMA load
// (setmaxnreg gives its registers to the others); warpgroups 1 and 2 are
// consumers, each owning 64 query rows and running both products on wgmma.
//
//   Loads.  q, k and v are read in place through 4-D tensor maps over the
//   view (hd, H, S, B) with the wrapper's byte strides, so the GQA fold is
//   the K/V head coordinate h / G and K/V are never replicated.  A tile's
//   rows are cut into boxes of one swizzle width (64 bf16 values, 128 B;
//   32 B and 64 B for hd 16 and 32): two boxes a row at hd = 128.  Q is
//   loaded once; K and V tiles of BK keys go through two rings of two
//   stages, each stage with a "full" mbarrier (TMA bytes) and an "empty"
//   one (one arrival from each consumer warp once its wgmmas have read the
//   stage), so a K stage goes back before the V stage of its tile.  Rows
//   past S and keys past Sk arrive as TMA's zero fill.
//   S = Q K^T.  wgmma m64nBKk16 with both operands in shared memory,
//   K-major as loaded (hd contiguous); hd / 16 steps, each moving the
//   descriptors' start 32 B along the swizzled row, or to the next box.
//   Online softmax on the accumulator layout.  A thread holds 2 rows x BK/4
//   columns of S; the row max reduces over the 4 lanes of a quad (shfl_xor
//   1, 2); the row sum is kept per thread and reduced once at the end.
//   Each score costs one FFMA (s hd^-1/2 log2(e) - m) and one ex2.approx.
//   O += P V.  The fp32 accumulator fragment of S is, pair for pair, the
//   bf16 A fragment of the next wgmma, so P is rounded to bf16 in registers
//   and never touches shared memory; V is the B operand, MN-major (the
//   transpose bit), its swizzle-wide column blocks one box apart.
//   Overlap.  A step issues S of tile j and P V of tile j - 1 together;
//   the two consumer warpgroups take turns to issue (named barriers), so
//   one's softmax runs while the tensor cores work on the other's products.
//   Causal work.  Key tiles above the diagonal are never loaded (the loop
//   bound).  Tiles run from the diagonal down: the leading tiles that cross
//   a warpgroup's diagonal or hold keys past Sk run a masked step, all
//   others a step with no mask code.  Query tiles are launched heaviest
//   first (blockIdx.z reversed, heads and batch in x and y), so the short
//   causal tiles fill the tail.
//   Epilogue.  O / max(l, 1e-30), rounded to bf16, stored by plain 4-byte
//   stores for rows < S.
//
// Roundings that differ from the TPU kernel, each within the bf16 gates
// (2e-2 elementwise, and the scaled norms chip_smoke.py holds it to):
//   - q stays bf16 and the fp32 scores are scaled after the product, where
//     the TPU kernel scales q in fp32 first: bf16 x bf16 products are exact
//     in fp32, so only the fp32 rounding of the sum and of the scaling moves
//     (relative 2^-24 each);
//   - exp is ex2.approx of the score scaled by log2(e) (relative error about
//     2^-22, results below 2^-126 flushed to 0);
//   - P is rounded to bf16 before P V (relative 2^-9 per weight, as the
//     plain version's p), while the row sum l adds the fp32 values;
//   - the output is O times the fp32 reciprocal of max(l, 1e-30) (within an
//     fp32 ulp of the quotient, before the bf16 rounding);
//   - the tensor cores sum the products in their own order.
//
// ---- flash_fwd_simt (float32) -----------------------------------------------
// One CTA takes one (b, h, tile of 64 query rows).  Each K step stages a
// (BK, hd) tile of K and of V in shared memory; 256 threads form a 16 x 16
// grid, a thread owning rows ty + 16 i (i < 4) of the query tile, score
// columns tx + 16 j and output columns tx + 16 j.  q is scaled in fp32
// before the product, as in the TPU kernel.  Row max and row sum reduce
// over the 16 threads of a row with warp shuffles.  The causal tile skip is
// the loop's upper bound; ragged edges are masked (query rows past S are
// computed on zeros and not stored, keys past Sk score NEG_INF against zero
// V rows).  Scalar fp32 FMAs from shared memory: far from the bound, and
// kept because fp32 is not the serving dtype.
#include <cuda.h>              // CUtensorMap and the driver's enums; the
#include <cuda_runtime.h>      // encoder is fetched through the runtime,
#include <cuda_bf16.h>         // so the library needs no -lcuda
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {                  // elements; the head dim is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ---- flash_fwd_simt ---------------------------------------------------------
namespace simt {

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int S,
               int Sk, int G, int causal, float scale, Strides st) {
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
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + kvh * st.kh;
  const float* vp = v + b * st.vb + kvh * st.vh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    Qs[r * TL::QLD + d] = s < S ? qp[s * st.qs + d] * scale : 0.f;
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
      Ks[r * TL::KLD + d] = in ? kp[s * st.ks + d] : 0.f;
      Vs[r * TL::VLD + d] = in ? vp[s * st.vs + d] : 0.f;
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

  float* op = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) op[s * st.os + tx + 16 * j] = acc[i][j] / den;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Sk, int H, int KV, int causal,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = Tile<HD>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_simt<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, Sk,
      H / KV, causal, (float)(1.0 / sqrt((double)HD)), st);  // f32(hd^-0.5)
  return cudaGetLastError();
}

}  // namespace simt

// ---- flash_fwd_tc -----------------------------------------------------------
namespace tc {

constexpr int kConsumers = 2;                 // warpgroups, 64 rows each
constexpr int kBQ = 64 * kConsumers;          // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;             // setmaxnreg: 128 x 24 +
constexpr int kConsumerRegs = 240;            // 256 x 240 <= 65,536
constexpr int kStages = 2;                    // K ring and V ring

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys per tile
  static constexpr int SW = HD >= 64 ? 128 : 2 * HD;  // swizzle = box row B
  static constexpr int BOX = SW / 2;                  // columns per box
  static constexpr int NBOX = HD / BOX;
  static constexpr int KPB = SW / 32;                 // k16 steps per box
  static constexpr int ON = HD > 128 ? 128 : HD;      // n of one P V wgmma
  static constexpr int NO = HD / ON;
  static constexpr uint32_t Q_BYTES = kBQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;   // one tile of K or V
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  // + 1024: the dynamic buffer is aligned up to the 1024-byte swizzle atom
  static constexpr size_t SMEM = BAR_OFF + 8 * (4 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {     // one MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One step of the online softmax on a warpgroup's S tile (the wgmma
// accumulator layout; rows r0 and r0 + 8 of this thread): mask where
// ``edge``, take the new row max over the quad, and leave
// exp2((s - m) hd^-1/2 log2(e)) in ``sc``, one FFMA and one EX2 a score.
// ``corr`` rescales what was accumulated against the old max.  A row whose
// keys so far are all masked (m = NEG_INF) gets p = 0 and corr = 0, so a
// fully masked tile adds nothing; every row < S has an unmasked key (key 0
// is never masked), so the -1e30 contract holds for every stored row.
// ``l`` is this thread's share of the row sum, reduced over the quad at
// the end.
template <int BK>
__device__ __forceinline__ void softmax_step(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool edge, int k0, int Sk, int causal, int r0, int cq,
    float scale_log2) {
  // max and sum over four interleaved partials a row: short dependency
  // chains, with only two consumer warps on each scheduler to hide them
  float part[2][4];
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int i = (e >> 1) & 1, a = (e >> 2) & 3;
    if (edge) {
      const int col = k0 + 8 * (e >> 2) + cq + (e & 1);
      if (col >= Sk || (causal && col > r0 + 8 * i)) sc[e] = kNegInf;
    }
    part[i][a] = e < 16 ? (e & 1 ? fmaxf(part[i][a], sc[e]) : sc[e])
                        : fmaxf(part[i][a], sc[e]);
  }
  float mx[2], ms[2];             // the new max, raw and scaled
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(fmaxf(fmaxf(part[i][0], part[i][1]),
                        fmaxf(part[i][2], part[i][3])), m[i]);
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    ms[i] = mx[i] == kNegInf ? 0.f : mx[i] * scale_log2;
    corr[i] = m[i] == kNegInf ? 0.f : ex2((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    l[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int i = (e >> 1) & 1, a = (e >> 2) & 3;
    sc[e] = ex2(fmaf(sc[e], scale_log2, -ms[i]));
    part[i][a] = e < 16 && !(e & 1) ? sc[e] : part[i][a] + sc[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] += (part[i][0] + part[i][1]) + (part[i][2] + part[i][3]);
}

// P, rounded to bf16, in the A fragments of the P V wgmma (one per k16
// step): the S accumulator pairs (8 kk + 2 r, 8 kk + 2 r + 1) are a[r].
template <int BK>
__device__ __forceinline__ void to_a_fragments(const float (&sc)[BK / 2],
                                               uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ out, long long ob, long long os,
             long long oh, int S, int Sk, int G, int causal,
             float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, SW = C::SW, ST = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = hopper::smem_addr(base);        // NBOX boxes, kBQ rows
  const uint32_t sK = sQ + C::Q_BYTES;                // + stage * KV_BYTES
  const uint32_t sV = sK + ST * C::KV_BYTES;
  const uint32_t full_k = sQ + C::BAR_OFF;            // + 8 * stage
  const uint32_t full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST;
  const uint32_t empty_v = empty_k + 8 * ST;
  const uint32_t qbar = empty_v + 8 * ST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest first
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) - 1) / BK + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full_k + 8 * s, 1);
      hopper::mbar_init(full_v + 8 * s, 1);
      hopper::mbar_init(empty_k + 8 * s, 4 * kConsumers);
      hopper::mbar_init(empty_v + 8 * s, 4 * kConsumers);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {        // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = h / G;
      hopper::mbar_expect_tx(qbar, C::Q_BYTES);
      for (int x = 0; x < C::NBOX; ++x)
        hopper::tma_load_4d(sQ + x * kBQ * SW, &qmap, qbar, x * C::BOX, h,
                            q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, k0 = (n_tiles - 1 - it) * BK;
        const uint32_t parity = (it / ST - 1) & 1;
        if (it >= ST) hopper::mbar_wait(empty_k + 8 * s, parity);
        hopper::mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
        for (int x = 0; x < C::NBOX; ++x)
          hopper::tma_load_4d(sK + s * C::KV_BYTES + x * BK * SW, &kmap,
                              full_k + 8 * s, x * C::BOX, kvh, k0, b);
        if (it >= ST) hopper::mbar_wait(empty_v + 8 * s, parity);
        hopper::mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
        for (int x = 0; x < C::NBOX; ++x)
          hopper::tma_load_4d(sV + s * C::KV_BYTES + x * BK * SW, &vmap,
                              full_v + 8 * s, x * C::BOX, kvh, k0, b);
      }
    }
  } else {                        // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int lane = t % 32, cq = 2 * (lane % 4);
    const int row0 = q0 + 64 * c;                     // this warpgroup's rows
    const int r0 = row0 + 16 * (t / 32) + lane / 4;   // mine: r0 and r0 + 8
    const uint32_t qrows = sQ + 64 * c * SW;
    // tiles run from the diagonal down: masked while they cross this
    // warpgroup's diagonal or hold keys past Sk
    auto edge = [&](int k0) {
      return k0 + BK > Sk || (causal && k0 + BK - 1 > row0);
    };
    auto qk = [&](float (&sc)[BK / 2], int s) {       // S = Q K^T, issued
      const uint32_t ks = sK + s * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t step = (kk % C::KPB) * 32;
        hopper::Wgmma<BK>::ss(
            sc,
            hopper::make_desc(qrows + (kk / C::KPB) * kBQ * SW + step, 16,
                              8 * SW, SW),
            hopper::make_desc(ks + (kk / C::KPB) * BK * SW + step, 16,
                              8 * SW, SW),
            kk > 0);
      }
      hopper::wgmma_commit();
    };
    float o[C::NO][C::ON / 2];
    uint32_t p[BK / 16][4];
    auto pv = [&](int s) {                            // O += P V, issued
      const uint32_t vs = sV + s * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < C::NO; ++n)
          hopper::Wgmma<C::ON>::rs(
              o[n], p[kk],
              hopper::make_desc(
                  vs + kk * 16 * SW + n * (C::ON / C::BOX) * BK * SW,
                  BK * SW, 8 * SW, SW));
      hopper::wgmma_commit();
    };
    // one arrival a warp; the warp's wgmma wait already covers its reads
    auto release = [&](uint32_t bar) {
      hopper::mbar_arrive_if(bar, lane == 0);
    };

#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int e = 0; e < C::ON / 2; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float sc[BK / 2];

    // tile 0 alone; then each step issues S of tile it and P V of tile
    // it - 1 together and runs the softmax of tile it once S is in.  The
    // two consumer warpgroups take turns to issue (named barriers 1 + c),
    // so one's softmax overlaps the other's products (ptxas moves the
    // wait for this warpgroup's P V ahead of its own softmax).
    hopper::mbar_wait(qbar, 0);
    hopper::mbar_wait(full_k, 0);
    hopper::wgmma_fence();
    qk(sc, 0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release(empty_k);
    const int k_top = (n_tiles - 1) * BK;
    softmax_step<BK>(sc, m, l, corr, edge(k_top), k_top, Sk, causal, r0, cq,
                     scale_log2);
    to_a_fragments<BK>(sc, p);
    if (c == 1 && n_tiles > 1) hopper::bar_arrive(1, 256);
    auto step = [&](int it, bool masked) {
      const int s = it % ST, sp = (it - 1) % ST, k0 = k_top - it * BK;
      hopper::mbar_wait(full_k + 8 * s, (it / ST) & 1);
      hopper::mbar_wait(full_v + 8 * sp, ((it - 1) / ST) & 1);
      hopper::bar_sync(1 + c, 256);
      hopper::wgmma_fence();
      qk(sc, s);
      pv(sp);
      if (c == 0 || it < n_tiles - 1) hopper::bar_arrive(2 - c, 256);
      hopper::wgmma_wait<1>();                        // S of tile it
      hopper::fence_regs(sc);
      softmax_step<BK>(sc, m, l, corr, masked, k0, Sk, causal, r0, cq,
                       scale_log2);
      hopper::fence_regs(sc);     // the softmax runs before the waits below
      release(empty_k + 8 * s);
      hopper::wgmma_wait<0>();                        // P V of tile it - 1
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        hopper::fence_regs(o[n]);
#pragma unroll
        for (int e = 0; e < C::ON / 2; ++e) o[n][e] *= corr[(e >> 1) & 1];
      }
      hopper::fence_regs(p);
      release(empty_v + 8 * sp);
      to_a_fragments<BK>(sc, p);
    };
    // the masked tiles lead (they are the top ones); the rest run with no
    // mask code at all
    int it = 1;
    for (; it < n_tiles && edge(k_top - it * BK); ++it) step(it, true);
    for (; it < n_tiles; ++it) step(it, false);
    const int sl = (n_tiles - 1) % ST;
    hopper::mbar_wait(full_v + 8 * sl, ((n_tiles - 1) / ST) & 1);
    hopper::wgmma_fence();
    pv(sl);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < C::NO; ++n) hopper::fence_regs(o[n]);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = r0 + 8 * i;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(li, 1e-30f);
      __nv_bfloat16* dst = out + b * ob + row * os + h * oh + cq;
#pragma unroll
      for (int n = 0; n < C::NO; ++n)
#pragma unroll
        for (int j = 0; j < C::ON / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + n * C::ON + 8 * j) =
              __floats2bfloat162_rn(o[n][4 * j + 2 * i] * inv,
                                    o[n][4 * j + 2 * i + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, S, H, hd) view with element strides (sb, ss,
// sh), as (hd, H, S, B), in boxes of one swizzle width by ``rows`` rows.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
              long long sb, long long ss, long long sh, int rows,
              int swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)swizzle / 2, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle mode = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Sk, int H, int KV, int causal,
                   const Strides& st, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, S, H, HD, st.qb, st.qs, st.qh, kBQ, C::SW) ||
      !make_map(&km, k, B, Sk, KV, HD, st.kb, st.ks, st.kh, C::BK, C::SW) ||
      !make_map(&vm, v, B, Sk, KV, HD, st.vb, st.vs, st.vh, C::BK, C::SW))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  const double log2e = 1.4426950408889634;
  flash_fwd_tc<HD><<<grid, kThreads, C::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, st.ob, st.os, st.oh, S, Sk, H / KV,
      causal, (float)(log2e / sqrt((double)HD)));
  return cudaGetLastError();
}

}  // namespace tc

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               int, int, int, int, int, int, const Strides&,
                               cudaStream_t);

#define FLASH_ENTRY(NS)                                                    \
  Launch NS##_for(int hd) {                                                  \
    switch (hd) {                                                            \
      case 16: return NS::launch<16>;                                        \
      case 32: return NS::launch<32>;                                        \
      case 64: return NS::launch<64>;                                        \
      case 128: return NS::launch<128>;                                      \
      case 256: return NS::launch<256>;                                      \
      default: return nullptr;                                               \
    }                                                                        \
  }
FLASH_ENTRY(simt)
FLASH_ENTRY(tc)
#undef FLASH_ENTRY

int run(Launch fn, const void* q, const void* k, const void* v, void* out,
        int B, int S, int Sk, int H, int KV, int causal,
        const long long* strides, void* stream) {
  if (fn == nullptr || B <= 0 || S <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  st.qb = strides[0]; st.qs = strides[1]; st.qh = strides[2];
  st.kb = strides[3]; st.ks = strides[4]; st.kh = strides[5];
  st.vb = strides[6]; st.vs = strides[7]; st.vh = strides[8];
  st.ob = strides[9]; st.os = strides[10]; st.oh = strides[11];
  return (int)fn(q, k, v, out, B, S, Sk, H, KV, causal, st,
                 (cudaStream_t)stream);
}

}  // namespace

// strides: 12 element strides, (batch, sequence, head) of q, k, v and out
// in that order.  Each returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported hd or shape, or for strides a
// tensor map does not take).
extern "C" int flash_attention_simt_launch(    // float32
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Sk, int H, int KV, int hd, int causal, const long long* strides,
    void* stream) {
  return run(simt_for(hd), q, k, v, out, B, S, Sk, H, KV, causal, strides,
             stream);
}

extern "C" int flash_attention_tc_launch(      // bfloat16
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Sk, int H, int KV, int hd, int causal, const long long* strides,
    void* stream) {
  return run(tc_for(hd), q, k, v, out, B, S, Sk, H, KV, causal, strides,
             stream);
}
