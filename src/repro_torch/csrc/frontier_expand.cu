// Frontier sweeps for Hopper (sm_90a): one BFS level of the paper's
// GPUBFS / GPUBFS-WR (Alg. 2 / Alg. 4).  Three kernels, each a template on
// WR (the GPUBFS-WR root test), each replacing two TPU kernels of
// repro/kernels/frontier_expand/frontier_expand.py:
//
//   fused_sweep  <- frontier_expand_fused: _kernel_fused_wr / _kernel_fused_plain
//                   (merge in _merge_tile)                             [K1]
//   proposals    <- frontier_expand: _kernel_wr / _kernel_plain (legacy) [K2]
//   pull_sweep   <- frontier_expand_pull: _kernel_pull_wr / _kernel_pull
//                   (merge in _merge_tile_pull)                        [K3]
//
// The predicate all three evaluate for an edge (c, r) (the TPU kernels'
// _proposals):
//   bfs[c] == level                      (WR also: bfs[root[c]] >= UNVISITED)
//   and (rmatch[r] == -1 or (rmatch[r] >= 0 and bfs[rmatch[r]] == UNVISITED)).
//
// Out-of-range input.  An edge slot whose column is outside [0, nc] or whose
// row is outside [0, nr], and a column whose root is outside [0, nc], are
// skipped (unsigned compares cost nothing), so a malformed graph or state
// cannot make a kernel read or write out of bounds.  The plain versions
// (kernels/frontier_expand/ref.py) skip the same slots.
//
// ---- K1, fused_sweep -------------------------------------------------------
// Contract (identical to the TPU kernel's): win is the (nr+1,) int32 vector
// holding, for each row r, the lowest column c of a proposing edge (c, r),
// IINF for rows no column proposes to, and IINF in the sentinel slot nr.
//
// Design.  The TPU kernel carries the winner accumulator in VMEM across a
// sequential grid; a CUDA grid runs in parallel and in no order, so that
// carried read-modify-write would race.  Here the winner vector is filled
// with IINF (cuMemsetD32Async, no kernel of our own), then the sweep
// evaluates the predicate per edge slot and merges with an atomic min.  min
// does not depend on order, so the result is bit-identical to the reference
// whatever the block geometry or the schedule; block_edges / schedule of the
// TPU kernel have no role, and ecol need not be sorted.
//
// Bound: bytes, and how many depends on the level.  A call must read ecol
// (4 * nnz_pad) and bfs (4(nc+1)) whole and write win (4(nr+1)); cadj only
// for the edges whose column is on the frontier (WR: and whose root is
// alive), root and rmatch once for each distinct column and row those edges
// touch.  chip_smoke.py counts these bytes from each level's inputs, over
// 3.35 TB/s on an H100 SXM.  It does no arithmetic to speak of.  What the
// design does about each way of falling short of that bound:
//  * Bytes in flight.  On most levels few edges are active and the sweep is
//    the ecol stream plus the dependent bfs[c] read.  Each thread takes four
//    consecutive slots with one 16-byte load and issues the load of its next
//    four before it evaluates these, so 16 bytes of the stream stay in
//    flight a thread where one 4-byte load at a time kept 4.  (A ring of
//    bulk copies into shared memory, and eight slots a thread, both came out
//    slower on the main-path graphs.)  The four bfs[c] reads (and, WR, the
//    root reads) go out together before any is tested.  ecol is read as a
//    vector from its first 16-byte boundary; the slots before it (the head,
//    when ecol is a view at another 4-byte offset) and the last nnz mod 4
//    (the tail) take the scalar form of the same code.  cadj is read as a
//    vector too when it shares ecol's offset modulo 16 bytes, else slot by
//    slot; either way only for a group of four with an active slot.  On
//    the few wide levels (10^5-10^6 rows won) the random reads of rmatch,
//    bfs[cm] and win behind each active edge, a 32-byte sector for 4 useful
//    bytes each, set the time instead (chip_smoke.py times each level).
//  * Cache policy.  ecol and cadj stream through once: no L1 line and
//    evict-first in L2.  bfs, root, rmatch and the win atomics carry an
//    evict-last policy, so the stream does not push the state (16 MB an
//    array at 4 M vertices, three of them fit the 50 MB L2) out of L2.
//  * Atomics.  A proposing slot reads win[r] first and sends its atomic min
//    only when win[r] > c.  Exact: win only decreases, so a slot that sees
//    win[r] <= c could not have lowered it; a stale read is never below the
//    true value.  A hot row then takes a few atomics, not one per proposer.
//  * Geometry.  The grid is as many blocks as the occupancy calculator
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, for this body's
//    registers) fits on the card, fewer for a short edge list; grid-stride
//    beyond.
//
// ---- K2, proposals ---------------------------------------------------------
// Contract: prop is the (nnz_pad,) int32 vector holding ecol[e] for every
// proposing edge slot e and IINF for every other slot; the caller merges
// (scatter_min over rows).  The TPU kernel writes one edge tile per grid
// step; here one thread per edge slot (grid-stride) with K1's early exit
// stores its slot, so the store of all nnz_pad slots is coalesced and no
// fill pass is needed.  Unlike K1 the sentinel row nr is a valid row here
// (the plain version proposes to it; the caller's merge discards it).
// Bound: bytes, K1's per-level count without the winner write and with
// the 4 * nnz_pad proposal write (chip_smoke.py).
//
// ---- K3, pull_sweep --------------------------------------------------------
// Contract: K1's winner vector, computed over the CSC mirror, whose edge
// slots are sorted by row (radj = column, erow = row; sentinels nc / nr at
// the tail).  The TPU kernel skips the in-VMEM merge of a row-sorted tile
// that proposes nothing (_merge_tile_pull).  The CUDA form of that skip:
// in pull order the row half of the predicate is the cheap one: erow
// streams, and rows being sorted, neighbouring threads mostly share a row,
// so rmatch[r] is read nearly coalesced and bfs[rmatch[r]] once per row (a
// broadcast within the warp).  A thread tests it first (row free, or its
// matched column UNVISITED) and only then reads radj[e] and the column half
// (bfs[c], WR bfs[root[c]], random reads), then merges with atomicMin.  A warp whose
// rows are all reached leaves after coalesced reads and issues no atomic.
// Winners equal K1's on the same edge set: min is the merge.
// Bound: bytes, per level.  A call must read erow whole (4 * nnz_pad);
// rmatch once per distinct row of the mirror; bfs of the matched column once
// per distinct matched row; radj only for the edges of unreached rows; bfs
// (and, WR, root) once per distinct column those edges touch; and write win
// (4(nr+1)).  chip_smoke.py counts these bytes from each level's inputs,
// over 3.35 TB/s.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnvisited = 1;
constexpr int kIinf = 1 << 30;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 8 x 256 threads fill an SM's 2048 slots

// ---- loads with a cache policy --------------------------------------------
// createpolicy gives a 64-bit L2 policy; every load or atomic below carries
// one.  Streamed arrays are read through the non-coherent path without an L1
// line; the state is read-only for a sweep, win is not (so not .nc).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ int4 ld_stream4(const int* p, uint64_t pol) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_stream(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;\n"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_state(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;\n"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_win(const int* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.cg.L2::cache_hint.s32 %0, [%1], %2;\n"
               : "=r"(v) : "l"(p), "l"(pol) : "memory");
  return v;
}

__device__ __forceinline__ void red_min(int* p, int v, uint64_t pol) {
  asm volatile("red.global.min.L2::cache_hint.s32 [%0], %1, %2;\n"
               :: "l"(p), "r"(v), "l"(pol) : "memory");
}

__global__ void fill_iinf(int* __restrict__ win, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    win[i] = kIinf;
  }
}

// What every slot of a sweep reads besides its own edge, and the policies.
struct SweepState {
  const int* __restrict__ bfs;
  const int* __restrict__ root;
  const int* __restrict__ rmatch;
  int* __restrict__ win;
  int level, nc, nr;
  uint64_t stream, keep;           // evict-first, evict-last
};

// N slots with columns c[] and rows at rows[0..N): the predicate, then the
// tested atomic min.  Each step issues its N loads before it tests any.
// rows_vec: rows is 16-byte aligned and read as one vector (N == 4).
template <bool WR, int N>
__device__ __forceinline__ void sweep_slots(const int (&c)[N],
                                            const int* rows, bool rows_vec,
                                            const SweepState& s) {
  bool act[N];
  int b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = (unsigned)c[j] <= (unsigned)s.nc;   // out of range: skipped
    b[j] = act[j] ? ld_state(s.bfs + c[j], s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) act[j] = act[j] && b[j] == s.level;
  if (WR) {
    int rt[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      rt[j] = act[j] ? ld_state(s.root + c[j], s.keep) : -1;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      act[j] = act[j] && (unsigned)rt[j] <= (unsigned)s.nc;
      b[j] = act[j] ? ld_state(s.bfs + rt[j], s.keep) : 0;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) act[j] = act[j] && b[j] >= kUnvisited;
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) any = any || act[j];
  if (!any) return;
  int r[N];
  if constexpr (N == 4) {
    if (rows_vec) {
      const int4 v = ld_stream4(rows, s.stream);
      r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        r[j] = act[j] ? ld_stream(rows + j, s.stream) : -1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = ld_stream(rows + j, s.stream);
  }
  int cm[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    // sentinel row nr stays IINF; out of range: skipped
    act[j] = act[j] && (unsigned)r[j] < (unsigned)s.nr;
    cm[j] = act[j] ? ld_state(s.rmatch + r[j], s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    b[j] = act[j] && cm[j] >= 0
               ? ld_state(s.bfs + min(cm[j], s.nc), s.keep) : kUnvisited;
  }
  int w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = act[j] && (cm[j] == -1 || (cm[j] >= 0 && b[j] == kUnvisited));
    w[j] = act[j] ? ld_win(s.win + r[j], s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (act[j] && w[j] > c[j]) red_min(s.win + r[j], c[j], s.keep);
  }
}

template <bool WR>
__global__ void __launch_bounds__(kThreads)
    fused_sweep(const int* __restrict__ ecol, const int* __restrict__ cadj,
                const int* __restrict__ bfs, const int* __restrict__ root,
                const int* __restrict__ rmatch, int level, int64_t nnz,
                int nc, int nr, int* __restrict__ win) {
  const SweepState s{bfs, root, rmatch, win, level, nc, nr,
                     evict_first_policy(), evict_last_policy()};
  // slots [0, head) lie before ecol's first 16-byte boundary, [end, nnz)
  // after its last whole vector; the launcher refuses a pointer that is not
  // 4-byte aligned
  const int64_t lead = (int64_t)(((16 - ((uintptr_t)ecol & 15)) & 15) >> 2);
  const int64_t head = lead < nnz ? lead : nnz;
  const int64_t nvec = (nnz - head) >> 2;
  const int64_t end = head + 4 * nvec;
  const bool rows_vec = (((uintptr_t)(cadj + head)) & 15) == 0;
  if (blockIdx.x == 0 && threadIdx.x < head + (nnz - end)) {
    const int64_t e = threadIdx.x < head ? (int64_t)threadIdx.x
                                         : end + (threadIdx.x - head);
    const int c[1] = {ld_stream(ecol + e, s.stream)};
    sweep_slots<WR, 1>(c, cadj + e, false, s);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nvec) return;
  const int* base = ecol + head;
  int4 next = ld_stream4(base + 4 * k, s.stream);
  for (; k < nvec; k += stride) {
    const int c[4] = {next.x, next.y, next.z, next.w};
    if (k + stride < nvec) {
      next = ld_stream4(base + 4 * (k + stride), s.stream);
    }
    sweep_slots<WR, 4>(c, cadj + head + 4 * k, rows_vec, s);
  }
}

template <bool WR>
__global__ void proposals(const int* __restrict__ ecol,
                          const int* __restrict__ cadj,
                          const int* __restrict__ bfs,
                          const int* __restrict__ root,
                          const int* __restrict__ rmatch, int level,
                          int64_t nnz, int nc, int nr,
                          int* __restrict__ prop) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    int out = kIinf;
    const int c = __ldg(ecol + e);
    if ((unsigned)c <= (unsigned)nc && __ldg(bfs + c) == level) {
      bool alive = true;
      if (WR) {
        const int rt = __ldg(root + c);
        alive = (unsigned)rt <= (unsigned)nc && __ldg(bfs + rt) >= kUnvisited;
      }
      const int r = alive ? __ldg(cadj + e) : -1;
      if ((unsigned)r <= (unsigned)nr) {            // row nr is in range here
        const int cm = __ldg(rmatch + r);
        if (cm == -1 || (cm >= 0 && __ldg(bfs + min(cm, nc)) == kUnvisited)) {
          out = c;
        }
      }
    }
    prop[e] = out;
  }
}

template <bool WR>
__global__ void pull_sweep(const int* __restrict__ radj,
                           const int* __restrict__ erow,
                           const int* __restrict__ bfs,
                           const int* __restrict__ root,
                           const int* __restrict__ rmatch, int level,
                           int64_t nnz, int nc, int nr,
                           int* __restrict__ win) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    // row half first: streamed erow, nearly coalesced rmatch / bfs[cm]
    const int r = __ldg(erow + e);
    // sentinel row nr stays IINF; out of range: skipped
    if ((unsigned)r >= (unsigned)nr) continue;
    const int cm = __ldg(rmatch + r);
    if (!(cm == -1 || (cm >= 0 && __ldg(bfs + min(cm, nc)) == kUnvisited))) {
      continue;
    }
    // column half: random reads, only for the edges of unreached rows
    const int c = __ldg(radj + e);
    if ((unsigned)c > (unsigned)nc || __ldg(bfs + c) != level) continue;
    if (WR) {
      const int rt = __ldg(root + c);
      if ((unsigned)rt > (unsigned)nc || __ldg(bfs + rt) < kUnvisited) continue;
    }
    atomicMin(win + r, c);
  }
}

}  // namespace

// Launch geometry of K2 and K3: one block of kThreads per kThreads edge
// slots, at most kBlocksPerSm blocks on each SM of the current device
// (grid-stride beyond).
static cudaError_t max_blocks(int* out) {
  int device = 0, sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  *out = (sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  return err;
}

static int blocks_for(long long n, int cap) {
  long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < cap ? want : cap);
}

// Each launcher runs on `stream` of the current device.  `root` may be null
// (the plain body).  Returns cudaGetLastError() after the launches
// (0 = success).  The argument order is the same for all three:
// (column endpoints, row endpoints, bfs, root, rmatch, level, slots, nc, nr,
// output, stream).

// K1's winner fill: cuMemsetD32Async, fetched from the driver once through
// the runtime (no -lcuda), since IINF is no byte pattern for cudaMemset.
using MemsetD32 = CUresult (*)(CUdeviceptr, unsigned int, size_t, CUstream);

static MemsetD32 memset_d32() {
  static MemsetD32 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuMemsetD32Async", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuMemsetD32Async", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<MemsetD32>(p);
  }
  return fn;
}

// K1's grid: as many blocks of kThreads as fit on the card at this body's
// occupancy, once per body and device.
template <bool WR>
static cudaError_t sweep_blocks(int* out) {
  static int cached[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sm_count = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_sweep<WR>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[device] = (sm_count > 0 ? sm_count : 1) * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[device];
  return cudaSuccess;
}

// K1: win (nr+1,) per-row winners over the CSR edge list.  ecol and cadj
// may be views at any 4-byte offset; one that is not 4-byte aligned is
// refused (cudaErrorMisalignedAddress), never read.
extern "C" int frontier_expand_fused_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
    const int* rmatch, int level, long long nnz, int nc, int nr, int* win,
    void* stream) {
  if (((uintptr_t)ecol | (uintptr_t)cadj) & 3) {
    return (int)cudaErrorMisalignedAddress;
  }
  const MemsetD32 fill = memset_d32();
  if (fill == nullptr) return (int)cudaErrorSymbolNotFound;
  cudaStream_t s = (cudaStream_t)stream;
  if (fill((CUdeviceptr)win, (unsigned int)kIinf, (size_t)nr + 1,
           (CUstream)s) != CUDA_SUCCESS) {
    return (int)cudaErrorLaunchFailure;
  }
  if (nnz > 0) {
    int cap = 0;
    cudaError_t err = root != nullptr ? sweep_blocks<true>(&cap)
                                      : sweep_blocks<false>(&cap);
    if (err != cudaSuccess) return (int)err;
    // one thread per four slots; block 0 also takes the <= 6 scalar slots
    const int blocks = blocks_for((nnz + 3) / 4, cap);
    if (root != nullptr) {
      fused_sweep<true><<<blocks, kThreads, 0, s>>>(
          ecol, cadj, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, win);
    } else {
      fused_sweep<false><<<blocks, kThreads, 0, s>>>(
          ecol, cadj, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, win);
    }
  }
  return (int)cudaGetLastError();
}

// K2: prop (nnz,) per-edge proposals; every slot is written.
extern "C" int frontier_expand_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
    const int* rmatch, int level, long long nnz, int nc, int nr, int* prop,
    void* stream) {
  int cap = 0;
  cudaError_t err = max_blocks(&cap);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz > 0) {
    const int blocks = blocks_for(nnz, cap);
    if (root != nullptr) {
      proposals<true><<<blocks, kThreads, 0, s>>>(
          ecol, cadj, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, prop);
    } else {
      proposals<false><<<blocks, kThreads, 0, s>>>(
          ecol, cadj, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, prop);
    }
  }
  return (int)cudaGetLastError();
}

// K3: win (nr+1,) per-row winners over the row-sorted CSC mirror.
extern "C" int frontier_expand_pull_launch(
    const int* radj, const int* erow, const int* bfs, const int* root,
    const int* rmatch, int level, long long nnz, int nc, int nr, int* win,
    void* stream) {
  int cap = 0;
  cudaError_t err = max_blocks(&cap);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fill_iinf<<<blocks_for(nr + 1LL, cap), kThreads, 0, s>>>(win, nr + 1);
  if (nnz > 0) {
    const int blocks = blocks_for(nnz, cap);
    if (root != nullptr) {
      pull_sweep<true><<<blocks, kThreads, 0, s>>>(
          radj, erow, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, win);
    } else {
      pull_sweep<false><<<blocks, kThreads, 0, s>>>(
          radj, erow, bfs, root, rmatch, level, (int64_t)nnz, nc, nr, win);
    }
  }
  return (int)cudaGetLastError();
}
