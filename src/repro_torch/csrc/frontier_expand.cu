// Frontier sweeps for Hopper (sm_90a): one BFS level of the paper's
// GPUBFS / GPUBFS-WR (Alg. 2 / Alg. 4).  Three sweeps, each replacing two
// TPU kernels of repro/kernels/frontier_expand/frontier_expand.py, each with
// a body per WR (the GPUBFS-WR root test; the pull's sits in its column
// pass):
//
//   fused_sweep  <- frontier_expand_fused: _kernel_fused_wr / _kernel_fused_plain
//                   (merge in _merge_tile)                             [K1]
//   proposals    <- frontier_expand: _kernel_wr / _kernel_plain (legacy) [K2]
//   frontier_bits + pull_sweep
//                <- frontier_expand_pull: _kernel_pull_wr / _kernel_pull
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
// Launches inside CUDA graphs.  The solver captures its BFS levels into
// CUDA graphs and replays them level after level, so every sweep reads its
// level from a device pointer (or takes it as an immediate), runs only
// where a device gate is set, and counts itself in a device counter when it
// runs (struct Launch).  The gate and the level cost one cached load a
// thread.
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
// step.  Here K1's body does the reading: four slots a thread through one
// 16-byte load of ecol with the next four in flight, the bfs[c] (WR: root,
// then bfs[root]) loads of a group issued before any test, cadj (a vector
// where it shares ecol's offset modulo 16 bytes) and the row half read only
// for a group with an active slot, the same cache policies and head / tail
// slots, the grid from the occupancy calculator.  Each group is written
// with one streaming 16-byte store (st.global.cs: evict-first in L2) where
// prop + head is 16-byte aligned (prop is the wrapper's own allocation, so
// this fails only when ecol is a view at another offset), else four
// scalar ones.  Every slot is written exactly once: no fill.  Unlike K1 the
// sentinel row nr is a valid row here (the plain version proposes to it;
// the caller's merge discards it).
// Bound: bytes, K1's per-level count without the winner write and with
// the 4 * nnz_pad proposal write (chip_smoke.py).
//
// ---- K3, frontier_bits + pull_sweep ---------------------------------------
// Contract: K1's winner vector, computed over the CSC mirror, whose edge
// slots are sorted by row (radj = column, erow = row; sentinels nc / nr at
// the tail).  The TPU kernel skips the in-VMEM merge of a row-sorted tile
// that proposes nothing (_merge_tile_pull).  Two launches here, after the
// IINF fill of win (cuMemsetD32Async, as K1):
//  * frontier_bits<WR> evaluates the column half of the predicate once per
//    column: bit c & 31 of word c >> 5 is bfs[c] == level (WR: and root[c]
//    in [0, nc] and bfs[root[c]] >= UNVISITED), for every c in [0, nc]
//    (column nc from bfs[nc] like any other).  A warp takes 128 columns at
//    a time: four coalesced bfs loads a lane, issued together (WR: root
//    and bfs[root] only for columns on the frontier), then four
//    __ballot_sync words, each written once by one lane.  The words are
//    ceil((nc+1)/32) int32 the wrapper allocates (512 KB at 4 M columns).
//  * pull_sweep (one body for both: the root test is in the bits) streams
//    erow four slots a thread like K1 streams ecol (16-byte loads, the next
//    four in flight, evict-first, head and tail slots scalar).  Rows are
//    sorted, so neighbouring slots share rmatch[r] and bfs[rmatch[r]]: the
//    row half is tested first (row free, or its matched column UNVISITED),
//    and only a group with an unreached row reads radj and tests each
//    column as one bit of the bitmap, read through L1 (ld.global.nc,
//    evict-last in L1 and in L2; the shared-memory carveout is set to its
//    minimum so that L1 holds as much of the bitmap as it can).  A column
//    test made per edge would pay bfs[c] (WR also root[c], then
//    bfs[root[c]], each waiting on the one before) for every edge of an
//    unreached row, a 32-byte sector each; this pays one read that mostly
//    hits L1.  A group's slots of one row merge in registers (min), then
//    K1's tested atomic min.  The slots may come in any order: the merge is
//    a min, the bitmap is per column.  (Skipping the row reads of a slot
//    whose row is its left neighbour's came out slower: L1 already serves
//    the repeats.)
// Winners equal K1's on the same edge set: min is the merge.
// Bound: bytes, per level.  A call must read erow whole (4 * nnz_pad);
// rmatch once per distinct row of the mirror; bfs of the matched column once
// per distinct matched row; radj only for the edges of unreached rows; bfs
// (and, WR, root) once per distinct column those edges touch; and write win
// (4(nr+1)).  chip_smoke.py counts these bytes from each level's inputs,
// over 3.35 TB/s.  The bitmap pass reads bfs whole, more than that count:
// a cost of the design, which the bound does not hide.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnvisited = 1;
constexpr int kIinf = 1 << 30;
constexpr int kThreads = 256;

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

// The pull's column bits: kept in L1 ahead of the row state, evict-last
// in L2.
__device__ __forceinline__ int ld_bits(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L1::evict_last.L2::cache_hint.s32 %0, [%1], %2;\n"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void red_min(int* p, int v, uint64_t pol) {
  asm volatile("red.global.min.L2::cache_hint.s32 [%0], %1, %2;\n"
               :: "l"(p), "r"(v), "l"(pol) : "memory");
}

// How a launch finds its level and whether it runs, so that a launch
// captured in a CUDA graph can be replayed at every level.  level_ptr:
// read the level from device memory (null: the immediate `level`).  gate:
// an int32 flag in device memory; where it is 0 the launch does no work and
// writes nothing (null: always on).  count: where the launch runs, block 0
// adds one to it (null: not counted).
struct Launch {
  int level;
  const int* level_ptr;
  const int* gate;
  unsigned long long* count;
};

// Whether the launch runs; counts it once if so.  Every thread of the grid
// reads the same gate, so the whole grid returns or none of it does.
__device__ __forceinline__ bool launch_on(const Launch& l) {
  if (l.gate != nullptr && *l.gate == 0) return false;
  if (l.count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(l.count, 1ull);
  }
  return true;
}

__device__ __forceinline__ int launch_level(const Launch& l) {
  return l.level_ptr != nullptr ? *l.level_ptr : l.level;
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

// Slots [0, head) of an edge array lie before its first 16-byte boundary,
// [end, nnz) after its last whole vector; in between nvec vectors of four.
struct Split {
  int64_t head, nvec, end;
};

__device__ __forceinline__ Split split_slots(const int* p, int64_t nnz) {
  const int64_t lead = (int64_t)(((16 - ((uintptr_t)p & 15)) & 15) >> 2);
  const int64_t head = lead < nnz ? lead : nnz;
  const int64_t nvec = (nnz - head) >> 2;
  return Split{head, nvec, head + 4 * nvec};
}

// The predicate over N slots with columns c[] and rows at rows[0..N): which
// slots propose (act) and their rows (r), rows in [0, row_end) counting.
// Each step issues its N loads before it tests any.  rows_vec: rows is
// 16-byte aligned and read as one vector (N == 4).  Returns false, with
// every act[] false and r[] unset, when no slot passes the column half;
// the rows are read only otherwise.
template <bool WR, int N>
__device__ __forceinline__ bool propose(const int (&c)[N], const int* rows,
                                        bool rows_vec, unsigned row_end,
                                        const SweepState& s, bool (&act)[N],
                                        int (&r)[N]) {
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
  if (!any) return false;
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
    act[j] = act[j] && (unsigned)r[j] < row_end;   // out of range: skipped
    cm[j] = act[j] ? ld_state(s.rmatch + r[j], s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    b[j] = act[j] && cm[j] >= 0
               ? ld_state(s.bfs + min(cm[j], s.nc), s.keep) : kUnvisited;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = act[j] && (cm[j] == -1 || (cm[j] >= 0 && b[j] == kUnvisited));
  }
  return true;
}

// K1's N slots: the predicate, then the tested atomic min.
template <bool WR, int N>
__device__ __forceinline__ void sweep_slots(const int (&c)[N],
                                            const int* rows, bool rows_vec,
                                            const SweepState& s) {
  bool act[N];
  int r[N];
  // the sentinel row nr stays IINF
  if (!propose<WR, N>(c, rows, rows_vec, (unsigned)s.nr, s, act, r)) return;
  int w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = act[j] ? ld_win(s.win + r[j], s.keep) : 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (act[j] && w[j] > c[j]) red_min(s.win + r[j], c[j], s.keep);
  }
}

template <bool WR>
__global__ void __launch_bounds__(kThreads)
    fused_sweep(const int* __restrict__ ecol, const int* __restrict__ cadj,
                const int* __restrict__ bfs, const int* __restrict__ root,
                const int* __restrict__ rmatch, Launch launch, int64_t nnz,
                int nc, int nr, int* __restrict__ win) {
  if (!launch_on(launch)) return;           // win keeps its IINF fill
  const SweepState s{bfs, root, rmatch, win, launch_level(launch), nc, nr,
                     evict_first_policy(), evict_last_policy()};
  // the launcher refuses a pointer that is not 4-byte aligned
  const Split sp = split_slots(ecol, nnz);
  const bool rows_vec = (((uintptr_t)(cadj + sp.head)) & 15) == 0;
  if (blockIdx.x == 0 && threadIdx.x < sp.head + (nnz - sp.end)) {
    const int64_t e = threadIdx.x < sp.head ? (int64_t)threadIdx.x
                                            : sp.end + (threadIdx.x - sp.head);
    const int c[1] = {ld_stream(ecol + e, s.stream)};
    sweep_slots<WR, 1>(c, cadj + e, false, s);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= sp.nvec) return;
  const int* base = ecol + sp.head;
  int4 next = ld_stream4(base + 4 * k, s.stream);
  for (; k < sp.nvec; k += stride) {
    const int c[4] = {next.x, next.y, next.z, next.w};
    if (k + stride < sp.nvec) {
      next = ld_stream4(base + 4 * (k + stride), s.stream);
    }
    sweep_slots<WR, 4>(c, cadj + sp.head + 4 * k, rows_vec, s);
  }
}

template <bool WR>
__global__ void __launch_bounds__(kThreads)
    proposals(const int* __restrict__ ecol, const int* __restrict__ cadj,
              const int* __restrict__ bfs, const int* __restrict__ root,
              const int* __restrict__ rmatch, Launch launch, int64_t nnz,
              int nc, int nr, int* __restrict__ prop) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (!launch_on(launch)) {
    // gated off: no proposal, every slot IINF (prop is the wrapper's
    // torch.empty, so it must still be written)
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nnz;
         e += stride) {
      __stcs(prop + e, kIinf);
    }
    return;
  }
  const SweepState s{bfs, root, rmatch, nullptr, launch_level(launch), nc,
                     nr, evict_first_policy(), evict_last_policy()};
  // row nr is a row here: rows [0, nr] count
  const unsigned row_end = (unsigned)nr + 1u;
  const Split sp = split_slots(ecol, nnz);
  const bool rows_vec = (((uintptr_t)(cadj + sp.head)) & 15) == 0;
  const bool out_vec = (((uintptr_t)(prop + sp.head)) & 15) == 0;
  if (blockIdx.x == 0 && threadIdx.x < sp.head + (nnz - sp.end)) {
    const int64_t e = threadIdx.x < sp.head ? (int64_t)threadIdx.x
                                            : sp.end + (threadIdx.x - sp.head);
    const int c[1] = {ld_stream(ecol + e, s.stream)};
    bool act[1];
    int r[1];
    propose<WR, 1>(c, cadj + e, false, row_end, s, act, r);
    __stcs(prop + e, act[0] ? c[0] : kIinf);
  }
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= sp.nvec) return;
  const int* base = ecol + sp.head;
  int4 next = ld_stream4(base + 4 * k, s.stream);
  for (; k < sp.nvec; k += stride) {
    const int c[4] = {next.x, next.y, next.z, next.w};
    if (k + stride < sp.nvec) {
      next = ld_stream4(base + 4 * (k + stride), s.stream);
    }
    bool act[4];
    int r[4];
    propose<WR, 4>(c, cadj + sp.head + 4 * k, rows_vec, row_end, s, act, r);
    const int4 o = make_int4(act[0] ? c[0] : kIinf, act[1] ? c[1] : kIinf,
                             act[2] ? c[2] : kIinf, act[3] ? c[3] : kIinf);
    int* out = prop + sp.head + 4 * k;
    if (out_vec) {
      __stcs(reinterpret_cast<int4*>(out), o);
    } else {
      __stcs(out, o.x);
      __stcs(out + 1, o.y);
      __stcs(out + 2, o.z);
      __stcs(out + 3, o.w);
    }
  }
}

// K3's column pass: one bit per column c in [0, nc], a warp 128 columns
// (four words) at a time.
template <bool WR>
__global__ void __launch_bounds__(kThreads)
    frontier_bits(const int* __restrict__ bfs, const int* __restrict__ root,
                  Launch launch, int nc, int* __restrict__ bits) {
  if (!launch_on(launch)) return;
  const int level = launch_level(launch);
  const uint64_t keep = evict_last_policy();
  const int lane = threadIdx.x & 31;
  const int64_t nwords = ((int64_t)nc + 32) >> 5;
  const int64_t chunks = (nwords + 3) >> 2;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  // k is the same for the whole warp, so every lane reaches each ballot
  for (int64_t k = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       k < chunks; k += warps) {
    bool on[4];
    int b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = 128 * k + 32 * j + lane;
      on[j] = c <= nc;
      b[j] = on[j] ? ld_state(bfs + c, keep) : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) on[j] = on[j] && b[j] == level;
    if (WR) {
      int rt[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rt[j] = on[j] ? ld_state(root + 128 * k + 32 * j + lane, keep) : -1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        on[j] = on[j] && (unsigned)rt[j] <= (unsigned)nc;
        b[j] = on[j] ? ld_state(bfs + rt[j], keep) : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) on[j] = on[j] && b[j] >= kUnvisited;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned word = __ballot_sync(0xffffffffu, on[j]);
      if (lane == j && 4 * k + j < nwords) bits[4 * k + j] = (int)word;
    }
  }
}

// What every slot of the pull sweep reads besides its own edge.
struct PullState {
  const int* __restrict__ bits;
  const int* __restrict__ bfs;
  const int* __restrict__ rmatch;
  int* __restrict__ win;
  int nc, nr;
  uint64_t stream, keep;           // evict-first, evict-last
};

// K3's N slots with rows r[] and columns at cols[0..N): the row half, then
// (for a group with an unreached row) the column bits, a merge of the
// group's slots of one row, and the tested atomic min.  cols_vec: cols is
// 16-byte aligned and read as one vector (N == 4).
template <int N>
__device__ __forceinline__ void pull_slots(const int (&r)[N],
                                           const int* cols, bool cols_vec,
                                           const PullState& s) {
  bool act[N];
  int cm[N], b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    // sentinel row nr stays IINF; out of range: skipped
    act[j] = (unsigned)r[j] < (unsigned)s.nr;
    cm[j] = act[j] ? ld_state(s.rmatch + r[j], s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    b[j] = act[j] && cm[j] >= 0
               ? ld_state(s.bfs + min(cm[j], s.nc), s.keep) : kUnvisited;
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = act[j] && (cm[j] == -1 || (cm[j] >= 0 && b[j] == kUnvisited));
    any = any || act[j];
  }
  if (!any) return;
  int c[N];
  if constexpr (N == 4) {
    if (cols_vec) {
      const int4 v = ld_stream4(cols, s.stream);
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        c[j] = act[j] ? ld_stream(cols + j, s.stream) : -1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = ld_stream(cols + j, s.stream);
  }
  int w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = act[j] && (unsigned)c[j] <= (unsigned)s.nc;  // out of range
    w[j] = act[j] ? ld_bits(s.bits + (c[j] >> 5), s.keep) : 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    act[j] = act[j] && (((unsigned)w[j] >> (c[j] & 31)) & 1u);
  }
  // slots of one row hand the lower column on to the next: one atomic a
  // row and group
#pragma unroll
  for (int j = 1; j < N; ++j) {
    if (act[j - 1] && r[j] == r[j - 1]) {
      c[j] = act[j] ? min(c[j], c[j - 1]) : c[j - 1];
      act[j] = true;
      act[j - 1] = false;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = act[j] ? ld_win(s.win + r[j], s.keep) : 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (act[j] && w[j] > c[j]) red_min(s.win + r[j], c[j], s.keep);
  }
}

__global__ void __launch_bounds__(kThreads)
    pull_sweep(const int* __restrict__ radj, const int* __restrict__ erow,
               const int* __restrict__ bits, const int* __restrict__ bfs,
               const int* __restrict__ rmatch, Launch launch, int64_t nnz,
               int nc, int nr, int* __restrict__ win) {
  if (!launch_on(launch)) return;           // win keeps its IINF fill
  const PullState s{bits, bfs, rmatch, win, nc, nr, evict_first_policy(),
                    evict_last_policy()};
  const Split sp = split_slots(erow, nnz);
  const bool cols_vec = (((uintptr_t)(radj + sp.head)) & 15) == 0;
  if (blockIdx.x == 0 && threadIdx.x < sp.head + (nnz - sp.end)) {
    const int64_t e = threadIdx.x < sp.head ? (int64_t)threadIdx.x
                                            : sp.end + (threadIdx.x - sp.head);
    const int r[1] = {ld_stream(erow + e, s.stream)};
    pull_slots<1>(r, radj + e, false, s);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= sp.nvec) return;
  const int* base = erow + sp.head;
  int4 next = ld_stream4(base + 4 * k, s.stream);
  for (; k < sp.nvec; k += stride) {
    const int r[4] = {next.x, next.y, next.z, next.w};
    if (k + stride < sp.nvec) {
      next = ld_stream4(base + 4 * (k + stride), s.stream);
    }
    pull_slots<4>(r, radj + sp.head + 4 * k, cols_vec, s);
  }
}

}  // namespace

static int blocks_for(long long n, int cap) {
  // at least one block, so that every launch that runs is counted
  long long want = (n + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

// Each launcher runs on `stream` of the current device.  `root` may be null
// (the plain body).  Returns cudaGetLastError() after the launches
// (0 = success).  The argument order is the same for all three sweeps:
// (column endpoints, row endpoints, bfs, root, rmatch, level, level_ptr,
// gate, slots, nc, nr, output, [the pull's bitmap,] counts, stream).
// level_ptr, gate and counts may be null (see Launch).  A launch captured
// in a CUDA graph keeps its arguments, so a graph replayed level after
// level passes level_ptr and gate, and the fill below stays outside the
// gate: a gated-off K1 or K3 leaves win all IINF.  counts is an array of
// eight launch counters, one per kernel body, in the order of Slot.

enum Slot { kProposals = 0, kFused = 2, kPull = 4, kBits = 6 };

static unsigned long long* slot(unsigned long long* counts, Slot kernel,
                                const int* root) {
  return counts == nullptr ? nullptr
                           : counts + kernel + (root != nullptr ? 0 : 1);
}

// The winner fill: cuMemsetD32Async, fetched from the driver once through
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

static cudaError_t fill_iinf(int* win, int nr, cudaStream_t s) {
  const MemsetD32 fill = memset_d32();
  if (fill == nullptr) return cudaErrorSymbolNotFound;
  if (fill((CUdeviceptr)win, (unsigned int)kIinf, (size_t)nr + 1,
           (CUstream)s) != CUDA_SUCCESS) {
    return cudaErrorLaunchFailure;
  }
  return cudaSuccess;
}

// A kernel's grid: as many blocks of kThreads as fit on the card at its
// occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor, for its
// registers), once per kernel body and device; `cached` is the body's own.
// `max_l1`: set the body's shared-memory carveout to its minimum first.
static cudaError_t card_blocks(const void* kernel, int (&cached)[64],
                               int* out, bool max_l1 = false) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    int sm_count = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (max_l1) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxL1);
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[device] = (sm_count > 0 ? sm_count : 1) * (per_sm > 0 ? per_sm : 1);
  }
  *out = cached[device];
  return cudaSuccess;
}

template <bool WR>
static cudaError_t fused_blocks(int* out) {
  static int cached[64] = {0};
  return card_blocks((const void*)fused_sweep<WR>, cached, out);
}

template <bool WR>
static cudaError_t proposal_blocks(int* out) {
  static int cached[64] = {0};
  return card_blocks((const void*)proposals<WR>, cached, out);
}

template <bool WR>
static cudaError_t bits_blocks(int* out) {
  static int cached[64] = {0};
  return card_blocks((const void*)frontier_bits<WR>, cached, out);
}

static cudaError_t pull_blocks(int* out) {
  static int cached[64] = {0};
  return card_blocks((const void*)pull_sweep, cached, out, true);
}

// K1: win (nr+1,) per-row winners over the CSR edge list.  ecol and cadj
// may be views at any 4-byte offset; one that is not 4-byte aligned is
// refused (cudaErrorMisalignedAddress), never read.
extern "C" int frontier_expand_fused_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
    const int* rmatch, int level, const int* level_ptr, const int* gate,
    long long nnz, int nc, int nr, int* win, unsigned long long* counts,
    void* stream) {
  if (((uintptr_t)ecol | (uintptr_t)cadj) & 3) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = fill_iinf(win, nr, s);
  if (err != cudaSuccess) return (int)err;
  int cap = 0;
  err = root != nullptr ? fused_blocks<true>(&cap) : fused_blocks<false>(&cap);
  if (err != cudaSuccess) return (int)err;
  const Launch l{level, level_ptr, gate, slot(counts, kFused, root)};
  // one thread per four slots; block 0 also takes the <= 6 scalar slots
  const int blocks = blocks_for((nnz + 3) / 4, cap);
  if (root != nullptr) {
    fused_sweep<true><<<blocks, kThreads, 0, s>>>(
        ecol, cadj, bfs, root, rmatch, l, (int64_t)nnz, nc, nr, win);
  } else {
    fused_sweep<false><<<blocks, kThreads, 0, s>>>(
        ecol, cadj, bfs, root, rmatch, l, (int64_t)nnz, nc, nr, win);
  }
  return (int)cudaGetLastError();
}

// K2: prop (nnz,) per-edge proposals; every slot is written (IINF
// everywhere where the gate is off).  ecol and cadj as K1's.
extern "C" int frontier_expand_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
    const int* rmatch, int level, const int* level_ptr, const int* gate,
    long long nnz, int nc, int nr, int* prop, unsigned long long* counts,
    void* stream) {
  if (((uintptr_t)ecol | (uintptr_t)cadj | (uintptr_t)prop) & 3) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  int cap = 0;
  const cudaError_t err = root != nullptr ? proposal_blocks<true>(&cap)
                                          : proposal_blocks<false>(&cap);
  if (err != cudaSuccess) return (int)err;
  const Launch l{level, level_ptr, gate, slot(counts, kProposals, root)};
  const int blocks = blocks_for((nnz + 3) / 4, cap);
  if (root != nullptr) {
    proposals<true><<<blocks, kThreads, 0, s>>>(
        ecol, cadj, bfs, root, rmatch, l, (int64_t)nnz, nc, nr, prop);
  } else {
    proposals<false><<<blocks, kThreads, 0, s>>>(
        ecol, cadj, bfs, root, rmatch, l, (int64_t)nnz, nc, nr, prop);
  }
  return (int)cudaGetLastError();
}

// K3's column pass alone: bits (ceil((nc+1)/32),) int32 words (not written
// where the gate is off).
extern "C" int frontier_bits_launch(const int* bfs, const int* root,
                                    int level, const int* level_ptr,
                                    const int* gate, int nc, int* bits,
                                    unsigned long long* counts,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int cap = 0;
  const cudaError_t err = root != nullptr ? bits_blocks<true>(&cap)
                                          : bits_blocks<false>(&cap);
  if (err != cudaSuccess) return (int)err;
  const Launch l{level, level_ptr, gate, slot(counts, kBits, root)};
  // one warp per 128 columns
  const long long chunks = ((long long)nc + 128) / 128;
  const int blocks = blocks_for(32 * chunks, cap);
  if (root != nullptr) {
    frontier_bits<true><<<blocks, kThreads, 0, s>>>(bfs, root, l, nc, bits);
  } else {
    frontier_bits<false><<<blocks, kThreads, 0, s>>>(bfs, root, l, nc, bits);
  }
  return (int)cudaGetLastError();
}

// K3: win (nr+1,) per-row winners over the row-sorted CSC mirror, through
// the column bitmap `bits` (the caller's scratch, ceil((nc+1)/32) words).
// radj and erow may be views at any 4-byte offset, as K1's edges.  The
// gate holds for both launches.
extern "C" int frontier_expand_pull_launch(
    const int* radj, const int* erow, const int* bfs, const int* root,
    const int* rmatch, int level, const int* level_ptr, const int* gate,
    long long nnz, int nc, int nr, int* win, int* bits,
    unsigned long long* counts, void* stream) {
  if (((uintptr_t)radj | (uintptr_t)erow) & 3) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = fill_iinf(win, nr, s);
  if (err != cudaSuccess) return (int)err;
  const int bits_err = frontier_bits_launch(bfs, root, level, level_ptr, gate,
                                            nc, bits, counts, stream);
  if (bits_err != 0) return bits_err;
  int cap = 0;
  err = pull_blocks(&cap);
  if (err != cudaSuccess) return (int)err;
  const Launch l{level, level_ptr, gate, slot(counts, kPull, root)};
  const int blocks = blocks_for((nnz + 3) / 4, cap);
  pull_sweep<<<blocks, kThreads, 0, s>>>(radj, erow, bits, bfs, rmatch, l,
                                         (int64_t)nnz, nc, nr, win);
  return (int)cudaGetLastError();
}
