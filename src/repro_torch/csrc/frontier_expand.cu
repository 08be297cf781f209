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
// with IINF, then one thread per edge slot (grid-stride) evaluates the
// predicate and merges with atomicMin.  min does not depend on order, so the
// result is bit-identical to the reference whatever the block geometry or
// the schedule; block_edges / schedule of the TPU kernel have no role.
// Most edges are inactive on most levels, so a thread loads ecol[e] and
// bfs[c] first and leaves before the random reads of cadj/rmatch/bfs[cm].
//
// Bound: bytes, and how many depends on the level.  A call must read ecol
// (4 * nnz_pad) and bfs (4(nc+1)) whole and write win (4(nr+1)); cadj only
// for the edges whose column is on the frontier (WR: and whose root is
// alive), root and rmatch once for each distinct column and row those edges
// touch.  chip_smoke.py counts these bytes from each level's inputs, over
// 3.35 TB/s on an H100 SXM.  It does no arithmetic to speak of.  The random
// gathers into the state vectors are what keeps it from that bound; a
// shared-memory pre-merge and vectorized edge loads are later work.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnvisited = 1;
constexpr int kIinf = 1 << 30;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 8 x 256 threads fill an SM's 2048 slots

__global__ void fill_iinf(int* __restrict__ win, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    win[i] = kIinf;
  }
}

template <bool WR>
__global__ void fused_sweep(const int* __restrict__ ecol,
                            const int* __restrict__ cadj,
                            const int* __restrict__ bfs,
                            const int* __restrict__ root,
                            const int* __restrict__ rmatch, int level,
                            int64_t nnz, int nc, int nr,
                            int* __restrict__ win) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    const int c = __ldg(ecol + e);
    if ((unsigned)c > (unsigned)nc) continue;     // out of range: skipped
    if (__ldg(bfs + c) != level) continue;
    if (WR) {
      const int rt = __ldg(root + c);
      if ((unsigned)rt > (unsigned)nc || __ldg(bfs + rt) < kUnvisited) continue;
    }
    const int r = __ldg(cadj + e);
    // sentinel row nr stays IINF; out of range: skipped
    if ((unsigned)r >= (unsigned)nr) continue;
    const int cm = __ldg(rmatch + r);
    const bool propose =
        cm == -1 || (cm >= 0 && __ldg(bfs + min(cm, nc)) == kUnvisited);
    if (propose) atomicMin(win + r, c);
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

// Launch geometry: one block of kThreads per kThreads edge slots, at most
// kBlocksPerSm blocks on each SM of the current device (grid-stride beyond).
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

// K1: win (nr+1,) per-row winners over the CSR edge list.
extern "C" int frontier_expand_fused_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
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
