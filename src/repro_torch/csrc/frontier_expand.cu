// Fused frontier sweep for Hopper (sm_90a): one BFS level of the paper's
// GPUBFS / GPUBFS-WR (Alg. 2 / Alg. 4), proposals and per-row winner merge
// in one pass.
//
// Replaces the TPU kernels of repro/kernels/frontier_expand/frontier_expand.py:
// frontier_expand_fused -> _kernel_fused_wr (WR = true) and
// _kernel_fused_plain (WR = false), both merging through _merge_tile.
//
// Contract (identical to the TPU kernel's): win is the (nr+1,) int32 vector
// holding, for each row r, the lowest column c of an edge (c, r) such that
//   bfs[c] == level                      (WR also: bfs[root[c]] >= UNVISITED)
//   and (rmatch[r] == -1 or (rmatch[r] >= 0 and bfs[rmatch[r]] == UNVISITED)),
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
// Out-of-range input.  An edge slot whose column is outside [0, nc] or whose
// row is outside [0, nr), and a column whose root is outside [0, nc], are
// skipped (unsigned compares cost nothing), so a malformed graph or state
// cannot make the kernel read or write out of bounds.  The plain version
// (kernels/frontier_expand/ref.py) skips the same slots.
//
// Bound: bytes, and how many depends on the level.  A call must read ecol
// (4 * nnz_pad) and bfs (4(nc+1)) whole and write win (4(nr+1)); cadj only
// for the edges whose column is on the frontier (WR: and whose root is
// alive), root and rmatch once for each distinct column and row those edges
// touch.  chip_smoke.py counts these bytes from each level's inputs, over
// 3.35 TB/s on an H100 SXM.  It does no arithmetic to speak of.  The random
// gathers into the state vectors are what keeps it from that bound; a
// shared-memory pre-merge and vectorized edge loads are later work.
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

}  // namespace

// Launch the sweep on `stream` of the current device.  `root` may be null
// (the plain body).  Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int frontier_expand_fused_launch(
    const int* ecol, const int* cadj, const int* bfs, const int* root,
    const int* rmatch, int level, long long nnz, int nc, int nr, int* win,
    void* stream) {
  int device = 0, sm_count = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int max_blocks = (sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  const int nwin = nr + 1;
  int fill_blocks = (nwin + kThreads - 1) / kThreads;
  if (fill_blocks > max_blocks) fill_blocks = max_blocks;
  fill_iinf<<<fill_blocks, kThreads, 0, s>>>(win, nwin);
  if (nnz > 0) {
    long long want = (nnz + kThreads - 1) / kThreads;
    const int blocks = (int)(want < max_blocks ? want : max_blocks);
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
