// Grid-hash join extraction: the pairs within the radius between each left
// bucket and its (2L+1)^2 neighbour right buckets, in a fixed order.
//
// Replaces the TPU kernel spatialflink_tpu/ops/pallas_join.py:_extract_kernel
// (driven by join_window_pallas). There, one grid step walks one row of left
// cells; per cell the (2L+1)^2 right neighbour buckets are concatenated into
// one (cap_left, k_cand) candidate block, the pair mask d2 <= r2 is
// evaluated on the vector unit, and an argmin loop peels the hits off one at
// a time, in ascending code order, into VMEM-resident (max_pairs,) outputs.
//
// Output order (kept, so the result is deterministic and equal array for
// array to the TPU kernel's): cells in row-major (i, j) order; within a cell,
// hits ascending by code = l_lane * k_cand + c, where the candidate index
// c = ((dx+L)*span + (dy+L)) * cap_right + r_lane and k_cand = span^2 *
// cap_right.
//
// Design for Hopper. The TPU's sequential grid carried one output cursor from
// cell to cell; CTAs run in no order, so the cursor becomes a scan:
//   1. count_hits: one CTA per cell stages the cell's cap_left left slots and
//      its k_cand right candidates in shared memory (12*(cap_left + k_cand)
//      bytes, 5,760 B at cap 48, L = 1) and counts the cell's hits;
//   2. scan_counts: one CTA scans the grid_n^2 counts exclusively into
//      per-cell output offsets; the total is the true pair count, returned
//      even when it exceeds max_pairs (the caller's retry signal);
//   3. pad_tail: slots from the total to max_pairs get -1, -1, +inf;
//   4. extract_hits: one CTA per cell re-tests its pairs in code order, a
//      block-wide chunk at a time, and ranks each hit with a block prefix
//      (warp __ballot_sync + __popc, warp sums in shared memory); a hit goes
//      to offset + rank when that is below max_pairs.
// No atomics decide the order, so two runs give the same arrays. A left slot
// that is empty has no hit, so its whole candidate row is skipped, and a CTA
// whose cell has no hit (or starts past max_pairs) returns at once.
//
// Arithmetic, operation by operation as the TPU kernel: ddx = lx - rx,
// ddy = ly - ry, d2 = ddx*ddx + ddy*ddy, r2 = r*r (r = +inf in approximate
// mode), hit = lidx >= 0 && ridx >= 0 && d2 <= r2, dist = sqrt(d2). The
// __f*_rn intrinsics (and --fmad=false) round each operation once with no
// contraction, so the kernel is bit-equal to the plain PyTorch version in
// ops/join_kernel.py.
//
// Bound on the H100 at the full join shape (grid 100, cap 48, L = 1, two
// 131,072-point sides): bytes. ~11.8 MB of planes in and 3.1 MB of pairs out
// take ~4.4 us at 3.35 TB/s; the data's ~2e7 candidate pairs at ~6 float32
// operations each take ~2 us at 67 TFLOP/s. The kernel tests every slot pair
// of a non-empty cell (2.07e8 at cap 48), twice, so it sits well above the
// bound: a first port, right first and fast later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// Dynamic shared memory above this needs the opt-in attribute (the default
// limit is 48 KB per block, static shared memory included).
constexpr size_t kDefaultShared = 32 * 1024;

struct Cell {
  const float* lx;
  const float* ly;
  const int* li;
  const float* rx;
  const float* ry;
  const int* ri;
};

// Stage cell `cell`'s left slots and right candidates into shared memory.
// Returns whether any left slot is live (uniform across the block).
__device__ bool stage(const float* __restrict__ lx, const float* __restrict__ ly,
                      const int* __restrict__ lidx,
                      const float* __restrict__ rxp,
                      const float* __restrict__ ryp,
                      const int* __restrict__ ridxp, int grid_n, int layers,
                      int cap_l, int cap_r, int cell, Cell* s) {
  extern __shared__ float smem[];
  const int span = 2 * layers + 1;
  const int k_cand = span * span * cap_r;
  const int gp = grid_n + 2 * layers;
  float* s_lx = smem;
  float* s_ly = s_lx + cap_l;
  int* s_li = reinterpret_cast<int*>(s_ly + cap_l);
  float* s_rx = reinterpret_cast<float*>(s_li + cap_l);
  float* s_ry = s_rx + k_cand;
  int* s_ri = reinterpret_cast<int*>(s_ry + k_cand);

  const size_t lbase = (size_t)cell * cap_l;
  int live = 0;
  for (int t = threadIdx.x; t < cap_l; t += blockDim.x) {
    s_lx[t] = lx[lbase + t];
    s_ly[t] = ly[lbase + t];
    int v = lidx[lbase + t];
    s_li[t] = v;
    live |= v >= 0;
  }
  if (!__syncthreads_or(live)) return false;

  const int i = cell / grid_n, j = cell % grid_n;
  for (int c = threadIdx.x; c < k_cand; c += blockDim.x) {
    const int nb = c / cap_r, lane = c - nb * cap_r;
    const int di = nb / span, dj = nb - di * span;
    // Padded plane row i + L + dx = i + di, column j + L + dy = j + dj.
    const size_t src = ((size_t)(i + di) * gp + (j + dj)) * cap_r + lane;
    s_rx[c] = rxp[src];
    s_ry[c] = ryp[src];
    s_ri[c] = ridxp[src];
  }
  __syncthreads();
  *s = Cell{s_lx, s_ly, s_li, s_rx, s_ry, s_ri};
  return true;
}

__device__ __forceinline__ bool pair_hit(const Cell& s, int l, int c, float r2,
                                         float* d2_out) {
  const float ddx = __fsub_rn(s.lx[l], s.rx[c]);
  const float ddy = __fsub_rn(s.ly[l], s.ry[c]);
  const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  *d2_out = d2;
  return s.ri[c] >= 0 && d2 <= r2;
}

__global__ void __launch_bounds__(kThreads)
count_hits(const float* __restrict__ lx, const float* __restrict__ ly,
           const int* __restrict__ lidx, const float* __restrict__ rxp,
           const float* __restrict__ ryp, const int* __restrict__ ridxp,
           int grid_n, int layers, int cap_l, int cap_r, float radius,
           int* __restrict__ cell_counts) {
  __shared__ int s_warp[kWarps];
  const int cell = blockIdx.x;
  Cell s;
  if (!stage(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers, cap_l, cap_r,
             cell, &s)) {
    if (threadIdx.x == 0) cell_counts[cell] = 0;
    return;
  }
  const float r2 = __fmul_rn(radius, radius);
  const int span = 2 * layers + 1;
  const int k_cand = span * span * cap_r;
  int hits = 0;
  for (int l = 0; l < cap_l; ++l) {
    if (s.li[l] < 0) continue;  // an empty left slot has no hit
    for (int c = threadIdx.x; c < k_cand; c += blockDim.x) {
      float d2;
      hits += pair_hit(s, l, c, r2, &d2);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    cell_counts[cell] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_counts(const int* __restrict__ cell_counts, int ncell,
            int* __restrict__ cell_offsets, int* __restrict__ total) {
  __shared__ int s[kScanThreads];
  const int per = (ncell + kScanThreads - 1) / kScanThreads;
  const int lo = min(ncell, (int)threadIdx.x * per);
  const int hi = min(ncell, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += cell_counts[k];
  s[threadIdx.x] = sum;
  __syncthreads();
  // Inclusive Hillis-Steele scan of the per-thread sums.
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  int run = s[threadIdx.x] - sum;
  for (int k = lo; k < hi; ++k) {
    cell_offsets[k] = run;
    run += cell_counts[k];
  }
  if (threadIdx.x == kScanThreads - 1) *total = s[threadIdx.x];
}

__global__ void pad_tail(const int* __restrict__ total, int max_pairs,
                         int* __restrict__ outl, int* __restrict__ outr,
                         float* __restrict__ outd) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < max_pairs && p >= *total) {
    outl[p] = -1;
    outr[p] = -1;
    outd[p] = INFINITY;
  }
}

__global__ void __launch_bounds__(kThreads)
extract_hits(const float* __restrict__ lx, const float* __restrict__ ly,
             const int* __restrict__ lidx, const float* __restrict__ rxp,
             const float* __restrict__ ryp, const int* __restrict__ ridxp,
             int grid_n, int layers, int cap_l, int cap_r, float radius,
             const int* __restrict__ cell_counts,
             const int* __restrict__ cell_offsets, int max_pairs,
             int* __restrict__ outl, int* __restrict__ outr,
             float* __restrict__ outd) {
  __shared__ int s_warp[kWarps];
  const int cell = blockIdx.x;
  const int base = cell_offsets[cell];
  if (cell_counts[cell] == 0 || base >= max_pairs) return;  // uniform
  Cell s;
  if (!stage(lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers, cap_l, cap_r,
             cell, &s))
    return;
  const float r2 = __fmul_rn(radius, radius);
  const int span = 2 * layers + 1;
  const int k_cand = span * span * cap_r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int running = 0;  // hits of this cell already ranked
  for (int l = 0; l < cap_l; ++l) {
    if (s.li[l] < 0) continue;  // uniform: the slot lies in shared memory
    const int left = s.li[l];
    for (int c0 = 0; c0 < k_cand; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      float d2 = 0.0f;
      const bool hit = c < k_cand && pair_hit(s, l, c, r2, &d2);
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, chunk = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int v = s_warp[w];
        before += w < warp ? v : 0;
        chunk += v;
      }
      if (hit) {
        const int pos = base + running + before + __popc(ballot & lower);
        if (pos < max_pairs) {
          outl[pos] = left;
          outr[pos] = s.ri[c];
          outd[pos] = __fsqrt_rn(d2);
        }
      }
      running += chunk;
      __syncthreads();  // s_warp is rewritten by the next chunk
    }
  }
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

// lx, ly, lidx: (grid_n, grid_n, cap_l) left planes (f32, f32, i32).
// rxp, ryp, ridxp: (grid_n + 2L, grid_n + 2L, cap_r) right planes, padded by
// L rows and columns on each side with idx -1. All contiguous.
// cell_counts, cell_offsets: (grid_n^2,) i32 scratch. count: one i32, the
// true pair count. outl, outr, outd: (max_pairs,) outputs.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int sft_join_extract(const float* lx, const float* ly,
                                const int* lidx, const float* rxp,
                                const float* ryp, const int* ridxp, int grid_n,
                                int layers, int cap_l, int cap_r, float radius,
                                int max_pairs, int* cell_counts,
                                int* cell_offsets, int* count, int* outl,
                                int* outr, float* outd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = 2 * layers + 1;
  const int ncell = grid_n * grid_n;
  const size_t smem = 12 * ((size_t)cap_l + (size_t)span * span * cap_r);
  if (smem > kDefaultShared) {
    cudaError_t e = cudaFuncSetAttribute(
        count_hits, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(extract_hits,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  count_hits<<<ncell, kThreads, smem, st>>>(lx, ly, lidx, rxp, ryp, ridxp,
                                            grid_n, layers, cap_l, cap_r,
                                            radius, cell_counts);
  scan_counts<<<1, kScanThreads, 0, st>>>(cell_counts, ncell, cell_offsets,
                                          count);
  if (max_pairs > 0) {
    pad_tail<<<blocks_for(max_pairs, kThreads), kThreads, 0, st>>>(
        count, max_pairs, outl, outr, outd);
  }
  extract_hits<<<ncell, kThreads, smem, st>>>(
      lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers, cap_l, cap_r, radius,
      cell_counts, cell_offsets, max_pairs, outl, outr, outd);
  return (int)cudaGetLastError();
}
