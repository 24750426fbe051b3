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
// Design for Hopper: one ordered pass, one warp per cell, four cells to a
// 128-thread block. The TPU's sequential grid carried one output cursor from
// cell to cell; here the cursor is a single-pass scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", the design of CUB's device scan):
//   1. each warp takes its cell from an atomic ticket, so cells start in
//      row-major order and a warp only ever waits on cells whose warps are
//      already running (forward progress without relying on block order);
//   2. it stages the cell's live left slots and live right candidates in its
//      own shared memory: the index and coordinates of every slot in one
//      batch of independent loads, then the live ones compacted in order
//      with __ballot_sync/__popc, so compacted order is code order (live
//      slots need not form a prefix of the bucket);
//   3. it tests live x live pairs only, a chunk of 32 candidates (one a
//      lane) against each live left slot, keeps each (slot, chunk) ballot
//      as a hit mask, and publishes the cell's count in its 64-bit status
//      word (flag and value in one store);
//   4. it looks back over its predecessors 32 at a time with the whole warp,
//      summing their counts until it meets an inclusive prefix, and
//      publishes its own inclusive prefix; the last cell's is `count`, the
//      true total even past max_pairs (the caller's retry signal);
//   5. it walks the nonzero hit masks in code order and writes each hit at
//      offset + rank (popcount of the mask below the lane) while that is
//      below max_pairs.
// No block barrier anywhere. The status words and the ticket are zeroed by
// one cudaMemsetAsync; a second kernel fills slots count..max_pairs with
// -1, -1, +inf, reading count on the device. Two kernel launches a call, no
// host synchronisation, and no atomics decide the order: two runs give the
// same arrays.
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
// take ~4.4 us at 3.35 TB/s; the data's ~2e7 candidate pair tests at ~6
// float32 operations each take ~2 us at 67 TFLOP/s. The kernel tests only
// live x live pairs (~1,550 a cell there, against 20,736 slot pairs) once,
// and writes from the kept masks. What keeps it above the bound is latency:
// a cell's warp stages, counts and then waits for its predecessors' counts,
// and the 8.4 KB of shared memory a warp takes (candidates and masks) keeps
// 24 warps resident per multiprocessor, so the 10,000 cells run in about
// three waves.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // cells per block, one warp each
constexpr int kTailThreads = 256;
constexpr int kTailBlocks = 1024;
constexpr int kGroup = 16;  // chunks of 32 slots staged in one batch of loads
// Shared memory a block may take (the H100's 232,448 B opt-in, less 1 KB).
constexpr size_t kMaxShared = 232448 - 1024;
constexpr size_t kDefaultShared = 48 * 1024;

// Status word of a cell: flag in bits 32-33, value in bits 0-31.
constexpr unsigned long long kAggregate = 1ull << 32;  // value: the cell's hits
constexpr unsigned long long kPrefix = 2ull << 32;     // value: inclusive prefix

// A status word carries its whole message (flag and value in one 64-bit
// access) and guards no other data, so device-scope relaxed accesses (one
// atomic access each, seen by every multiprocessor) are enough.
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Shared memory of one warp: right (x, y) then left (x, y) as float2, right
// and left indices, then one 32-bit hit mask per (live left slot, chunk of
// 32 live candidates); rounded up to 16 B so every warp's float2s align.
__host__ __device__ inline size_t warp_bytes(int cap_l, int k_cand) {
  const size_t b = 12 * ((size_t)cap_l + (size_t)k_cand) +
                   4 * (size_t)cap_l * ((k_cand + 31) / 32);
  return (b + 15) & ~(size_t)15;
}

// Walks a cell's candidates c = lane, lane + 32, ... in order and gives the
// offset of each in the padded right planes without a division a step:
// bucket nb = c / cap_r is neighbour (dx, dy) = (nb / span - L,
// nb % span - L), at padded row i + L + dx, column j + L + dy.
struct CandWalk {
  int t, di, dj;  // slot in the bucket, bucket row and column
  int row0, gp_cap, cap_r, span;
  __device__ CandWalk(int c, int i, int j, int gp, int cap_r_, int span_)
      : row0((i * gp + j) * cap_r_), gp_cap(gp * cap_r_), cap_r(cap_r_),
        span(span_) {
    const int nb = c / cap_r;
    t = c - nb * cap_r;
    di = nb / span;
    dj = nb - di * span;
  }
  __device__ int offset() const { return row0 + di * gp_cap + dj * cap_r + t; }
  __device__ void advance() {
    for (t += 32; t >= cap_r; t -= cap_r) {
      if (++dj == span) {
        dj = 0;
        ++di;
      }
    }
  }
};

// Walks a cell's left slots t = lane, lane + 32, ... (offset lbase + t).
struct LeftWalk {
  int at;
  __device__ explicit LeftWalk(int lbase) : at(lbase + (threadIdx.x & 31)) {}
  __device__ int offset() const { return at; }
  __device__ void advance() { at += 32; }
};

// The warp stages the live slots among n (plane offsets given by walk, in
// order): their (x, y) to s_xy and their index to s_idx, compacted in slot
// order. Returns how many (the same in every lane).
template <typename Walk>
__device__ int stage_live(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const int* __restrict__ idx, int n, Walk walk,
                          float2* s_xy, int* s_idx) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int live = 0;
  for (int g0 = 0; g0 < n; g0 += 32 * kGroup) {
    int v[kGroup];
    float2 p[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k, walk.advance()) {
      const bool in = g0 + 32 * k + lane < n;
      const int o = walk.offset();
      v[k] = in ? idx[o] : -1;
      p[k] = in ? make_float2(x[o], y[o]) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (g0 + 32 * k >= n) break;
      const unsigned m = __ballot_sync(kFull, v[k] >= 0);
      if (v[k] >= 0) {
        const int at = live + __popc(m & lower);
        s_xy[at] = p[k];
        s_idx[at] = v[k];
      }
      live += __popc(m);
    }
  }
  return live;
}

__device__ __forceinline__ float pair_d2(float2 a, float2 b) {
  const float ddx = __fsub_rn(a.x, b.x);
  const float ddy = __fsub_rn(a.y, b.y);
  return __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
}

// The whole warp sums the status words of cells end, end - 1, ..., nearest
// first, 32 a round (one a lane), and stops at the nearest inclusive prefix,
// which it includes; before cell 0 lies an inclusive prefix of 0. A round
// waits while a cell before its nearest prefix has not counted yet, backing
// off so that waiting warps do not crowd the memory system.
__device__ unsigned sum_back(const unsigned long long* status, int end) {
  const int lane = threadIdx.x & 31;
  unsigned total = 0;
  for (;; end -= 32) {
    const int k = end - lane;  // lane 0: the nearest
    unsigned long long v;
    unsigned upto, prefix;
    for (int ns = 32;; ns = min(2 * ns, 512)) {
      v = k >= 0 ? peek(&status[k]) : kPrefix;
      prefix = __ballot_sync(kFull, (v >> 32) == 2);
      upto = prefix ? __ffs(prefix) - 1 : 31;
      const unsigned waiting = __ballot_sync(kFull, (v >> 32) == 0);
      if (!(waiting & (0xffffffffu >> (31 - upto)))) break;
      __nanosleep(ns);
    }
    total += __reduce_add_sync(
        kFull, lane <= (int)upto ? (unsigned)(v & 0xffffffffu) : 0u);
    if (prefix) return total;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    join_pass(const float* __restrict__ lx, const float* __restrict__ ly,
              const int* __restrict__ lidx, const float* __restrict__ rxp,
              const float* __restrict__ ryp, const int* __restrict__ ridxp,
              int grid_n, int layers, int cap_l, int cap_r, float radius,
              int max_pairs, unsigned int* __restrict__ ticket,
              unsigned long long* __restrict__ status, int* __restrict__ count,
              int* __restrict__ outl, int* __restrict__ outr,
              float* __restrict__ outd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int span = 2 * layers + 1;
  const int k_cand = span * span * cap_r;
  const int ncell = grid_n * grid_n;

  int cell = 0;
  if (lane == 0) cell = (int)atomicAdd(ticket, 1u);
  cell = __shfl_sync(kFull, cell, 0);
  if (cell >= ncell) return;  // uniform: the grid rounds up to whole blocks

  unsigned char* mine = smem + warp * warp_bytes(cap_l, k_cand);
  float2* s_r = reinterpret_cast<float2*>(mine);
  float2* s_l = s_r + k_cand;
  int* s_ri = reinterpret_cast<int*>(s_l + cap_l);
  int* s_li = s_ri + k_cand;
  unsigned* s_m = reinterpret_cast<unsigned*>(s_li + cap_l);

  // Staging: one batch of independent loads (index and coordinates of
  // every slot, up to kGroup chunks of 32 at a time), not a chain of
  // dependent ones; then the live slots are compacted, in order, with a
  // ballot straight from the registers. Left slots first, then the
  // candidates of the neighbour buckets.
  const int lbase = cell * cap_l;
  const int i = cell / grid_n, j = cell - i * grid_n;
  const int nl = stage_live(lx, ly, lidx, cap_l, LeftWalk{lbase}, s_l, s_li);
  const int nr = stage_live(rxp, ryp, ridxp, k_cand,
                            CandWalk(lane, i, j, grid_n + 2 * layers, cap_r,
                                     span),
                            s_r, s_ri);
  __syncwarp();

  // Count: live x live pairs, a chunk of 32 candidates (one a lane, NaN
  // past the last: never a hit) against each live left slot. The ballot of
  // (slot l, chunk k) is kept: lane l % 32 holds it, then stores it.
  const float r2 = __fmul_rn(radius, radius);
  const int nch = nl > 0 ? (nr + 31) / 32 : 0;
  unsigned lane_hits = 0;
  for (int k = 0; k < nch; ++k) {
    const int c = k * 32 + lane;
    const float2 b = c < nr ? s_r[c] : make_float2(NAN, NAN);
    for (int l0 = 0; l0 < nl; l0 += 32) {
      const int l1 = min(nl, l0 + 32);
      unsigned held = 0;
#pragma unroll 4
      for (int l = l0; l < l1; ++l) {
        const unsigned m = __ballot_sync(kFull, pair_d2(s_l[l], b) <= r2);
        held = lane == l - l0 ? m : held;
      }
      if (l0 + lane < l1) s_m[(l0 + lane) * nch + k] = held;
      lane_hits += __popc(held);
    }
  }
  const int hits = (int)__reduce_add_sync(kFull, lane_hits);

  // Look back: the hits of every cell before this one.
  int before = 0;
  if (cell == 0) {
    if (lane == 0) publish(&status[0], kPrefix | (unsigned)hits);
  } else {
    if (lane == 0) publish(&status[cell], kAggregate | (unsigned)hits);
    before = (int)sum_back(status, cell - 1);
    if (lane == 0) publish(&status[cell], kPrefix | (unsigned)(before + hits));
  }
  if (cell == ncell - 1 && lane == 0) *count = before + hits;

  // Extract: the kept masks in code order (slot-major, then chunk), 32 at a
  // time, skipping empty ones; each hit goes to before + its rank.
  if (hits == 0 || before >= max_pairs) return;
  __syncwarp();  // the masks written by lane 0 are visible
  int run = before;
  const int nm = nl * nch;
  for (int m0 = 0; m0 < nm && run < max_pairs; m0 += 32) {
    const unsigned mine_m = m0 + lane < nm ? s_m[m0 + lane] : 0u;
    for (unsigned nz = __ballot_sync(kFull, mine_m != 0);
         nz && run < max_pairs; nz &= nz - 1) {
      const int src = __ffs(nz) - 1;
      const unsigned m = __shfl_sync(kFull, mine_m, src);
      const int l = (m0 + src) / nch, c = (m0 + src - l * nch) * 32 + lane;
      const int pos = run + __popc(m & lower);
      if ((m >> lane & 1u) && pos < max_pairs) {
        outl[pos] = s_li[l];
        outr[pos] = s_ri[c];
        outd[pos] = __fsqrt_rn(pair_d2(s_l[l], s_r[c]));
      }
      run += __popc(m);
    }
  }
}

__global__ void __launch_bounds__(kTailThreads)
    pad_tail(const int* __restrict__ count, int max_pairs,
             int* __restrict__ outl, int* __restrict__ outr,
             float* __restrict__ outd) {
  const int total = *count;
  if (total >= max_pairs) return;
  for (int p = total + blockIdx.x * blockDim.x + threadIdx.x; p < max_pairs;
       p += gridDim.x * blockDim.x) {
    outl[p] = -1;
    outr[p] = -1;
    outd[p] = INFINITY;
  }
}

}  // namespace

// lx, ly, lidx: (grid_n, grid_n, cap_l) left planes (f32, f32, i32).
// rxp, ryp, ridxp: (grid_n + 2L, grid_n + 2L, cap_r) right planes, padded by
// L rows and columns on each side with idx -1. All contiguous, grid_n >= 1.
// scratch: grid_n^2 + 1 u64 (the cells' status words, then the ticket),
// zeroed here.
// count: one i32, the true pair count. outl, outr, outd: (max_pairs,).
// Launches on `stream`, does not synchronise, returns the first CUDA error.
extern "C" int sft_join_extract(const float* lx, const float* ly,
                                const int* lidx, const float* rxp,
                                const float* ryp, const int* ridxp, int grid_n,
                                int layers, int cap_l, int cap_r, float radius,
                                int max_pairs, void* scratch, int* count,
                                int* outl, int* outr, float* outd,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = 2 * layers + 1;
  const int ncell = grid_n * grid_n;
  const size_t per_warp = warp_bytes(cap_l, span * span * cap_r);
  if (ncell < 1 || per_warp > kMaxShared) return (int)cudaErrorInvalidValue;
  const int warps = (int)std::min<size_t>(kWarpsPerBlock, kMaxShared / per_warp);
  const size_t smem = warps * per_warp;
  if (smem > kDefaultShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        join_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status + ncell);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, ((size_t)ncell + 1) * sizeof(*status), st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (ncell + warps - 1) / warps;
  join_pass<<<blocks, warps * 32, smem, st>>>(
      lx, ly, lidx, rxp, ryp, ridxp, grid_n, layers, cap_l, cap_r, radius,
      max_pairs, ticket, status, count, outl, outr, outd);
  if (max_pairs > 0) {
    const int need = (max_pairs + kTailThreads - 1) / kTailThreads;
    pad_tail<<<std::min(need, kTailBlocks), kTailThreads, 0, st>>>(
        count, max_pairs, outl, outr, outd);
  }
  return (int)cudaGetLastError();
}
