// Point -> polyline min distance, batched over boundaries: entry [i, j] of
// the (N, C) output is the min over the valid edges of boundary g of the
// distance from point i, where g = sel[i, j] (gathered mode) or g = j
// (dense mode, sel == NULL, C = G).
//
// Replaces the TPU kernel spatialflink_tpu/ops/pallas_kernels.py:
// _min_dist_kernel (driven by point_polyline_min_dist_pallas). There, points
// stream through (64, 128) VMEM tiles and one boundary's edge endpoints are
// SMEM scalars consumed by a fori_loop with a running minimum of d^2, one
// pallas_call per boundary. Here one launch covers a whole evaluation (every
// boundary of a query set, or every point's top-cand candidates), since a
// range query needs the distance to many boundaries, not one.
//
// Inputs: xy (N, 2) f32, verts (G, V, 2) f32 (edge e of boundary g runs from
// vertex e to vertex e + 1), edge_valid (G, V-1) u8, sel (N, C) i32 or NULL.
//
// Design for Hopper. Both modes first build a per-edge table in shared
// memory: for each valid edge x1, y1, abx, aby, len_sq, each field in its
// own array, computed once per block with the same operations as the
// per-pair formula, plus each boundary's count of valid edges. A warp
// stages several boundaries at a time (lane = (boundary, edge), one batch of
// loads) and compacts each one's valid edges with __ballot_sync/__popc, so
// the inner loop runs over valid edges only, with no flag load and no
// branch on one.
//   gathered, staged (the table, 20 B per edge slot and 4 B per boundary,
//     fits in shared memory: 144 KB at 1,000 boundaries of 8 vertices): a
//     grid of the blocks that can be resident builds the table
//     once per block and walks the points with a grid-stride loop, one
//     thread per point for all C slots: the point is read once, sel is
//     read and out written as 16-byte vectors when C % 4 == 0 (scalars
//     otherwise), and four slots' edge loops run interleaved, four
//     independent chains in flight;
//   gathered, unstaged (a set too large for shared memory): one thread per
//     (point, slot) reads its boundary through the read-only cache (__ldg);
//   dense: boundaries on the fast thread axis. A block of 32 x 8 threads
//     takes 32 boundaries (lane = boundary) x 64 points (8 a thread); edges
//     come in tiles of 32 slots per boundary, the table transposed (slot k
//     of lane b at k * 32 + b) so that the lanes hit distinct banks. A
//     warp's store writes one point's 32 consecutive outputs, whole
//     128-byte lines when G % 32 == 0. Any G and any V work.
// Bound on the H100: bytes, at the range path's gathered shape (points,
// sel and output once, edges once: 18.9 MB at N = 262,144, C = 8, ~5.6 us
// at 3.35 TB/s, against ~20 float32 operations for each of the 8.4e6
// valid (point, slot, edge) triples, ~2.5 us at 67 TFLOP/s) and at the
// dense 32-polygon shape (33.5 MB of output, ~10.6 us). What remains above
// the bound is instruction issue: some 30 instructions per (point, edge),
// the correctly rounded division among them, which the kernel skips where
// the clamp decides the result (below) and a warp's lanes all agree.
//
// Arithmetic, operation by operation as the plain PyTorch version
// (ops/distances.py:point_segment_sq_distance, the JAX package's order):
// ap = p - s1, ab = s2 - s1, len_sq = abx*abx + aby*aby, dot = apx*abx +
// apy*aby, param = len_sq > 0 ? dot / len_sq : -1, t = clamp(param, 0, 1),
// d = p - (s1 + t*ab), d2 = dx*dx + dy*dy. The __f*_rn intrinsics (and
// --fmad=false) round each operation once with no contraction. t takes the
// division only where 0 < dot < len_sq: with len_sq > 0, dot <= 0 gives a
// quotient <= 0 and dot >= len_sq one >= 1 (the correctly rounded quotient
// is monotone and 0 and 1 are exact), so the clamp gives 0 or 1 either way;
// a zero t of either sign leaves d2 unchanged. The result is sqrt(min d2)
// with __fsqrt_rn, which equals the min of the correctly rounded roots (the
// root is monotone), capped at FLT_MAX so that a boundary with no valid edge
// gives FLT_MAX, as point_polyline_distance.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kGatherThreads = 1024;
constexpr int kDenseRows = 8;   // warps of a dense block
constexpr int kDensePts = 8;    // points per dense thread
constexpr int kEdgeTile = 32;   // edge slots per boundary in a dense tile
constexpr int kPerWarp = 32 / kDenseRows;  // boundaries a dense warp stages
constexpr int kFields = 5;      // x1, y1, abx, aby, len_sq

__device__ __forceinline__ float edge_d2(float px, float py, float x1,
                                         float y1, float abx, float aby,
                                         float len_sq) {
  const float apx = __fsub_rn(px, x1);
  const float apy = __fsub_rn(py, y1);
  const float dot = __fadd_rn(__fmul_rn(apx, abx), __fmul_rn(apy, aby));
  float t = 0.0f;
  if (len_sq > 0.0f && dot > 0.0f)
    t = dot >= len_sq ? 1.0f : __fdiv_rn(dot, len_sq);
  const float dx = __fsub_rn(px, __fadd_rn(x1, __fmul_rn(t, abx)));
  const float dy = __fsub_rn(py, __fadd_rn(y1, __fmul_rn(t, aby)));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float seg_d2(float px, float py, float2 a,
                                        float2 b) {
  const float abx = __fsub_rn(b.x, a.x);
  const float aby = __fsub_rn(b.y, a.y);
  const float len_sq = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  return edge_d2(px, py, a.x, a.y, abx, aby, len_sq);
}

__device__ __forceinline__ float finish(float min_d2) {
  return fminf(__fsqrt_rn(min_d2), FLT_MAX);
}

// The per-edge table: field f of slot s at tab[f * slots + s].
struct Table {
  float* tab;
  int slots;
  __device__ float field(int f, int s) const { return tab[f * slots + s]; }
};

// Table slot s gets the edge from a to b.
__device__ __forceinline__ void put_edge(const Table& t, int s, float2 a,
                                         float2 b) {
  const float abx = __fsub_rn(b.x, a.x);
  const float aby = __fsub_rn(b.y, a.y);
  t.tab[s] = a.x;
  t.tab[t.slots + s] = a.y;
  t.tab[2 * t.slots + s] = abx;
  t.tab[3 * t.slots + s] = aby;
  t.tab[4 * t.slots + s] = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
}

__global__ void __launch_bounds__(32 * kDenseRows)
    dense_kernel(const float2* __restrict__ xy,
                 const float2* __restrict__ verts,
                 const uint8_t* __restrict__ edge_valid, int n, int g, int v,
                 float* __restrict__ out) {
  __shared__ float s_tab[kFields * kEdgeTile * 32];
  __shared__ int s_cnt[32];
  const Table tab{s_tab, kEdgeTile * 32};
  const int lane = threadIdx.x, row = threadIdx.y;
  const unsigned lower = (1u << lane) - 1u;
  const int b0 = blockIdx.y * 32;
  const int i0 = blockIdx.x * (kDenseRows * kDensePts) + row;
  const int e_total = v - 1;
  float px[kDensePts], py[kDensePts], acc[kDensePts];
#pragma unroll
  for (int r = 0; r < kDensePts; ++r) {
    const int i = i0 + r * kDenseRows;
    const float2 p = i < n ? xy[i] : make_float2(0.0f, 0.0f);
    px[r] = p.x;
    py[r] = p.y;
    acc[r] = INFINITY;
  }
  for (int e0 = 0; e0 < e_total; e0 += kEdgeTile) {
    const int ne = min(kEdgeTile, e_total - e0);
    __syncthreads();  // the previous tile is no longer read
    // Warp `row` stages boundaries row + 8r (lane = edge): every load of the
    // tile first, in one batch, then each boundary's valid edges compacted
    // with a ballot into table column bl.
    float2 a[kPerWarp], q[kPerWarp];
    bool ok[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int b = b0 + row + r * kDenseRows, e = e0 + lane;
      const bool in = b < g && lane < ne;
      ok[r] = in && edge_valid[(size_t)b * e_total + e] != 0;
      a[r] = in ? verts[(size_t)b * v + e] : make_float2(0.0f, 0.0f);
      q[r] = in ? verts[(size_t)b * v + e + 1] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int bl = row + r * kDenseRows;
      const unsigned m = __ballot_sync(kFull, ok[r]);
      if (ok[r]) put_edge(tab, __popc(m & lower) * 32 + bl, a[r], q[r]);
      if (lane == 0) s_cnt[bl] = __popc(m);
    }
    __syncthreads();
    const int k_end = s_cnt[lane];
    for (int k = 0; k < k_end; ++k) {
      const int s = k * 32 + lane;
      const float x1 = tab.field(0, s), y1 = tab.field(1, s);
      const float abx = tab.field(2, s), aby = tab.field(3, s);
      const float len_sq = tab.field(4, s);
#pragma unroll
      for (int r = 0; r < kDensePts; ++r)
        acc[r] = fminf(acc[r], edge_d2(px[r], py[r], x1, y1, abx, aby, len_sq));
    }
  }
  const int b = b0 + lane;
  if (b >= g) return;
#pragma unroll
  for (int r = 0; r < kDensePts; ++r) {
    const int i = i0 + r * kDenseRows;
    if (i < n) out[(size_t)i * g + b] = finish(acc[r]);
  }
}

// Up to four slots of one point at once (boundaries b[0..nq)), their edge
// loops interleaved so that four independent chains are in flight; slot q's
// result goes to out[q].
__device__ __forceinline__ void quad_min(float px, float py, const int* b,
                                         int nq, const Table& tab,
                                         const int* s_cnt, int e_total,
                                         float* out) {
  int base[4], cnt[4];
  float acc[4];
  int k_end = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    base[q] = q < nq ? b[q] * e_total : 0;
    cnt[q] = q < nq ? s_cnt[b[q]] : 0;
    acc[q] = INFINITY;
    k_end = max(k_end, cnt[q]);
  }
  for (int k = 0; k < k_end; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k < cnt[q]) {
        const int s = base[q] + k;
        acc[q] = fminf(acc[q], edge_d2(px, py, tab.field(0, s),
                                       tab.field(1, s), tab.field(2, s),
                                       tab.field(3, s), tab.field(4, s)));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = finish(acc[q]);
}

__global__ void __launch_bounds__(kGatherThreads)
    gather_staged_kernel(const float2* __restrict__ xy,
                         const float2* __restrict__ verts,
                         const uint8_t* __restrict__ edge_valid,
                         const int* __restrict__ sel, int n, int c, int g,
                         int v, bool vec4, float* __restrict__ out) {
  extern __shared__ float s_all[];
  const int e_total = v - 1, slots = g * e_total;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const Table tab{s_all, slots};
  int* s_cnt = reinterpret_cast<int*>(s_all + kFields * slots);
  // A warp stages 32 / seg boundaries at a time, lane = (boundary, edge)
  // with seg the power of two >= e_total, at most 32 (a longer boundary
  // takes seg edges a step): one batch of loads, then each boundary's valid
  // edges compacted with the ballot of its lane segment.
  int seg = 1;
  while (seg < e_total && seg < 32) seg <<= 1;
  const int per = 32 / seg, sub = lane / seg, lane_e = lane - sub * seg;
  const unsigned own = (0xffffffffu >> (32 - seg)) << (sub * seg);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll 2
  for (int b0 = warp * per; b0 < g; b0 += warps * per) {
    const int b = b0 + sub;
    int n_ok = 0;
    for (int e0 = 0; e0 < e_total; e0 += seg) {
      const int e = e0 + lane_e;
      const bool in = b < g && e < e_total;
      const float2* a = verts + (size_t)b * v + e;
      const bool ok = in && edge_valid[(size_t)b * e_total + e] != 0;
      const float2 p0 = in ? a[0] : make_float2(0.0f, 0.0f);
      const float2 p1 = in ? a[1] : make_float2(0.0f, 0.0f);
      const unsigned m = __ballot_sync(kFull, ok) & own;
      if (ok) put_edge(tab, b * e_total + n_ok + __popc(m & lower), p0, p1);
      n_ok += __popc(m);
    }
    if (lane_e == 0 && b < g) s_cnt[b] = n_ok;
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float2 p = xy[i];
    const size_t row = (size_t)i * c;
    if (vec4) {
      const int4* s4 = reinterpret_cast<const int4*>(sel + row);
      float4* o4 = reinterpret_cast<float4*>(out + row);
      for (int j = 0; j < c / 4; ++j) {
        const int4 s = __ldg(s4 + j);
        const int b[4] = {s.x, s.y, s.z, s.w};
        float r[4];
        quad_min(p.x, p.y, b, 4, tab, s_cnt, e_total, r);
        o4[j] = make_float4(r[0], r[1], r[2], r[3]);
      }
    } else {
      for (int j = 0; j < c; j += 4) {
        const int nq = min(4, c - j);
        int b[4];
        float r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = q < nq ? __ldg(sel + row + j + q) : 0;
        quad_min(p.x, p.y, b, nq, tab, s_cnt, e_total, r);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nq) out[row + j + q] = r[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_global_kernel(const float2* __restrict__ xy,
                         const float2* __restrict__ verts,
                         const uint8_t* __restrict__ edge_valid,
                         const int* __restrict__ sel, int n, int c, int v,
                         float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)n * c) return;
  const int e_total = v - 1;
  const int i = (int)(t / c);
  const int b = __ldg(sel + t);
  const float2 p = __ldg(xy + i);
  const float2* bv = verts + (size_t)b * v;
  const uint8_t* bok = edge_valid + (size_t)b * e_total;
  float acc = INFINITY;
  float2 s1 = __ldg(bv);
  for (int k = 0; k < e_total; ++k) {
    const float2 s2 = __ldg(bv + k + 1);
    if (__ldg(bok + k)) acc = fminf(acc, seg_d2(p.x, p.y, s1, s2));
    s1 = s2;
  }
  out[t] = finish(acc);
}

}  // namespace

extern "C" {

// out (N, C) f32. sel == NULL: dense mode, C == G. max_shared: the dynamic
// shared memory a block may use (0 disables staging); sms: the card's
// multiprocessors (the staged grid is the blocks that can be resident).
// Returns cudaGetLastError() after the launch.
int sft_polyline_min_dist(const void* xy, const void* verts,
                          const void* edge_valid, const void* sel, int n,
                          int c, int g, int v, int max_shared, int sms,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(xy);
  const float2* vv = static_cast<const float2*>(verts);
  const uint8_t* ok = static_cast<const uint8_t*>(edge_valid);
  float* o = static_cast<float*>(out);
  if (n <= 0 || c <= 0) return cudaGetLastError();
  if (sel == nullptr) {
    const int pts = kDenseRows * kDensePts;
    dim3 grid((n + pts - 1) / pts, (g + 31) / 32);
    dense_kernel<<<grid, dim3(32, kDenseRows), 0, s>>>(p, vv, ok, n, g, v, o);
    return cudaGetLastError();
  }
  const int* sl = static_cast<const int*>(sel);
  const size_t slots = (size_t)g * (v - 1);
  const size_t smem = kFields * sizeof(float) * slots + sizeof(int) * g;
  if (smem <= (size_t)max_shared) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_staged_kernel, kGatherThreads, smem);
    if (err != cudaSuccess) return err;
    const int need = (n + kGatherThreads - 1) / kGatherThreads;
    const int grid = need < per_sm * sms ? need : per_sm * sms;
    const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(sel) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    gather_staged_kernel<<<grid > 0 ? grid : 1, kGatherThreads, smem, s>>>(
        p, vv, ok, sl, n, c, g, v, vec4, o);
    return cudaGetLastError();
  }
  const size_t items = (size_t)n * c;
  const unsigned grid = (unsigned)((items + kThreads - 1) / kThreads);
  gather_global_kernel<<<grid, kThreads, 0, s>>>(p, vv, ok, sl, n, c, v, o);
  return cudaGetLastError();
}

}  // extern "C"
