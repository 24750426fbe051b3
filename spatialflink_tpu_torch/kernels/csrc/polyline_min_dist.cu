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
// The float64 mode of the port (precision.py: x64 on, dtype float64) takes
// the same kernels instantiated for double (sft_polyline_min_dist_f64): xy
// and verts (.., 2) f64, the output f64, every operation the double
// intrinsic of the float one, and DBL_MAX where the float kernels give
// FLT_MAX, as the JAX package's float64 point_polyline_distance gives
// finfo(float64).max for a boundary with no valid edge. The per-edge table
// doubles: the dense block's static 5 x 32 x 32 slots take 40,960 B of
// shared memory (20,480 B in float), under the 48 KB static limit, and five
// such blocks fit on a multiprocessor by shared memory; the gathered table
// is 40 B per edge slot, so a set of half the size stages.
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
// gives FLT_MAX, as point_polyline_distance. In double: __dsub_rn,
// __dmul_rn, __dadd_rn, __ddiv_rn, __dsqrt_rn and DBL_MAX, through Num<T>.

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

// The scalar type's correctly rounded operations, pair type and cap.
template <typename T>
struct Num;

template <>
struct Num<float> {
  using V2 = float2;
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float root(float a) { return __fsqrt_rn(a); }
  __device__ static float min(float a, float b) { return fminf(a, b); }
  __device__ static float cap(float a) { return fminf(a, FLT_MAX); }
  __device__ static float2 zero2() { return make_float2(0.0f, 0.0f); }
};

template <>
struct Num<double> {
  using V2 = double2;
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double root(double a) { return __dsqrt_rn(a); }
  __device__ static double min(double a, double b) { return fmin(a, b); }
  __device__ static double cap(double a) { return fmin(a, DBL_MAX); }
  __device__ static double2 zero2() { return make_double2(0.0, 0.0); }
};

template <typename T>
__device__ __forceinline__ T edge_d2(T px, T py, T x1, T y1, T abx, T aby,
                                     T len_sq) {
  using N = Num<T>;
  const T apx = N::sub(px, x1);
  const T apy = N::sub(py, y1);
  const T dot = N::add(N::mul(apx, abx), N::mul(apy, aby));
  T t = T(0);
  if (len_sq > T(0) && dot > T(0))
    t = dot >= len_sq ? T(1) : N::div(dot, len_sq);
  const T dx = N::sub(px, N::add(x1, N::mul(t, abx)));
  const T dy = N::sub(py, N::add(y1, N::mul(t, aby)));
  return N::add(N::mul(dx, dx), N::mul(dy, dy));
}

template <typename T, typename V2 = typename Num<T>::V2>
__device__ __forceinline__ T seg_d2(T px, T py, V2 a, V2 b) {
  using N = Num<T>;
  const T abx = N::sub(b.x, a.x);
  const T aby = N::sub(b.y, a.y);
  const T len_sq = N::add(N::mul(abx, abx), N::mul(aby, aby));
  return edge_d2<T>(px, py, a.x, a.y, abx, aby, len_sq);
}

template <typename T>
__device__ __forceinline__ T finish(T min_d2) {
  return Num<T>::cap(Num<T>::root(min_d2));
}

// The per-edge table: field f of slot s at tab[f * slots + s].
template <typename T>
struct Table {
  T* tab;
  int slots;
  __device__ T field(int f, int s) const { return tab[f * slots + s]; }
};

// Table slot s gets the edge from a to b.
template <typename T, typename V2 = typename Num<T>::V2>
__device__ __forceinline__ void put_edge(const Table<T>& t, int s, V2 a,
                                         V2 b) {
  using N = Num<T>;
  const T abx = N::sub(b.x, a.x);
  const T aby = N::sub(b.y, a.y);
  t.tab[s] = a.x;
  t.tab[t.slots + s] = a.y;
  t.tab[2 * t.slots + s] = abx;
  t.tab[3 * t.slots + s] = aby;
  t.tab[4 * t.slots + s] = N::add(N::mul(abx, abx), N::mul(aby, aby));
}

template <typename T, typename V2 = typename Num<T>::V2>
__global__ void __launch_bounds__(32 * kDenseRows)
    dense_kernel(const V2* __restrict__ xy, const V2* __restrict__ verts,
                 const uint8_t* __restrict__ edge_valid, int n, int g, int v,
                 T* __restrict__ out) {
  __shared__ T s_tab[kFields * kEdgeTile * 32];
  __shared__ int s_cnt[32];
  const Table<T> tab{s_tab, kEdgeTile * 32};
  const int lane = threadIdx.x, row = threadIdx.y;
  const unsigned lower = (1u << lane) - 1u;
  const int b0 = blockIdx.y * 32;
  const int i0 = blockIdx.x * (kDenseRows * kDensePts) + row;
  const int e_total = v - 1;
  T px[kDensePts], py[kDensePts], acc[kDensePts];
#pragma unroll
  for (int r = 0; r < kDensePts; ++r) {
    const int i = i0 + r * kDenseRows;
    const V2 p = i < n ? xy[i] : Num<T>::zero2();
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
    V2 a[kPerWarp], q[kPerWarp];
    bool ok[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int b = b0 + row + r * kDenseRows, e = e0 + lane;
      const bool in = b < g && lane < ne;
      ok[r] = in && edge_valid[(size_t)b * e_total + e] != 0;
      a[r] = in ? verts[(size_t)b * v + e] : Num<T>::zero2();
      q[r] = in ? verts[(size_t)b * v + e + 1] : Num<T>::zero2();
    }
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int bl = row + r * kDenseRows;
      const unsigned m = __ballot_sync(kFull, ok[r]);
      if (ok[r]) put_edge<T>(tab, __popc(m & lower) * 32 + bl, a[r], q[r]);
      if (lane == 0) s_cnt[bl] = __popc(m);
    }
    __syncthreads();
    const int k_end = s_cnt[lane];
    for (int k = 0; k < k_end; ++k) {
      const int s = k * 32 + lane;
      const T x1 = tab.field(0, s), y1 = tab.field(1, s);
      const T abx = tab.field(2, s), aby = tab.field(3, s);
      const T len_sq = tab.field(4, s);
#pragma unroll
      for (int r = 0; r < kDensePts; ++r)
        acc[r] = Num<T>::min(acc[r], edge_d2<T>(px[r], py[r], x1, y1, abx,
                                                aby, len_sq));
    }
  }
  const int b = b0 + lane;
  if (b >= g) return;
#pragma unroll
  for (int r = 0; r < kDensePts; ++r) {
    const int i = i0 + r * kDenseRows;
    if (i < n) out[(size_t)i * g + b] = finish<T>(acc[r]);
  }
}

// Up to four slots of one point at once (boundaries b[0..nq)), their edge
// loops interleaved so that four independent chains are in flight; slot q's
// result goes to out[q].
template <typename T>
__device__ __forceinline__ void quad_min(T px, T py, const int* b, int nq,
                                         const Table<T>& tab,
                                         const int* s_cnt, int e_total,
                                         T* out) {
  int base[4], cnt[4];
  T acc[4];
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
        acc[q] = Num<T>::min(acc[q], edge_d2<T>(px, py, tab.field(0, s),
                                                tab.field(1, s),
                                                tab.field(2, s),
                                                tab.field(3, s),
                                                tab.field(4, s)));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = finish<T>(acc[q]);
}

// Four consecutive outputs as 16-byte stores (one float4, or two double2).
__device__ __forceinline__ void store4(float* o, const float* r) {
  *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void store4(double* o, const double* r) {
  double2* o2 = reinterpret_cast<double2*>(o);
  o2[0] = make_double2(r[0], r[1]);
  o2[1] = make_double2(r[2], r[3]);
}

template <typename T, typename V2 = typename Num<T>::V2>
__global__ void __launch_bounds__(kGatherThreads)
    gather_staged_kernel(const V2* __restrict__ xy,
                         const V2* __restrict__ verts,
                         const uint8_t* __restrict__ edge_valid,
                         const int* __restrict__ sel, int n, int c, int g,
                         int v, bool vec4, T* __restrict__ out) {
  // One extern array of bytes for every instantiation (an extern shared
  // array cannot change type between them), cast to the scalar type.
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_all = reinterpret_cast<T*>(s_raw);
  const int e_total = v - 1, slots = g * e_total;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const Table<T> tab{s_all, slots};
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
      const V2* a = verts + (size_t)b * v + e;
      const bool ok = in && edge_valid[(size_t)b * e_total + e] != 0;
      const V2 p0 = in ? a[0] : Num<T>::zero2();
      const V2 p1 = in ? a[1] : Num<T>::zero2();
      const unsigned m = __ballot_sync(kFull, ok) & own;
      if (ok) put_edge<T>(tab, b * e_total + n_ok + __popc(m & lower), p0, p1);
      n_ok += __popc(m);
    }
    if (lane_e == 0 && b < g) s_cnt[b] = n_ok;
  }
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const V2 p = xy[i];
    const size_t row = (size_t)i * c;
    if (vec4) {
      const int4* s4 = reinterpret_cast<const int4*>(sel + row);
      for (int j = 0; j < c / 4; ++j) {
        const int4 s = __ldg(s4 + j);
        const int b[4] = {s.x, s.y, s.z, s.w};
        T r[4];
        quad_min<T>(p.x, p.y, b, 4, tab, s_cnt, e_total, r);
        store4(out + row + 4 * j, r);
      }
    } else {
      for (int j = 0; j < c; j += 4) {
        const int nq = min(4, c - j);
        int b[4];
        T r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = q < nq ? __ldg(sel + row + j + q) : 0;
        quad_min<T>(p.x, p.y, b, nq, tab, s_cnt, e_total, r);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nq) out[row + j + q] = r[q];
      }
    }
  }
}

template <typename T, typename V2 = typename Num<T>::V2>
__global__ void __launch_bounds__(kThreads)
    gather_global_kernel(const V2* __restrict__ xy,
                         const V2* __restrict__ verts,
                         const uint8_t* __restrict__ edge_valid,
                         const int* __restrict__ sel, int n, int c, int v,
                         T* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)n * c) return;
  const int e_total = v - 1;
  const int i = (int)(t / c);
  const int b = __ldg(sel + t);
  const V2 p = __ldg(xy + i);
  const V2* bv = verts + (size_t)b * v;
  const uint8_t* bok = edge_valid + (size_t)b * e_total;
  T acc = INFINITY;
  V2 s1 = __ldg(bv);
  for (int k = 0; k < e_total; ++k) {
    const V2 s2 = __ldg(bv + k + 1);
    if (__ldg(bok + k)) acc = Num<T>::min(acc, seg_d2<T>(p.x, p.y, s1, s2));
    s1 = s2;
  }
  out[t] = finish<T>(acc);
}

template <typename T>
int launch(const void* xy, const void* verts, const void* edge_valid,
           const void* sel, int n, int c, int g, int v, int max_shared,
           int sms, void* out, void* stream) {
  using V2 = typename Num<T>::V2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V2* p = static_cast<const V2*>(xy);
  const V2* vv = static_cast<const V2*>(verts);
  const uint8_t* ok = static_cast<const uint8_t*>(edge_valid);
  T* o = static_cast<T*>(out);
  if (n <= 0 || c <= 0) return cudaGetLastError();
  if (sel == nullptr) {
    const int pts = kDenseRows * kDensePts;
    dim3 grid((n + pts - 1) / pts, (g + 31) / 32);
    dense_kernel<T><<<grid, dim3(32, kDenseRows), 0, s>>>(p, vv, ok, n, g, v,
                                                          o);
    return cudaGetLastError();
  }
  const int* sl = static_cast<const int*>(sel);
  const size_t slots = (size_t)g * (v - 1);
  const size_t smem = kFields * sizeof(T) * slots + sizeof(int) * g;
  if (smem <= (size_t)max_shared) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_staged_kernel<T>, kGatherThreads, smem);
    if (err != cudaSuccess) return err;
    const int need = (n + kGatherThreads - 1) / kGatherThreads;
    const int grid = need < per_sm * sms ? need : per_sm * sms;
    const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(sel) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
    gather_staged_kernel<T><<<grid > 0 ? grid : 1, kGatherThreads, smem, s>>>(
        p, vv, ok, sl, n, c, g, v, vec4, o);
    return cudaGetLastError();
  }
  const size_t items = (size_t)n * c;
  const unsigned grid = (unsigned)((items + kThreads - 1) / kThreads);
  gather_global_kernel<T><<<grid, kThreads, 0, s>>>(p, vv, ok, sl, n, c, v, o);
  return cudaGetLastError();
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
  return launch<float>(xy, verts, edge_valid, sel, n, c, g, v, max_shared,
                       sms, out, stream);
}

// The same in float64: xy (N, 2) f64, verts (G, V, 2) f64, out (N, C) f64,
// xy and verts 16-byte aligned (double2 loads).
int sft_polyline_min_dist_f64(const void* xy, const void* verts,
                              const void* edge_valid, const void* sel, int n,
                              int c, int g, int v, int max_shared, int sms,
                              void* out, void* stream) {
  return launch<double>(xy, verts, edge_valid, sel, n, c, g, v, max_shared,
                        sms, out, stream);
}

}  // extern "C"
