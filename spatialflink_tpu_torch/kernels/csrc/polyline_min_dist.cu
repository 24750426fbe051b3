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
// Design for Hopper, one thread per (point, slot):
//   dense: grid (ceil(N / 256), G); blockIdx.y picks the boundary, whose
//     vertices and edge flags are staged in shared memory in tiles of
//     kTile edges, so any V works; each thread keeps its running min in a
//     register. Output writes are strided by C (row-major (N, C)).
//   gathered, staged: when the whole query set (G*V*8 + G*(V-1) bytes,
//     71 KB at 1,000 boundaries of 8 vertices) fits in shared memory, a
//     grid of a few blocks per SM stages it once per block and walks the
//     N*C items with a grid-stride loop (consecutive threads, consecutive
//     outputs);
//   gathered, unstaged: otherwise each thread reads its boundary through
//     the read-only cache (__ldg).
// Bound on the H100: bytes, at the range path's gathered shape (points,
// sel and output once, edges once: 18.9 MB at N = 262,144, C = 8, ~5.6 us
// at 3.35 TB/s, against ~20 float32 operations for each of the 8.4e6
// valid (point, slot, edge) triples, ~2.5 us at 67 TFLOP/s) and at the
// dense 32-polygon shape (33.5 MB of output).
//
// Arithmetic, operation by operation as the plain PyTorch version
// (ops/distances.py:point_segment_sq_distance, the JAX package's order):
// ap = p - s1, ab = s2 - s1, len_sq = abx*abx + aby*aby, dot = apx*abx +
// apy*aby, param = len_sq > 0 ? dot / len_sq : -1, t = clamp(param, 0, 1),
// d = p - (s1 + t*ab), d2 = dx*dx + dy*dy. The __f*_rn intrinsics (and
// --fmad=false) round each operation once with no contraction. The result
// is sqrt(min d2) with __fsqrt_rn, which equals the min of the correctly
// rounded roots (the root is monotone), capped at FLT_MAX so that a
// boundary with no valid edge gives FLT_MAX, as point_polyline_distance.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGatherThreads = 1024;
constexpr int kTile = 1024;  // edges of one dense-mode shared-memory tile

__device__ __forceinline__ float seg_d2(float px, float py, float x1, float y1,
                                        float x2, float y2) {
  const float apx = __fsub_rn(px, x1);
  const float apy = __fsub_rn(py, y1);
  const float abx = __fsub_rn(x2, x1);
  const float aby = __fsub_rn(y2, y1);
  const float len_sq = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  const float dot = __fadd_rn(__fmul_rn(apx, abx), __fmul_rn(apy, aby));
  const float param = len_sq > 0.0f ? __fdiv_rn(dot, len_sq) : -1.0f;
  const float t = fminf(fmaxf(param, 0.0f), 1.0f);
  const float dx = __fsub_rn(px, __fadd_rn(x1, __fmul_rn(t, abx)));
  const float dy = __fsub_rn(py, __fadd_rn(y1, __fmul_rn(t, aby)));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float finish(float min_d2) {
  return fminf(__fsqrt_rn(min_d2), FLT_MAX);
}

__global__ void __launch_bounds__(kThreads)
    dense_kernel(const float2* __restrict__ xy,
                 const float2* __restrict__ verts,
                 const uint8_t* __restrict__ edge_valid, int n, int g, int v,
                 float* __restrict__ out) {
  __shared__ float2 s_v[kTile + 1];
  __shared__ uint8_t s_ok[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int e_total = v - 1;
  float2 p = make_float2(0.0f, 0.0f);
  if (i < n) p = xy[i];
  const float2* bv = verts + (size_t)b * v;
  const uint8_t* bok = edge_valid + (size_t)b * e_total;
  float acc = INFINITY;
  for (int e0 = 0; e0 < e_total; e0 += kTile) {
    const int ne = min(kTile, e_total - e0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k <= ne; k += kThreads) s_v[k] = bv[e0 + k];
    for (int k = threadIdx.x; k < ne; k += kThreads) s_ok[k] = bok[e0 + k];
    __syncthreads();
    if (i < n) {
      for (int k = 0; k < ne; ++k) {
        if (!s_ok[k]) continue;
        const float d2 = seg_d2(p.x, p.y, s_v[k].x, s_v[k].y, s_v[k + 1].x,
                                s_v[k + 1].y);
        acc = fminf(acc, d2);
      }
    }
  }
  if (i < n) out[(size_t)i * g + b] = finish(acc);
}

__global__ void __launch_bounds__(kGatherThreads)
    gather_staged_kernel(const float2* __restrict__ xy,
                         const float2* __restrict__ verts,
                         const uint8_t* __restrict__ edge_valid,
                         const int* __restrict__ sel, int n, int c, int g,
                         int v, float* __restrict__ out) {
  extern __shared__ float2 s_all[];
  const int e_total = v - 1;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_all + (size_t)g * v);
  for (int k = threadIdx.x; k < g * v; k += blockDim.x) s_all[k] = verts[k];
  for (int k = threadIdx.x; k < g * e_total; k += blockDim.x)
    s_ok[k] = edge_valid[k];
  __syncthreads();
  const size_t items = (size_t)n * c;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < items;
       t += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(t / c);
    const int b = sel[t];
    const float2 p = xy[i];
    const float2* bv = s_all + (size_t)b * v;
    const uint8_t* bok = s_ok + (size_t)b * e_total;
    float acc = INFINITY;
    for (int k = 0; k < e_total; ++k) {
      if (!bok[k]) continue;
      acc = fminf(acc, seg_d2(p.x, p.y, bv[k].x, bv[k].y, bv[k + 1].x,
                              bv[k + 1].y));
    }
    out[t] = finish(acc);
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
    if (__ldg(bok + k))
      acc = fminf(acc, seg_d2(p.x, p.y, s1.x, s1.y, s2.x, s2.y));
    s1 = s2;
  }
  out[t] = finish(acc);
}

}  // namespace

extern "C" {

// out (N, C) f32. sel == NULL: dense mode, C == G. max_shared: the dynamic
// shared memory a block may use (0 disables staging); blocks: the grid of
// the staged mode. Returns cudaGetLastError() after the launch.
int sft_polyline_min_dist(const void* xy, const void* verts,
                          const void* edge_valid, const void* sel, int n,
                          int c, int g, int v, int max_shared, int blocks,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(xy);
  const float2* vv = static_cast<const float2*>(verts);
  const uint8_t* ok = static_cast<const uint8_t*>(edge_valid);
  float* o = static_cast<float*>(out);
  if (n <= 0 || c <= 0) return cudaGetLastError();
  if (sel == nullptr) {
    dim3 grid((n + kThreads - 1) / kThreads, g);
    dense_kernel<<<grid, kThreads, 0, s>>>(p, vv, ok, n, g, v, o);
    return cudaGetLastError();
  }
  const int* sl = static_cast<const int*>(sel);
  const size_t smem = (size_t)g * v * sizeof(float2) + (size_t)g * (v - 1);
  if (smem <= (size_t)max_shared) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const size_t items = (size_t)n * c;
    const size_t need = (items + kGatherThreads - 1) / kGatherThreads;
    const int grid = (int)(need < (size_t)blocks ? need : (size_t)blocks);
    gather_staged_kernel<<<grid, kGatherThreads, smem, s>>>(p, vv, ok, sl, n,
                                                            c, g, v, o);
    return cudaGetLastError();
  }
  const size_t items = (size_t)n * c;
  const unsigned grid = (unsigned)((items + kThreads - 1) / kThreads);
  gather_global_kernel<<<grid, kThreads, 0, s>>>(p, vv, ok, sl, n, c, v, o);
  return cudaGetLastError();
}

}  // extern "C"
