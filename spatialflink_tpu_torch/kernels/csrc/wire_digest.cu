// Wire pane -> per-object kNN digest (seg_min, rep) in one pass.
//
// Replaces the TPU kernel spatialflink_tpu/ops/pallas_digest.py:_extract_kernel
// (driven by wire_candidates_pallas, finished by digest_from_candidates).
// The TPU kernel walks 2048-lane blocks in order and compacts in-radius
// (dist, oid, idx) triples with an argmin-peel loop into a 16,384-slot
// candidate buffer, then XLA takes a segment-min over the candidates; a
// hit count above the buffer falls back to the full scatter digest.
//
// Here the digest is built directly: the per-object minimum is order-free,
// so one thread per point reads its three u16 planes, dequantizes, measures
// the distance and, on a hit, does one 64-bit atomicMin on the key
// (f32_bits(dist) << 32) | idx of its object. Non-negative f32 bit patterns
// order like the floats, so the smallest key holds the smallest distance
// and, among equal distances, the lowest index -- the reference's
// representative tie-break. A second pass unpacks the keys. There is no
// candidate buffer, so there is no overflow and no fallback: the digest is
// exact at any hit count.
//
// Arithmetic is the reference's, operation by operation, with no
// contraction: q*scale+origin, dx*dx+dy*dy, sqrt, then `dist <= radius`
// (sqrt first, then compare). __fmul_rn/__fadd_rn/__fsqrt_rn keep nvcc
// from fusing into FMA, so the kernel is bit-equal to the plain PyTorch
// version in ops/wire_digest_kernel.py on the same card.
//
// Bound on the H100: bytes. A 500,000-point pane reads 3 MB of u16 planes
// and writes 128 KB of digest: about 1 us at 3.35 TB/s. Three launches per
// pane (key init, scan, unpack), so launch latency dominates at this size.

#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

__global__ void init_keys(unsigned long long* keys, int num_segments,
                          int* count) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < num_segments) keys[s] = kEmpty;
  if (s == 0) *count = 0;
}

__global__ void scan_points(const uint16_t* __restrict__ wire, int n_pad,
                            int n_valid, float qx, float qy, float sx,
                            float sy, float ox, float oy, float radius,
                            int num_segments,
                            unsigned long long* __restrict__ keys,
                            int* __restrict__ count) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool in_radius = false;
  if (i < n_valid) {
    float xf = __fadd_rn(__fmul_rn((float)wire[i], sx), ox);
    float yf = __fadd_rn(__fmul_rn((float)wire[n_pad + i], sy), oy);
    float dx = __fsub_rn(xf, qx);
    float dy = __fsub_rn(yf, qy);
    float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    in_radius = dist <= radius;
    int oid = wire[2 * n_pad + i];
    if (in_radius && oid < num_segments) {
      unsigned long long key =
          ((unsigned long long)__float_as_uint(dist) << 32) | (unsigned)i;
      atomicMin(&keys[oid], key);
    }
  }
  // Every thread of the warp reaches the ballot (no early return above).
  unsigned hits = __ballot_sync(0xffffffffu, in_radius);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(count, __popc(hits));
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            int num_segments, float* __restrict__ seg_min,
                            int* __restrict__ rep) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  unsigned long long key = keys[s];
  if (key == kEmpty) {
    seg_min[s] = FLT_MAX;
    rep[s] = INT_MAX;
  } else {
    seg_min[s] = __uint_as_float((unsigned)(key >> 32));
    rep[s] = (int)(unsigned)(key & 0xffffffffull);
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// wire: (3, n_pad) u16 plane-major pane (x_q, y_q, oid bits), contiguous.
// keys: (num_segments,) u64 scratch. seg_min/rep: (num_segments,) outputs.
// count: one int, the number of in-radius points among the first n_valid.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int sft_wire_digest(const uint16_t* wire, int n_pad, int n_valid,
                               float qx, float qy, float sx, float sy,
                               float ox, float oy, float radius,
                               int num_segments, unsigned long long* keys,
                               float* seg_min, int* rep, int* count,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  init_keys<<<blocks_for(num_segments), kThreads, 0, st>>>(keys, num_segments,
                                                           count);
  if (n_valid > 0) {
    scan_points<<<blocks_for(n_valid), kThreads, 0, st>>>(
        wire, n_pad, n_valid, qx, qy, sx, sy, ox, oy, radius, num_segments,
        keys, count);
  }
  unpack_keys<<<blocks_for(num_segments), kThreads, 0, st>>>(
      keys, num_segments, seg_min, rep);
  return (int)cudaGetLastError();
}
