// Wire pane -> per-object kNN digest (seg_min, rep) in one launch.
//
// Replaces the TPU kernel spatialflink_tpu/ops/pallas_digest.py:_extract_kernel
// (driven by wire_candidates_pallas, finished by digest_from_candidates).
// The TPU kernel walks 2048-lane blocks in order and compacts in-radius
// (dist, oid, idx) triples with an argmin-peel loop into a 16,384-slot
// candidate buffer, then XLA takes a segment-min over the candidates; a
// hit count above the buffer falls back to the full scatter digest.
//
// Here the digest is built directly: the per-object minimum is order-free,
// so each point reads its three u16 planes, dequantizes, measures the
// distance and, on a hit, does one 64-bit atomicMin on the key
// (f32_bits(dist) << 32) | idx of its object. Non-negative f32 bit patterns
// order like the floats, so the smallest key holds the smallest distance
// and, among equal distances, the lowest index -- the reference's
// representative tie-break. There is no candidate buffer, so there is no
// overflow and no fallback: the digest is exact at any hit count.
//
// Arithmetic is the reference's, operation by operation, with no
// contraction: q*scale+origin, dx*dx+dy*dy, sqrt, then `dist <= radius`
// (sqrt first, then compare). __fmul_rn/__fadd_rn/__fsqrt_rn keep nvcc
// from fusing into FMA, so the kernel is bit-equal to the plain PyTorch
// version in ops/wire_digest_kernel.py on the same card.
//
// Bound on the H100: bytes. A 500,000-point pane reads 3 MB of u16 planes
// and writes 128 KB of digest: about 1 us at 3.35 TB/s. At that size a
// launch, and the gap between two launches, cost more than the bytes, so
// the design spends one launch per pane and moves the bytes 16 at a time:
//
//   - one cooperative launch of at most the blocks the card keeps resident
//     (the residency query is cached per device). Phase 1 scans the pane;
//     after one grid-wide barrier, phase 2 unpacks each key into
//     seg_min/rep, writes the hit count, and resets the key to ~0 and the
//     count accumulator to 0. The scratch (keys and accumulator) is thus
//     left ready for the next call: the wrapper fills it once, when it
//     first makes it, and no call needs a memset or an init kernel;
//   - a thread takes 8 consecutive lanes: one 16-byte load from each plane
//     when the planes are 16-byte aligned (n_pad % 8 == 0 and an aligned
//     base), else 8 scalar loads in the same kernel;
//   - the hit count is summed per warp, then per block, and each block
//     adds it to the accumulator with one atomic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes per thread: one 16-byte vector of u16
constexpr int kMaxDevices = 64;
constexpr unsigned long long kEmpty = ~0ull;

// The u16 at lane j of 8 lanes held as a uint4 (little-endian).
__device__ __forceinline__ unsigned lane16(const uint4& v, int j) {
  const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return (j & 1) ? w >> 16 : w & 0xFFFFu;
}

__global__ void __launch_bounds__(kThreads)
    digest_kernel(const uint16_t* __restrict__ wire, int n_pad, int n_valid,
                  float qx, float qy, float sx, float sy, float ox, float oy,
                  float radius, int num_segments, int vec,
                  unsigned long long* keys, int* acc,
                  float* __restrict__ seg_min, int* __restrict__ rep,
                  int* __restrict__ count) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int warp_hits[kThreads / 32];
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  // Phase 1: scan, 8 lanes a thread.
  const int groups = (n_valid + kLanes - 1) / kLanes;
  int hits = 0;
  for (int g = first; g < groups; g += stride) {
    const int i0 = g * kLanes;
    unsigned xs[kLanes], ys[kLanes], os[kLanes];
    if (vec) {
      const uint4 vx = *reinterpret_cast<const uint4*>(wire + i0);
      const uint4 vy = *reinterpret_cast<const uint4*>(wire + n_pad + i0);
      const uint4 vo = *reinterpret_cast<const uint4*>(wire + 2 * n_pad + i0);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        xs[j] = lane16(vx, j);
        ys[j] = lane16(vy, j);
        os[j] = lane16(vo, j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int i = min(i0 + j, n_valid - 1);  // lanes past n_valid unused
        xs[j] = wire[i];
        ys[j] = wire[n_pad + i];
        os[j] = wire[2 * n_pad + i];
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int i = i0 + j;
      if (i >= n_valid) break;
      const float xf = __fadd_rn(__fmul_rn((float)xs[j], sx), ox);
      const float yf = __fadd_rn(__fmul_rn((float)ys[j], sy), oy);
      const float dx = __fsub_rn(xf, qx);
      const float dy = __fsub_rn(yf, qy);
      const float dist =
          __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (dist <= radius) {
        ++hits;
        if ((int)os[j] < num_segments) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(dist) << 32) | (unsigned)i;
          atomicMin(&keys[os[j]], key);
        }
      }
    }
  }
  // Every thread reaches the reductions: the loop above has no early exit.
  hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int block_hits = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) block_hits += warp_hits[w];
    if (block_hits) atomicAdd(acc, block_hits);
  }

  grid.sync();

  // Phase 2: unpack the keys and leave the scratch ready for the next call.
  // The keys were written by other blocks' atomics: read them from L2.
  for (int s = first; s < num_segments; s += stride) {
    const unsigned long long key = __ldcg(&keys[s]);
    if (key == kEmpty) {
      seg_min[s] = FLT_MAX;
      rep[s] = INT_MAX;
    } else {
      seg_min[s] = __uint_as_float((unsigned)(key >> 32));
      rep[s] = (int)(unsigned)(key & 0xffffffffull);
      keys[s] = kEmpty;
    }
  }
  if (first == 0) *count = atomicExch(acc, 0);
}

// Blocks of digest_kernel that one device keeps resident, cached per device
// (0: not asked yet).
int resident_blocks[kMaxDevices];

cudaError_t grid_limit(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && resident_blocks[dev] > 0) {
    *blocks = resident_blocks[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, digest_kernel,
                                                      kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < kMaxDevices) resident_blocks[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// wire: (3, n_pad) u16 plane-major pane (x_q, y_q, oid bits), contiguous.
// keys: (num_segments + 1,) u64 scratch: every key ~0 and the last word 0
// (it holds the int count accumulator); the kernel leaves it so.
// seg_min/rep: (num_segments,) outputs. count: one int, the number of
// in-radius points among the first n_valid.
// One cooperative launch on `stream`; does not synchronise. Returns the
// launch's error, else cudaGetLastError().
extern "C" int sft_wire_digest(const uint16_t* wire, int n_pad, int n_valid,
                               float qx, float qy, float sx, float sy,
                               float ox, float oy, float radius,
                               int num_segments, unsigned long long* keys,
                               float* seg_min, int* rep, int* count,
                               void* stream) {
  int limit = 0;
  cudaError_t err = grid_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int groups = (n_valid + kLanes - 1) / kLanes;
  int need = (groups + kThreads - 1) / kThreads;
  need = max(need, (num_segments + kThreads - 1) / kThreads);
  const int blocks = max(1, min(need, limit));
  int vec = n_pad % kLanes == 0 &&
            reinterpret_cast<uintptr_t>(wire) % sizeof(uint4) == 0;
  int* acc = reinterpret_cast<int*>(keys + num_segments);
  void* args[] = {&wire, &n_pad, &n_valid, &qx,  &qy,           &sx,
                  &sy,   &ox,    &oy,      &radius, &num_segments, &vec,
                  &keys, &acc,   &seg_min, &rep, &count};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(digest_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
