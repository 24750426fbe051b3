// Delta-bitpacked wire pane -> (3, n) u16 pane + updated predictor tables,
// in one launch.
//
// Replaces the TPU kernel spatialflink_tpu/ops/wire_codec.py:_extract_kernel
// (driven by make_pallas_extract). The TPU kernel only extracts the three
// bit streams; the unzigzag, the predictor add, the u16 wrap and the
// last-occurrence predictor update stay in XLA around it
// (ops/wire_codec.py:decode_wire_pane). Here the kernel does all of a
// lane's work and writes the decoded pane directly:
//
//   - LSB-first extraction of zigzag-dx, zigzag-dy and oid at widths
//     bx/by/bo in 0..16, from word offsets 0, ceil(n_valid*bx/32) and
//     that plus ceil(n_valid*by/32); a field that straddles two words ORs
//     in the next word, word indices clamp to the payload, the result is
//     masked to b bits and width 0 gives 0 (the reference's arithmetic);
//   - unzigzag, add the object's predictor, wrap to 16 bits;
//   - atomicMax of the lane index into the object's `last` slot;
//   - after a grid-wide barrier, each object's predictor becomes the pane's
//     decoded coordinates at its last lane (unchanged where the object is
//     absent): the deterministic last-occurrence rule the host encoder
//     mirrors.
// Lanes at or past n_valid are written as zeros, like the raw path's bucket
// padding. Everything is integer arithmetic, so the result is bit-exact.
//
// Bound on the H100: bytes. A 500,000-point pane reads at most 3 MB of
// payload and writes 3 MB of pane: about 2 us at 3.35 TB/s. At that size a
// launch and the gaps between launches cost more than the bytes, so:
//
//   - one cooperative launch of at most the blocks the card keeps resident
//     (the residency query is cached per device). Phase 2, after the grid
//     barrier, also resets `last` to -1, so the wrapper fills that scratch
//     once, when it first makes it, and no call needs an init kernel;
//   - a thread decodes 8 consecutive lanes. At width b they span the bits
//     [8gb, 8(g+1)b) of a stream, at most 5 words: the thread loads each
//     of those words once (at its clamped index, so a stream that runs past
//     the payload re-reads the last word exactly as the reference does) and
//     takes the 8 fields with funnel shifts from registers;
//   - it writes the 8 lanes as one 16-byte store per plane (n_pad % 8 == 0),
//     else as 2-byte stores in the same kernel;
//   - the per-lane atomicMax reductions (one per valid lane, 500,000 a
//     headline pane) are what remains above the bound. Each oid's `last`
//     slot has a 32-byte sector of its own, which spreads them over
//     16,384 sectors instead of 2,048.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // lanes per thread: one 16-byte vector of u16
constexpr int kWords = 5;  // words 8 fields of <= 16 bits can touch
// `last` holds one oid every kLastStride ints, one 32-byte L2 sector each.
constexpr int kLastStride = 8;
constexpr int kMaxDevices = 64;

// The 8 b-bit fields of lanes i0..i0+7 of the stream at word_off. Field i
// reads words word_off + (i*b >> 5) and the one after, each index clamped
// to [0, n_words - 1]; this loads those words once, at the same clamped
// indices, and shifts through them.
__device__ __forceinline__ void extract8(const uint32_t* __restrict__ words,
                                         int n_words, int word_off, int i0,
                                         int b, unsigned (&z)[kLanes]) {
  if (b == 0) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) z[j] = 0u;
    return;
  }
  const int bit0 = i0 * b;
  const int base = word_off + (bit0 >> 5);
  unsigned s = (unsigned)(bit0 & 31);
  // The fields' bits lie in words base .. base + need; a word past that
  // only meets bits the width mask clears, so it stays 0 here.
  const int need = (int)(s + kLanes * b - 1) >> 5;
  unsigned w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    w[k] = k <= need ? __ldg(&words[min(max(base + k, 0), n_words - 1)]) : 0u;
  const unsigned mask = (1u << b) - 1u;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    // (w[1]:w[0]) >> s: the reference's (lo >> s) | (hi << (32 - s)), and
    // w[0] alone at s == 0.
    z[j] = __funnelshift_r(w[0], w[1], s) & mask;
    s += (unsigned)b;
    if (s >= 32u) {  // b <= 16: at most one word boundary per lane
      s -= 32u;
#pragma unroll
      for (int k = 0; k + 1 < kWords; ++k) w[k] = w[k + 1];
    }
  }
}

__device__ __forceinline__ int unzigzag(unsigned z) {
  const int zi = (int)z;
  return (zi >> 1) ^ -(zi & 1);
}

__device__ __forceinline__ uint4 pack8(const unsigned (&v)[kLanes]) {
  return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                    v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const uint32_t* __restrict__ words, int n_words, int n_pad,
                  int n_valid, int bx, int by, int bo,
                  const uint16_t* __restrict__ pred_x,
                  const uint16_t* __restrict__ pred_y, int num_segments,
                  int vec, uint16_t* pane, int* last,
                  uint16_t* __restrict__ px2, uint16_t* __restrict__ py2) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int wx = (n_valid * bx + 31) >> 5;
  const int wy = (n_valid * by + 31) >> 5;

  // Phase 1: decode 8 lanes a thread.
  const int groups = (n_pad + kLanes - 1) / kLanes;
  for (int g = first; g < groups; g += stride) {
    const int i0 = g * kLanes;
    unsigned x[kLanes], y[kLanes], o[kLanes];
    if (i0 < n_valid) {
      unsigned zx[kLanes], zy[kLanes];
      extract8(words, n_words, 0, i0, bx, zx);
      extract8(words, n_words, wx, i0, by, zy);
      extract8(words, n_words, wx + wy, i0, bo, o);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (i0 + j < n_valid) {
          const int os = min((int)o[j], num_segments - 1);
          x[j] = (unsigned)((int)__ldg(&pred_x[os]) + unzigzag(zx[j])) & 0xFFFFu;
          y[j] = (unsigned)((int)__ldg(&pred_y[os]) + unzigzag(zy[j])) & 0xFFFFu;
          atomicMax(&last[os * kLastStride], i0 + j);
        } else {
          x[j] = y[j] = o[j] = 0u;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) x[j] = y[j] = o[j] = 0u;
    }
    if (vec) {
      *reinterpret_cast<uint4*>(pane + i0) = pack8(x);
      *reinterpret_cast<uint4*>(pane + n_pad + i0) = pack8(y);
      *reinterpret_cast<uint4*>(pane + 2 * n_pad + i0) = pack8(o);
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        if (i0 + j < n_pad) {
          pane[i0 + j] = (uint16_t)x[j];
          pane[n_pad + i0 + j] = (uint16_t)y[j];
          pane[2 * n_pad + i0 + j] = (uint16_t)o[j];
        }
      }
    }
  }

  grid.sync();

  // Phase 2: the last-occurrence predictor update, and `last` reset for the
  // next call. `last` and the pane were written by other blocks: read them
  // from L2.
  for (int s = first; s < num_segments; s += stride) {
    const int l = __ldcg(&last[s * kLastStride]);
    if (l >= 0) {
      px2[s] = __ldcg(&pane[l]);
      py2[s] = __ldcg(&pane[n_pad + l]);
      last[s * kLastStride] = -1;
    } else {
      px2[s] = pred_x[s];
      py2[s] = pred_y[s];
    }
  }
}

// Blocks of decode_kernel that one device keeps resident, cached per device
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel,
                                                      kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < kMaxDevices) resident_blocks[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// words: (n_words,) u32 bucket-padded payload, n_words >= 1.
// pred_x/pred_y: (num_segments,) u16 predictor tables (read only).
// pane: (3, n_pad) u16 output; last: (num_segments * 8,) int scratch, every
// entry -1 (the kernel leaves it so; oid s uses entry 8 * s); px2/py2:
// (num_segments,) u16 updated predictor tables.
// One cooperative launch on `stream`; does not synchronise. Returns the
// launch's error, else cudaGetLastError().
extern "C" int sft_wire_codec_decode(const uint32_t* words, int n_words,
                                     int n_pad, int n_valid, int bx, int by,
                                     int bo, const uint16_t* pred_x,
                                     const uint16_t* pred_y, int num_segments,
                                     uint16_t* pane, int* last, uint16_t* px2,
                                     uint16_t* py2, void* stream) {
  int limit = 0;
  cudaError_t err = grid_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const int groups = (n_pad + kLanes - 1) / kLanes;
  int need = (groups + kThreads - 1) / kThreads;
  need = max(need, (num_segments + kThreads - 1) / kThreads);
  const int blocks = max(1, min(need, limit));
  int vec = n_pad % kLanes == 0 &&
            reinterpret_cast<uintptr_t>(pane) % sizeof(uint4) == 0;
  void* args[] = {&words,  &n_words, &n_pad, &n_valid, &bx,
                  &by,     &bo,      &pred_x, &pred_y, &num_segments,
                  &vec,    &pane,    &last,  &px2,     &py2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last_err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last_err);
}
