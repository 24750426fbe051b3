// Delta-bitpacked wire pane -> (3, n) u16 pane + updated predictor tables.
//
// Replaces the TPU kernel spatialflink_tpu/ops/wire_codec.py:_extract_kernel
// (driven by make_pallas_extract). The TPU kernel only extracts the three
// bit streams; the unzigzag, the predictor add, the u16 wrap and the
// last-occurrence predictor update stay in XLA around it
// (ops/wire_codec.py:decode_wire_pane). Here one thread per lane does all of
// the lane's work and writes the decoded pane directly:
//
//   - LSB-first extraction of zigzag-dx, zigzag-dy and oid at widths
//     bx/by/bo in 0..16, from word offsets 0, ceil(n_valid*bx/32) and
//     that plus ceil(n_valid*by/32); a field that straddles two words ORs
//     in the next word, word indices clamp to the payload, the result is
//     masked to b bits and width 0 gives 0 (the reference's arithmetic);
//   - unzigzag, add the object's predictor, wrap to 16 bits;
//   - atomicMax of the lane index into the object's `last` slot.
//
// A second pass sets each object's predictor to the pane's decoded
// coordinates at its last lane (unchanged where the object is absent): the
// deterministic last-occurrence rule the host encoder mirrors. Lanes at or
// past n_valid are written as zeros, like the raw path's bucket padding.
// Everything is integer arithmetic, so the result is bit-exact.
//
// Bound on the H100: bytes. A 500,000-point pane reads at most 3 MB of
// payload and writes 3 MB of pane: about 2 us at 3.35 TB/s. Three launches
// per pane (last init, decode, predictor update).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned extract_field(
    const uint32_t* __restrict__ words, int n_words, int word_off, int lane,
    int b) {
  int bitpos = lane * b;
  int w0 = min(max(word_off + (bitpos >> 5), 0), n_words - 1);
  int w1 = min(max(word_off + (bitpos >> 5) + 1, 0), n_words - 1);
  unsigned s = (unsigned)(bitpos & 31);
  unsigned lo = words[w0] >> s;
  unsigned hi = s == 0 ? 0u : (words[w1] << ((32u - s) & 31u));
  unsigned mask = b == 0 ? 0u : ((1u << b) - 1u);
  return (lo | hi) & mask;
}

__device__ __forceinline__ int unzigzag(unsigned z) {
  int zi = (int)z;
  return (zi >> 1) ^ -(zi & 1);
}

__global__ void init_last(int* last, int num_segments) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < num_segments) last[s] = -1;
}

__global__ void decode_lanes(const uint32_t* __restrict__ words, int n_words,
                             int n_pad, int n_valid, int bx, int by, int bo,
                             const uint16_t* __restrict__ pred_x,
                             const uint16_t* __restrict__ pred_y,
                             int num_segments, uint16_t* __restrict__ pane,
                             int* __restrict__ last) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  if (i >= n_valid) {
    pane[i] = 0;
    pane[n_pad + i] = 0;
    pane[2 * n_pad + i] = 0;
    return;
  }
  int wx = (n_valid * bx + 31) >> 5;
  int wy = (n_valid * by + 31) >> 5;
  unsigned zx = extract_field(words, n_words, 0, i, bx);
  unsigned zy = extract_field(words, n_words, wx, i, by);
  unsigned o = extract_field(words, n_words, wx + wy, i, bo);
  int os = min((int)o, num_segments - 1);
  int x = ((int)pred_x[os] + unzigzag(zx)) & 0xFFFF;
  int y = ((int)pred_y[os] + unzigzag(zy)) & 0xFFFF;
  pane[i] = (uint16_t)x;
  pane[n_pad + i] = (uint16_t)y;
  pane[2 * n_pad + i] = (uint16_t)o;
  atomicMax(&last[os], i);
}

__global__ void update_predictors(const uint16_t* __restrict__ pane,
                                  int n_pad, const int* __restrict__ last,
                                  const uint16_t* __restrict__ pred_x,
                                  const uint16_t* __restrict__ pred_y,
                                  int num_segments,
                                  uint16_t* __restrict__ px2,
                                  uint16_t* __restrict__ py2) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num_segments) return;
  int l = last[s];
  px2[s] = l >= 0 ? pane[l] : pred_x[s];
  py2[s] = l >= 0 ? pane[n_pad + l] : pred_y[s];
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// words: (n_words,) u32 bucket-padded payload, n_words >= 1.
// pred_x/pred_y: (num_segments,) u16 predictor tables (read only).
// pane: (3, n_pad) u16 output; last: (num_segments,) int scratch;
// px2/py2: (num_segments,) u16 updated predictor tables.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int sft_wire_codec_decode(const uint32_t* words, int n_words,
                                     int n_pad, int n_valid, int bx, int by,
                                     int bo, const uint16_t* pred_x,
                                     const uint16_t* pred_y, int num_segments,
                                     uint16_t* pane, int* last, uint16_t* px2,
                                     uint16_t* py2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  init_last<<<blocks_for(num_segments), kThreads, 0, st>>>(last,
                                                           num_segments);
  decode_lanes<<<blocks_for(n_pad), kThreads, 0, st>>>(
      words, n_words, n_pad, n_valid, bx, by, bo, pred_x, pred_y,
      num_segments, pane, last);
  update_predictors<<<blocks_for(num_segments), kThreads, 0, st>>>(
      pane, n_pad, last, pred_x, pred_y, num_segments, px2, py2);
  return (int)cudaGetLastError();
}
