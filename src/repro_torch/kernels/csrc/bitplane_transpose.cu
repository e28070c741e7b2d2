// Transposition unit of the SIMDRAM paper (section 5.1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitplane_transpose.py::_fwd_kernel / _transpose32_block
// (pallas_call at bitplane_transpose.py:66): a 32x32 bit-matrix transpose,
// LSB first.  Element e of a 32-element group is lane e of a warp; bit e of
// plane word i is bit i of element e.
//   to:   lane e holds element e; a 5-stage shuffle network transposes the
//         warp's 32x32 bit matrix, after which lane i holds plane word i.
//   from: lane e builds element e from its group's n_bits plane words,
//         v |= ((plane_i >> e) & 1) << i, reading each word from shared
//         memory as a broadcast to the whole warp (n_bits steps a lane).
// The TPU version needs G % 128 == 0 and runs a 5-stage masked-shift network
// on (32,128) blocks; here a group is one warp and only the element count
// has to be a multiple of 32.
//
// What bounds it on this card: device-memory bytes.  Each element word is
// read or written once (4 B) and each plane word once (n_bits/8 B per
// element).  A call moves 4-8 MB, a few times the bytes the card has in
// flight at once, so the design's first concern is keeping many reads in
// flight from the start, and then keeping both global sides coalesced.
// To planes: a block of 256 threads takes 64 groups; each warp loads the
// element words of its 8 groups (8 independent 4-byte loads a lane, 128 B a
// warp instruction) before it transposes the first, and the 512 blocks of
// 16 x 65,536 lanes are all resident in one wave (about four an SM).  Each
// stage of the network is a shuffle, a rotate and one three-input logic op
// (no cross-lane select), the lanes that hold one of the n_bits planes
// write it to a shared tile ([32][65], conflict free), and the block writes
// n_bits rows of 64 consecutive plane words (256 B each).  Staging the
// element words with cp.async, 16-byte loads, or blocks of 128 or 256
// groups measured slower on the H100.
// From planes: a block stages n_bits x 128 plane words (n_bits / 2
// loads a thread in flight, so the reads are not bound by latency), and
// each warp writes 32 consecutive element words a group.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kToThreads = 256;         // threads per block, to
constexpr int kToGroups = 64;           // groups per block, to
constexpr int kFromThreads = 256;       // threads per block, from
constexpr int kFromGroups = 128;        // groups per block, from
constexpr unsigned kFull = 0xffffffffu;

// One warp's 32x32 bit matrix, row e in lane e, transposed in place.  Stage
// j swaps bit j of the row index with bit j of the column index: a lane
// without bit j (upper) keeps its columns without bit j and takes the
// partner's (lane + j) columns without bit j into its columns with bit j,
// moved up by j; a lane with bit j (lower) does the opposite, moved down by
// j.  A rotate by j (upper) or 32 - j (lower) does either move, and `keep`
// selects the columns the lane replaces.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    // columns without bit j: 0x0000ffff, 0x00ff00ff, 0x0f0f0f0f, ...
    const uint32_t low = kFull / ((1u << j) + 1u);
    const bool upper = (lane & j) == 0;
    const uint32_t keep = upper ? ~low : low;
    const uint32_t p = __shfl_xor_sync(kFull, x, j);
    const uint32_t moved = __funnelshift_l(p, p, upper ? j : 32 - j);
    x ^= (x ^ moved) & keep;
  }
  return x;
}

// values int32[groups*32] -> planes int32[n_bits, groups].  Warp w of a
// block takes the block's groups 8w .. 8w + 7.
__global__ void __launch_bounds__(kToThreads)
to_planes_kernel(const int32_t* __restrict__ values,
                 int32_t* __restrict__ planes, int64_t groups, int n_bits) {
  constexpr int kPerWarp = kToGroups / (kToThreads / 32);
  __shared__ uint32_t tile[32][kToGroups + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kToGroups;
  uint32_t x[kPerWarp];
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int64_t g = g0 + warp * kPerWarp + q;
    x[q] = g < groups ? static_cast<uint32_t>(__ldg(values + g * 32 + lane))
                      : 0u;
  }
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const uint32_t word = transpose32(x[q], lane);
    if (lane < n_bits) tile[lane][warp * kPerWarp + q] = word;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_bits * kToGroups; idx += kToThreads) {
    const int i = idx / kToGroups;
    const int j = idx % kToGroups;
    if (g0 + j < groups) {
      planes[static_cast<int64_t>(i) * groups + g0 + j] =
          static_cast<int32_t>(tile[i][j]);
    }
  }
}

// planes int32[n_bits, groups] -> values int32[groups*32], sign-extended
// from bit n_bits-1 when sign_extend and n_bits < 32.  A block of
// kFromThreads stages the n_bits plane words of kFromGroups groups (each
// warp reads 32 consecutive words of one plane), then warp w builds groups
// 16w .. 16w + 15: lane e of the warp builds element e of a group from the
// group's n_bits words, each read as a broadcast.
__global__ void __launch_bounds__(kFromThreads)
from_planes_kernel(const int32_t* __restrict__ planes,
                   int32_t* __restrict__ values, int64_t groups, int n_bits,
                   int sign_extend) {
  __shared__ uint32_t tile[32][kFromGroups];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kFromGroups;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n_bits * kFromGroups;
       idx += kFromThreads) {
    const int i = idx / kFromGroups;
    const int j = idx % kFromGroups;
    tile[i][j] = g0 + j < groups
        ? static_cast<uint32_t>(planes[static_cast<int64_t>(i) * groups
                                       + g0 + j])
        : 0u;
  }
  __syncthreads();
  constexpr int kPerWarp = kFromGroups / (kFromThreads / 32);
  for (int q = 0; q < kPerWarp; ++q) {
    const int j = warp * kPerWarp + q;
    const int64_t g = g0 + j;
    if (g >= groups) break;
    unsigned mine = 0;
#pragma unroll 8
    for (int i = 0; i < n_bits; ++i) mine |= ((tile[i][j] >> lane) & 1u) << i;
    int32_t v = static_cast<int32_t>(mine);
    if (sign_extend && n_bits < 32) {
      const int s = 32 - n_bits;
      v = static_cast<int32_t>(mine << s) >> s;
    }
    values[g * 32 + lane] = v;
  }
}

unsigned blocks_for(long long groups, int per_block) {
  return static_cast<unsigned>((groups + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int bitplane_to_planes_launch(const void* values, void* planes,
                              long long groups, int n_bits, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  to_planes_kernel<<<blocks_for(groups, kToGroups), kToThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), static_cast<int32_t*>(planes),
      groups, n_bits);
  return cudaGetLastError();
}

int bitplane_from_planes_launch(const void* planes, void* values,
                                long long groups, int n_bits,
                                int sign_extend, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  from_planes_kernel<<<blocks_for(groups, kFromGroups), kFromThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(planes), static_cast<int32_t*>(values),
      groups, n_bits, sign_extend);
  return cudaGetLastError();
}

const char* bitplane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
