// Transposition unit of the SIMDRAM paper (section 5.1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitplane_transpose.py::_fwd_kernel / _transpose32_block
// (pallas_call at bitplane_transpose.py:66): a 32x32 bit-matrix transpose,
// LSB first.  Element e of a 32-element group is lane e of a warp; bit e of
// plane word i is bit i of element e.  The transpose is its own inverse, so
// both directions are the same 32 ballots:
//   to:   lane e holds element e;  __ballot_sync of bit i gives plane word i.
//   from: lane i holds plane i;    __ballot_sync of bit e gives element e.
// The TPU version needs G % 128 == 0 and runs a 5-stage masked-shift network
// on (32,128) blocks; here a group is one warp and only the element count
// has to be a multiple of 32.
//
// What bounds it on this card: device-memory bytes.  Each element word is
// read or written once (4 B) and each plane word once (n_bits/8 B per
// element), against at most 32 ballots per warp.  The design keeps both
// global sides coalesced: a block of 32 warps handles 32 groups and turns
// its 32 x 32 plane words around in shared memory ([32][33], conflict
// free), so a warp reads 32 consecutive element words and writes 32
// consecutive words of one plane (128 B each).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 32;             // groups (warps) per block
constexpr unsigned kFull = 0xffffffffu;

// values int32[groups*32] -> planes int32[n_bits, groups]
__global__ void __launch_bounds__(kGroups * 32)
to_planes_kernel(const int32_t* __restrict__ values,
                 int32_t* __restrict__ planes, int64_t groups, int n_bits) {
  __shared__ int32_t tile[32][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  const int64_t g = g0 + warp;
  const int32_t x = g < groups ? values[g * 32 + lane] : 0;
  unsigned mine = 0;
  for (int i = 0; i < n_bits; ++i) {
    const unsigned word = __ballot_sync(kFull, (x >> i) & 1);
    if (lane == i) mine = word;
  }
  tile[lane][warp] = static_cast<int32_t>(mine);  // plane `lane` of group g
  __syncthreads();
  const int64_t gg = g0 + lane;
  if (warp < n_bits && gg < groups) {
    planes[static_cast<int64_t>(warp) * groups + gg] = tile[warp][lane];
  }
}

// planes int32[n_bits, groups] -> values int32[groups*32], sign-extended
// from bit n_bits-1 when sign_extend and n_bits < 32
__global__ void __launch_bounds__(kGroups * 32)
from_planes_kernel(const int32_t* __restrict__ planes,
                   int32_t* __restrict__ values, int64_t groups, int n_bits,
                   int sign_extend) {
  __shared__ int32_t tile[32][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  const int64_t gg = g0 + lane;
  tile[warp][lane] = (warp < n_bits && gg < groups)
      ? planes[static_cast<int64_t>(warp) * groups + gg] : 0;
  __syncthreads();
  const int32_t p = tile[lane][warp];  // plane `lane` of group g0 + warp
  unsigned mine = 0;
  for (int e = 0; e < 32; ++e) {
    const unsigned word = __ballot_sync(kFull, (p >> e) & 1);
    if (lane == e) mine = word;
  }
  int32_t v = static_cast<int32_t>(mine);
  if (sign_extend && n_bits < 32) {
    const int s = 32 - n_bits;
    v = static_cast<int32_t>(mine << s) >> s;
  }
  const int64_t g = g0 + warp;
  if (g < groups) values[g * 32 + lane] = v;
}

unsigned blocks_for(long long groups) {
  return static_cast<unsigned>((groups + kGroups - 1) / kGroups);
}

}  // namespace

extern "C" {

int bitplane_to_planes_launch(const void* values, void* planes,
                              long long groups, int n_bits, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  to_planes_kernel<<<blocks_for(groups), kGroups * 32, 0,
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
  from_planes_kernel<<<blocks_for(groups), kGroups * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(planes), static_cast<int32_t*>(values),
      groups, n_bits, sign_extend);
  return cudaGetLastError();
}

const char* bitplane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
