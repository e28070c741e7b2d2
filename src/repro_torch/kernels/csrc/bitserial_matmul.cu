// XNOR-NET binarized matmul (the paper's application kernels) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_matmul.py::
// _kernel (pallas_call at bitserial_matmul.py:49):
//   out[i, j] = k_bits - 2 * sum_w popcount(a[i, w] ^ b[j, w])
// over sign-packed words (bit 1 = +1, bit 0 = -1), a int32[M, Kw] and
// b int32[N, Kw], both row-major, so both are K-contiguous (an "NT"
// product).  The words are the port's int32 plane words; the kernel reads
// them as unsigned and never converts them, so bit 31 is just a bit.
//
// The TPU version tiles (128, 128, 8) with K innermost and keeps the output
// block resident in VMEM across the sequential K grid axis.  On this card
// the blocks run in parallel and nothing carries over between them, so
// each block owns one 64 x 64 output tile and walks the whole K axis in a
// loop: it stages 32-word chunks of its 64 rows of a and of b in shared
// memory, transposed to [k][row] with one word of padding a row (the
// transposed write of a warp, 32 consecutive k of one row, then hits 32
// different banks), and each of its 16 x 16 threads accumulates a 4 x 4
// register micro-tile with __popc(x ^ y).  Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j, so a warp's reads of a chunk row are
// two broadcasts (a) and 16 consecutive words (b): conflict free.  Rows
// beyond M or N and words beyond Kw are staged as 0 on both sides: they
// XOR to 0 and add nothing; their outputs are not written.
//
// What bounds it on this card: the popcount pipe.  M*N*Kw __popc at 16 a
// clock an SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0), against (M + N)*Kw*4 bytes read and
// M*N*4 written; at the VGG-16 FC6 shape (256 x 4,096 x 784 words) that is
// ~0.2 ms of popcounts against ~5 us of bytes.  Each thread issues 8
// shared loads per 16 popcounts, well under the shared-memory rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                    // output tile edge
constexpr int kEdge = 16;                    // threads per tile edge
constexpr int kMicro = kTile / kEdge;        // outputs per thread per edge
constexpr int kThreads = kEdge * kEdge;      // 256
constexpr int kChunk = 32;                   // packed words staged per step

__global__ void __launch_bounds__(kThreads)
xnor_popcount_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     int32_t* __restrict__ out, int m, int n, int kw,
                     int k_bits) {
  __shared__ uint32_t as[kChunk][kTile + 1];
  __shared__ uint32_t bs[kChunk][kTile + 1];
  const int tx = threadIdx.x % kEdge;
  const int ty = threadIdx.x / kEdge;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  int mism[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) mism[i][j] = 0;

  for (int k0 = 0; k0 < kw; k0 += kChunk) {
    // 64 rows x 32 words of each operand; a warp reads 32 consecutive
    // words of one row (128 B) and writes them down one smem column
#pragma unroll
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int k = idx % kChunk;
      const int gk = k0 + k;
      const int ga = row0 + r;
      const int gb = col0 + r;
      as[k][r] = (ga < m && gk < kw)
          ? a[static_cast<int64_t>(ga) * kw + gk] : 0u;
      bs[k][r] = (gb < n && gk < kw)
          ? b[static_cast<int64_t>(gb) * kw + gk] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      uint32_t av[kMicro], bv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = as[k][ty + kEdge * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) bv[j] = bs[k][tx + kEdge * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) mism[i][j] += __popc(av[i] ^ bv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty + kEdge * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int c = col0 + tx + kEdge * j;
      if (c < n) out[static_cast<int64_t>(r) * n + c] = k_bits - 2 * mism[i][j];
    }
  }
}

}  // namespace

extern "C" {

int bitserial_matmul_launch(const void* a, const void* b, void* out, int m,
                            int n, int kw, int k_bits, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  xnor_popcount_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), m, n, kw, k_bits);
  return cudaGetLastError();
}

const char* bitserial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
