// Control-unit FSM of the SIMDRAM paper (Fig. 7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/uprog_executor.py::_kernel
// (pallas_call at uprog_executor.py:76): an int32[N,4] command stream
// (op, a, b, c) runs over a row file of 32-bit plane words.  Rows are
// 1-based; a negative index reads or writes the complement (the DCC port).
//   op 0, COPY: row|a| <- read(b)
//   op 1, MAJ : m = MAJ(read a, read b, read c); m is written to a, then b,
//               then c, each through its own port.
// Every word column is independent, so one thread owns one column.  Banks
// fold into the column axis: rows[bank][r][w] is column bank*W + w, and one
// launch covers every bank.
//
// What bounds it on this card: the command stream is serial within a column
// and every command is a handful of shared-memory reads and writes, so the
// kernel is bound by shared-memory latency and by how many columns are in
// flight, not by device-memory bytes (each row is read and written once).
// The design: a block of 32 threads stages its columns of the row file in
// dynamic shared memory as [row][thread] (one bank per thread: no
// conflicts), runs the whole stream there, and writes the rows back once.
// Commands live in global memory (18,177 commands of division/32 bits are
// 291 KB, beyond the 64 KB of constant memory).  Read one at a time, each
// command cost a round trip to L2 (a 32 B sector holds two commands), which
// dominated the loop; so the warp stages them in shared memory, kChunk at a
// time, with one coalesced load per lane per 32 commands, and then every
// lane reads the same staged command (a broadcast).  A 32-thread block (one
// warp) keeps the shared memory of a block small (R x 128 B + 2 KB), so
// seven blocks share an SM even at R = 235 rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // one warp: __syncwarp is the block barrier
constexpr int kChunk = 128;    // commands staged in shared memory at a time

__device__ __forceinline__ int32_t read_row(const int32_t* col, int idx) {
  const int32_t v = col[(abs(idx) - 1) * kThreads];
  return idx < 0 ? ~v : v;
}

__device__ __forceinline__ void write_row(int32_t* col, int idx, int32_t v) {
  col[(abs(idx) - 1) * kThreads] = idx < 0 ? ~v : v;
}

__global__ void __launch_bounds__(kThreads)
uprog_execute_kernel(const int4* __restrict__ cmds, int n_cmds,
                     const int32_t* __restrict__ rows,
                     int32_t* __restrict__ out, int n_rows,
                     int64_t words, int64_t columns) {
  __shared__ int4 staged[kChunk];
  extern __shared__ int32_t file[];  // [n_rows][kThreads]
  const int lane = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + lane;
  // lanes past the last column run the stream on their own (unloaded)
  // shared-memory column and store nothing: every lane joins the staging
  const bool active = col < columns;
  const int64_t bank = col / words;
  const int64_t base = bank * n_rows * words + (col - bank * words);
  int32_t* mine = file + lane;
  if (active) {
    for (int r = 0; r < n_rows; ++r) mine[r * kThreads] = rows[base + r * words];
  }
  for (int t0 = 0; t0 < n_cmds; t0 += kChunk) {
    const int n = min(kChunk, n_cmds - t0);
    __syncwarp();
    for (int i = lane; i < n; i += kThreads) staged[i] = __ldg(cmds + t0 + i);
    __syncwarp();
    for (int t = 0; t < n; ++t) {
      const int4 c = staged[t];
      if (c.x == 1) {
        const int32_t va = read_row(mine, c.y);
        const int32_t vb = read_row(mine, c.z);
        const int32_t vc = read_row(mine, c.w);
        const int32_t maj = (va & vb) | (va & vc) | (vb & vc);
        write_row(mine, c.y, maj);
        write_row(mine, c.z, maj);
        write_row(mine, c.w, maj);
      } else {
        write_row(mine, c.y, read_row(mine, c.z));
      }
    }
  }
  if (active) {
    for (int r = 0; r < n_rows; ++r) out[base + r * words] = mine[r * kThreads];
  }
}

}  // namespace

extern "C" {

// Largest row file one block can stage on ``device`` (0 on error).
int uprog_max_rows(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  bytes -= static_cast<int>(kChunk * sizeof(int4));  // the staged commands
  return bytes / static_cast<int>(kThreads * sizeof(int32_t));
}

// cmds int32[n_cmds,4]; rows, out int32[banks, n_rows, words] with
// columns = banks * words.  Indices must lie in [-n_rows, -1] U [1, n_rows]
// (the wrapper checks).  Returns the cudaError_t of the launch.
int uprog_execute_launch(const void* cmds, int n_cmds, const void* rows,
                         void* out, int n_rows, long long words,
                         long long columns, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(n_rows) * kThreads * sizeof(int32_t);
  err = cudaFuncSetAttribute(uprog_execute_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (columns + kThreads - 1) / kThreads;
  uprog_execute_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(cmds), n_cmds,
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(out), n_rows,
      words, columns);
  return cudaGetLastError();
}

const char* uprog_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
