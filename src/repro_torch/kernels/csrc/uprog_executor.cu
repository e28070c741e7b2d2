// Control-unit FSM of the SIMDRAM paper (Fig. 7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/uprog_executor.py::_kernel
// (pallas_call at uprog_executor.py:76): an int32[N,4] command stream
// (op, a, b, c) runs over a row file of 32-bit plane words.  Rows are
// 1-based; a negative index reads or writes the complement (the DCC port).
//   op 0, COPY: row|a| <- read(b)
//   op 1, MAJ : m = MAJ(read a, read b, read c); m is written to a, then b,
//               then c, each through its own port.
// Ports may alias: a MAJ may name one row twice (a == b, a == -c) and a COPY
// may write its own source; the writes land in the order above.
// Every word column is independent, so one thread owns one column.  Banks
// fold into the column axis: rows[bank][r][w] is column bank*W + w, and one
// launch covers every bank.
//
// What bounds it on this card: the command stream is serial within a column
// (a step reads what the step before it may have written), so the kernel is
// bound by the time of one step times the number of steps, not by
// device-memory bytes (each row is read and written once).  A block of 32
// threads (one warp) stages its columns of the row file in dynamic shared
// memory as [row][thread] (one bank per thread: no conflicts), runs the
// whole stream there, and writes the rows back once.  A 32-thread block
// keeps a block's shared memory small (R x 128 B + 4 KB), so six blocks
// share an SM even at R = 235 rows.
//
// The design keeps a step short and branch-free:
// - Commands are decoded once, while they are staged in shared memory:
//   each port becomes the byte offset of its row in the column file,
//   (|i| - 1) * 128, stored as ~offset for a complement port, so a step
//   reads file[off] ^ mask with mask = port >> 31, and a COPY becomes the
//   MAJ form with predicated loads and stores (see step).  No abs, select,
//   multiply or branch is left in a step, so the compiler schedules the
//   next steps' address arithmetic ahead of this step's loads.
// - Commands are fetched ahead: the next chunk's global loads are issued
//   (into registers) before the current chunk runs, and kUnroll decoded
//   commands are read from shared memory into registers before the first
//   of their steps.
// - The rows are staged with cp.async, every row's copy in flight at once.
// What is left per step: three row loads (one for a COPY), one LOP3 between
// two XORs with the port masks, three stores (one).  Issuing a step's loads
// before the previous step's stores where they do not alias, predicated or
// with the previous MAJ forwarded in a register, measured slower on the
// H100: the extra instructions cost more than the overlap saved.
// Commands live in global memory (18,177 commands of division/32 bits are
// 291 KB, beyond the 64 KB of constant memory).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;                  // one warp: __syncwarp is the
                                              // block barrier
constexpr int kRowBytes = kThreads * 4;       // one row of the column file
constexpr int kChunk = 256;                   // commands staged at a time
constexpr int kPerLane = kChunk / kThreads;   // raw commands a lane fetches
constexpr int kUnroll = 16;                   // steps read ahead at once
static_assert(kChunk % kUnroll == 0, "a chunk holds whole unrolled groups");

// A port as a step uses it: the byte offset of its row in the column file,
// bit-inverted for a complement port (offsets are >= 0, so the sign is the
// complement flag).
__device__ __forceinline__ int encode_port(int idx) {
  const int off = (abs(idx) - 1) * kRowBytes;
  return idx < 0 ? ~off : off;
}

// Command t, raw.  Past the stream's end the command is COPY row 1 <- row
// 1, which changes nothing: every unrolled group runs whole.
__device__ __forceinline__ int4 fetch(const int4* __restrict__ cmds, int n,
                                      int t) {
  return t < n ? __ldg(cmds + t) : make_int4(0, 1, 1, 1);
}

// (op, a, b, c) -> (port 0, port 1, port 2, is_copy).  A MAJ keeps its
// ports (a, b, c).  A COPY a <- b becomes ports (b, b, a): the step reads
// port 0 only and writes port 2 only (see step).
__device__ __forceinline__ int4 decode(int4 c) {
  return c.x == 1
      ? make_int4(encode_port(c.y), encode_port(c.z), encode_port(c.w), 0)
      : make_int4(encode_port(c.z), encode_port(c.z), encode_port(c.y), 1);
}

// One 4-byte word from device memory to shared memory, not through
// registers (cp.async; completes at the next cp.async.wait_group).
__device__ __forceinline__ void copy_async(unsigned dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One command on this thread's column; ``file`` is the shared address of
// the column in row 1.  Branch-free:
//   x_k = read(port k); m = MAJ(x0, x1, x2); write m to ports 0, 1, 2.
// A COPY (is_copy) predicates off the loads of ports 1 and 2 and the writes
// of ports 0 and 1, with x1 = ~0 and x2 = 0, so m = MAJ(x0, ~0, 0) = x0 is
// the source read through its port, written through the destination's.
__device__ __forceinline__ void step(unsigned file, int4 d) {
  const int m0 = d.x >> 31, m1 = d.y >> 31, m2 = d.z >> 31;
  const unsigned a0 = file + (d.x ^ m0);
  const unsigned a1 = file + (d.y ^ m1);
  const unsigned a2 = file + (d.z ^ m2);
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      ".reg .b32 x0, x1, x2;\n\t"
      "setp.eq.s32 p, %6, 0;\n\t"
      "mov.b32 x1, 0xffffffff;\n\t"
      "mov.b32 x2, 0;\n\t"
      "ld.shared.b32 x0, [%0];\n\t"
      "@p ld.shared.b32 x1, [%1];\n\t"
      "@p ld.shared.b32 x2, [%2];\n\t"
      "xor.b32 x0, x0, %3;\n\t"
      "@p xor.b32 x1, x1, %4;\n\t"
      "@p xor.b32 x2, x2, %5;\n\t"
      "lop3.b32 x0, x0, x1, x2, 0xE8;\n\t"
      "xor.b32 x1, x0, %4;\n\t"
      "xor.b32 x2, x0, %5;\n\t"
      "xor.b32 x0, x0, %3;\n\t"
      "@p st.shared.b32 [%0], x0;\n\t"
      "@p st.shared.b32 [%1], x1;\n\t"
      "st.shared.b32 [%2], x2;\n\t"
      "}" ::"r"(a0), "r"(a1), "r"(a2), "r"(m0), "r"(m1), "r"(m2), "r"(d.w)
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
uprog_execute_kernel(const int4* __restrict__ cmds, int n_cmds,
                     const int32_t* __restrict__ rows,
                     int32_t* __restrict__ out, int n_rows,
                     int64_t words, int64_t columns) {
  __shared__ int4 staged[kChunk];    // decoded commands
  extern __shared__ int32_t file[];  // [n_rows][kThreads]
  const int lane = threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + lane;
  // lanes past the last column run the stream on their own (unloaded)
  // shared-memory column and store nothing: every lane joins the staging
  const bool active = col < columns;
  const int64_t bank = col / words;
  const int64_t base = bank * n_rows * words + (col - bank * words);
  const unsigned mine = static_cast<unsigned>(__cvta_generic_to_shared(file))
                        + lane * 4;
  if (active) {                      // every row's copy in flight at once
    for (int r = 0; r < n_rows; ++r) {
      copy_async(mine + r * kRowBytes, rows + base + r * words);
    }
  }
  int4 next[kPerLane];               // the next chunk, raw
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    next[k] = fetch(cmds, n_cmds, lane + k * kThreads);
  }
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::
               : "memory");
  for (int t0 = 0; t0 < n_cmds; t0 += kChunk) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      staged[lane + k * kThreads] = decode(next[k]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      next[k] = fetch(cmds, n_cmds, t0 + kChunk + lane + k * kThreads);
    }
    const int n = min(kChunk, n_cmds - t0);
    for (int t = 0; t < n; t += kUnroll) {
      int4 d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d[u] = staged[t + u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) step(mine, d[u]);
    }
  }
  if (active) {
#pragma unroll 8
    for (int r = 0; r < n_rows; ++r) {
      out[base + r * words] = file[r * kThreads + lane];
    }
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
  return bytes / kRowBytes;
}

// cmds int32[n_cmds,4]; rows, out int32[banks, n_rows, words] with
// columns = banks * words.  Indices must lie in [-n_rows, -1] U [1, n_rows]
// (the wrapper checks).  Returns the cudaError_t of the launch.
int uprog_execute_launch(const void* cmds, int n_cmds, const void* rows,
                         void* out, int n_rows, long long words,
                         long long columns, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(n_rows) * kRowBytes;
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
