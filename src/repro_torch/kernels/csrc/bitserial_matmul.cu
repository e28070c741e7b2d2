// XNOR-NET binarized matmul (the paper's application kernels) for Hopper
// (sm_90a), on the INT8 tensor cores through wgmma.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitserial_matmul.py::
// _kernel (pallas_call at src/repro/kernels/bitserial_matmul.py:58):
//   out[i, j] = k_bits - 2 * sum_w popcount(a[i, w] ^ b[j, w])
// over sign-packed words (bit 1 = +1, bit 0 = -1), a int32[M, Kw] and
// b int32[N, Kw], both row-major, so both are K-contiguous (an "NT"
// product).  The words are the port's int32 plane words; the kernel reads
// them as unsigned, so bit 31 is just a bit.
//
// Formulation.  With x in {0, 1} the bits and s = 2x - 1 the signs,
//   k_bits - 2 * popcount(a ^ b) = sum_k s_a * s_b
//     = 4 * sum_k x_a * x_b - 2 * P_a - 2 * P_b + K,
// where P_a = popcount of a's row and P_b of b's row.  The first sum D is
// a u8 x u8 -> s32 matmul of 0/1 bytes, which the tensor cores run:
// wgmma.mma_async m64n128k32.s32.u8.u8, one packed word a k32 step.  P_a
// and P_b are popcounts of the staged words, 2 a row and k-tile.  The
// result is computed modulo 2^32 (4 * D may pass 2^31; the result,
// |out| <= K < 2^31, does not), so it is exact in int32.
//
// What bounds it on this card: the INT8 tensor cores, 2*M*N*K operations
// at 1,979 TOPS (H100 SXM data sheet): 0.0266 ms at the VGG-16 FC6 shape
// (256 x 4,096 x 25,088), against 0.0053 ms for the packed bytes.  Feeding
// them costs integer instructions (a Hopper SM runs 64 integer results a
// clock, half its FP32 rate) and shared-memory bandwidth: B's bytes are
// written once and read by both consumer warpgroups, about as many bytes
// a k-tile as the tensor cores take cycles.  What the design does:
//  * the operands stay packed in device memory (32x fewer bytes than
//    int8), staged k-tile by k-tile (kBk words) with cp.async into a ring
//    of kStages slots, kAhead tiles ahead;
//  * the sum over k may run in any order, so long as A and B use the same
//    one.  Byte j of the k32 step's bytes 4t..4t+3 is bit t + 8j of the
//    word, and of bytes 16+4t..16+4t+3 bit t + 4 + 8j (t = 0..3):
//    spread(w, s) = (w >> s) & 0x01010101 gives four bytes in two integer
//    instructions;
//  * the block is warp-specialised.  Two producer warpgroups load the
//    tiles, count the rows' bits and expand B (the block's 128 rows of b)
//    to 0/1 bytes in shared memory, in wgmma's K-major layout with the
//    128-byte swizzle (atoms of 8 rows x 128 bytes, four k32 steps), into
//    two buffers.  Two consumer warpgroups expand A (the block's 128 rows
//    of a, 64 each) into registers and issue wgmma.mma_async m64n128k32.
//    Named barriers hand each buffer over, full and empty, so the
//    producers expand tile it + 1 while the tensor cores run tile it;
//  * A's register fragment (wgmma m64nNk32, as mma.m16n8k32; PTX ISA,
//    "Register Fragments"): the thread with group = lane / 4 and
//    t = lane % 4 of warp q holds rows 16q + group and 16q + group + 8 at
//    k = 4t + j (registers 0, 1) and k = 16 + 4t + j (registers 2, 3):
//    spread(w, t) and spread(w, t + 4) of its two words;
//  * the grid fills the card: 128 x 128 output tiles, one 512-thread block
//    an SM (128 registers a thread), and where the tiles are fewer than the
//    SMs the K axis is split across blocks (blockIdx.z, at most kMaxSplit);
//    the host plans the split (bitserial_matmul.py::launch_plan);
//  * the splits of one tile run as one thread-block cluster.  Each stores
//    its partial sums of every row into the shared memory of the split
//    that owns the row (distributed shared memory); after one cluster
//    barrier each owner adds its rows and writes them with 16-byte stores.
//    No zeroing, no atomics, and the sum runs in a fixed order.
//
// The traps.  A word of zeros is 32 x (-1) in the +-1 form; here it is 32
// zero bytes, and the constant term counts only the words below Kw
// (32 * words of the split), so the zeros that fill k-tiles beyond Kw add
// nothing.  Rows beyond M or N are staged as zeros and their outputs are
// not written.  The output must be 16-byte aligned for the 16-byte stores
// (a fresh torch allocation is).  Bit 31 is an ordinary bit: words are
// read as unsigned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;                   // output tile edge (M and N)
constexpr int kConsumers = 256;              // two warpgroups: A, wgmma
constexpr int kProducers = 256;              // two: loads, B, popcounts
constexpr int kThreads = kConsumers + kProducers;
constexpr int kAhead = 2;                    // tiles loaded ahead
constexpr int kBk = 8;                       // packed words a k-tile
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kAcc = 64;                     // m64n128 s32: 64 a thread
constexpr int kSlotWords = 2 * kTile * kBk;  // a and b words of one slot
constexpr int kAtomBytes = kTile * 128;      // B bytes of 4 k32 steps
constexpr int kBexpBytes = kBk * kTile * 32; // B bytes of one k-tile
constexpr int kSbo = 1024;                   // 8-row groups of an atom
constexpr int kMaxSplit = 8;                 // splits: one cluster a tile
constexpr int kMaxDevices = 64;              // kernel attribute set once each
constexpr int kRecvStride = kTile + 8;       // receive row, words
constexpr int kRecvRows = kTile + kMaxSplit; // >= split * ceil(128 / split)
constexpr int kSmemBytes = kStages * kSlotWords * 4 + 2 * kBexpBytes
                           + kRecvRows * kRecvStride * 4 + 2 * kTile * 4
                           + 1024;           // + B's 1 KB alignment

// bits s, s + 8, s + 16, s + 24 of w -> bytes 0..3 of 0 or 1
__device__ __forceinline__ uint32_t spread(uint32_t w, int s) {
  return (w >> s) & 0x01010101u;
}

// wgmma descriptor of B for k32 step s of a k-tile at `bt`: K-major with
// the 128-byte swizzle (layout type 1), 8-row groups kSbo apart; the step
// starts 32 s bytes into its atom, and the hardware swizzles the address
__device__ __forceinline__ uint64_t b_desc(const unsigned char* bt, int s) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      bt + (s / 4) * kAtomBytes + (s % 4) * 32));
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
         | (static_cast<uint64_t>(1) << 16)              // LBO: unused
         | (static_cast<uint64_t>(kSbo >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);             // 128B swizzle
}

__device__ __forceinline__ void wgmma_u8(int32_t (&d)[kAcc],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// Registers an in-flight wgmma reads or writes: the compiler must neither
// move their reads before the wait nor reuse them before it.
template <typename T, int N>
__device__ __forceinline__ void hold(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <typename T, int N, int M>
__device__ __forceinline__ void hold_rows(T (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hold(r[i]);
}

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         bool valid, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;           // 0: fill with zeros
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Word kk of staged row r sits at r * kBk + (kk ^ swizzle(r)): the eight
// rows a warp reads at one kk (rows 8 apart or consecutive) then hit eight
// different banks.
__device__ __forceinline__ int swizzle(int r) { return ((r >> 2) & 1) * 4; }

// Stage k-tile `kt` of the block's rows of a and b into `slot`, with the
// kN threads numbered `lt` (the producer warpgroup).  kVec words a copy (4
// when Kw % 4 == 0 and both bases are 16-byte aligned, else 1); rows beyond
// M or N and words beyond Kw are filled with zeros.
template <int kVec, int kN>
__device__ __forceinline__ void load_tile(uint32_t* slot,
                                          const uint32_t* __restrict__ a,
                                          const uint32_t* __restrict__ b,
                                          int m, int n, int kw, int row0,
                                          int col0, int kt, int lt) {
  constexpr int kPerRow = kBk / kVec;
  constexpr int kCopies = 2 * kTile * kPerRow;
  static_assert(kCopies % kN == 0, "whole copies a thread");
  const int k0 = kt * kBk;
#pragma unroll
  for (int c = 0; c < kCopies / kN; ++c) {
    const int idx = c * kN + lt;
    const int side = idx / (kTile * kPerRow);         // 0: a, 1: b
    const int r = (idx / kPerRow) % kTile;
    const int kk = (idx % kPerRow) * kVec;
    const int g = (side ? col0 : row0) + r;
    const int gk = k0 + kk;
    const bool valid = g < (side ? n : m) && gk < kw;
    const uint32_t* base = side ? b : a;
    const uint32_t* src = valid ? base + static_cast<int64_t>(g) * kw + gk
                                : base;
    uint32_t* dst = slot + side * kTile * kBk + r * kBk + (kk ^ swizzle(r));
    cp_async(dst, src, valid, 4 * kVec);
  }
}

// Named barriers (0 is __syncthreads): kFull + c, "B bytes of buffer c and
// their ring slot are in"; kEmpty + c, "buffer c and its slot are free";
// kProducer, the producer warpgroup alone.
constexpr int kFull = 1;
constexpr int kEmpty = 3;
constexpr int kProducer = 5;

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
xnor_wgmma_kernel(const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                  int m, int n, int kw, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  // B's swizzle atoms need 1024-byte alignment
  unsigned char* bexp = smem + kStages * kSlotWords * 4;
  bexp += (1024 - static_cast<uint32_t>(__cvta_generic_to_shared(bexp)) % 1024)
          % 1024;
  int32_t* recv = reinterpret_cast<int32_t*>(bexp + 2 * kBexpBytes);
  int32_t* pops = recv + kRecvRows * kRecvStride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int k_tiles = (kw + kBk - 1) / kBk;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nt = min(tiles_per_split, k_tiles - kt0);
  // the cluster's blocks must all run before one writes into another's
  // shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  int32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  // consumer thread's A rows: warpgroup (warp / 4) owns rows 64 (warp / 4)
  // .., warp q = warp % 4 of it rows 16 q .. 16 q + 15
  const int a_row = warp * 16 + group;

  if (warp >= kConsumers / 32) {
    // -- producer warpgroups: loads, B's bytes, row popcounts ---------------
    const int lt = tid - kConsumers;          // 0 .. kProducers - 1
    const int pw = lt >> 5;                   // producer warp
    int pop = 0;                  // staged row lt: a's rows, then b's
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s < nt) load_tile<kVec, kProducers>(ring + s * kSlotWords, a, b, m,
                                              n, kw, row0, col0, kt0 + s, lt);
      cp_async_commit();
    }
    for (int it = 0; it < nt; ++it) {
      const int c = it & 1;
      if (it >= 2) named_sync(kEmpty + c, kThreads);   // tile it - 2 is done
      if (it + kAhead < nt)
        load_tile<kVec, kProducers>(ring + ((it + kAhead) % kStages) *
                                    kSlotWords, a, b, m, n, kw, row0, col0,
                                    kt0 + it + kAhead, lt);
      cp_async_commit();
      cp_async_wait<kAhead>();                 // this thread's part of tile it
      named_sync(kProducer, kProducers);       // ... and everyone's
      const uint32_t* as = ring + (it % kStages) * kSlotWords;
      const uint32_t* bs = as + kTile * kBk;
      {  // words beyond Kw are zeros: they add nothing to any sum
        const uint4* row = reinterpret_cast<const uint4*>(as + lt * kBk);
#pragma unroll
        for (int q = 0; q < kBk / 4; ++q) {
          const uint4 x = row[q];
          pop += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
        }
      }
      // B: word s of row n -> the 32 bytes of k32 step s in row n of atom
      // s / 4: 16-byte chunks 2 (s % 4) and 2 (s % 4) + 1 of the row's 128,
      // each at chunk ^ (n % 8) (the 128-byte swizzle).  A quarter-warp
      // takes rows 8g .. 8g + 7 of one step (eight chunks of banks on the
      // write), the four quarters four steps (distinct banks on the read).
      unsigned char* bt = bexp + c * kBexpBytes;
#pragma unroll
      for (int q = 0; q < kTile * kBk / kProducers; ++q) {
        const int gr = pw * (kTile / 8) / (kProducers / 32)
                       + (q >> 1);                         // 8-row group
        const int nrow = gr * 8 + (lane & 7);
        const int s = (q & 1) * 4 + (lane >> 3);
        const uint32_t w = bs[nrow * kBk + (s ^ swizzle(nrow))];
        unsigned char* row = bt + (s / 4) * kAtomBytes + nrow * 128;
        const int chunk = 2 * (s % 4);
        *reinterpret_cast<uint4*>(row + ((chunk ^ (nrow & 7)) << 4)) =
            make_uint4(spread(w, 0), spread(w, 1), spread(w, 2),
                       spread(w, 3));
        *reinterpret_cast<uint4*>(row + (((chunk + 1) ^ (nrow & 7)) << 4)) =
            make_uint4(spread(w, 4), spread(w, 5), spread(w, 6),
                       spread(w, 7));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_arrive(kFull + c, kThreads);
    }
    cp_async_wait<0>();
    pops[lt] = pop;               // [0, 128): rows of a; [128, 256): of b
  } else {
    // -- consumer warpgroups: A's registers and the products ----------------
    uint32_t af[kBk][4];
    for (int it = 0; it < nt; ++it) {
      const int c = it & 1;
      named_sync(kFull + c, kThreads);         // tile it's B bytes are in
      const uint32_t* as = ring + (it % kStages) * kSlotWords;
      // the row's 8 words are contiguous, its two 4-word halves swapped by
      // swizzle(row): load the half holding words 0..3 first
      const int h = swizzle(group) >> 2;
      const uint4* r0 = reinterpret_cast<const uint4*>(as + a_row * kBk);
      const uint4* r1 = reinterpret_cast<const uint4*>(as + (a_row + 8) * kBk);
      const uint4 x[2] = {r0[h], r0[1 - h]};
      const uint4 y[2] = {r1[h], r1[1 - h]};
      wgmma_wait<0>();                         // tile it - 1's products done
      hold(acc);
      hold_rows(af);
      // tile it - 1's buffer and slot are free: tell the producer, if it
      // will wait for them (it waits for tiles 0 .. nt - 3)
      if (it >= 1 && it + 1 < nt) named_arrive(kEmpty + (1 - c), kThreads);
#pragma unroll
      for (int s = 0; s < kBk; ++s) {
        const uint4& xs = x[s / 4];
        const uint4& ys = y[s / 4];
        const uint32_t w0 = s % 4 == 0 ? xs.x : s % 4 == 1 ? xs.y
                          : s % 4 == 2 ? xs.z : xs.w;
        const uint32_t w1 = s % 4 == 0 ? ys.x : s % 4 == 1 ? ys.y
                          : s % 4 == 2 ? ys.z : ys.w;
        af[s][0] = spread(w0, t);
        af[s][1] = spread(w1, t);
        af[s][2] = spread(w0, t + 4);
        af[s][3] = spread(w1, t + 4);
      }
      hold_rows(af);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBk; ++s)
        wgmma_u8(acc, af[s], b_desc(bexp + c * kBexpBytes, s));
      wgmma_commit();
    }
    wgmma_wait<0>();
    hold(acc);
    hold_rows(af);
  }
  __syncthreads();               // the popcounts are in
  // K of this split: 32 x its words below Kw
  const uint32_t k_split =
      32u * static_cast<uint32_t>(min(kw, (kt0 + nt) * kBk) - kt0 * kBk);

  // The splits of this tile are one cluster (1 x 1 x split).  Split
  // `rank` owns rows [rank * chunk, (rank + 1) * chunk) of the tile: every
  // split stores its partial sums of those rows into the owner's receive
  // buffer (distributed shared memory; row src * chunk + row - owner *
  // chunk, kRecvStride words apart: a warp's 8-byte stores take two
  // wavefronts), and after one cluster barrier each owner adds its rows
  // from its own shared memory and writes them.
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = (kTile + splits - 1) / splits;

  if (warp < kConsumers / 32) {
    // accumulator layout: for columns 8c .. 8c + 7, acc[4c], acc[4c + 1] at
    // row group, columns 8c + 2t, 8c + 2t + 1; acc[4c + 2], acc[4c + 3] at
    // row group + 8.  out = 4 D - 2 P_a - 2 P_b + K, modulo 2^32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = a_row + 8 * h;
      const uint32_t row_term =
          k_split - 2u * static_cast<uint32_t>(pops[rl]);
      const int owner = rl / chunk;
      int32_t* dst = cluster.map_shared_rank(recv, owner)
                     + (rank * chunk + rl - owner * chunk) * kRecvStride;
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        const int cl = 8 * c + 2 * t;
        int32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = static_cast<int32_t>(
              4u * static_cast<uint32_t>(acc[4 * c + 2 * h + e]) + row_term
              - 2u * static_cast<uint32_t>(pops[kTile + cl + e]));
        *reinterpret_cast<int2*>(dst + cl) = make_int2(v[0], v[1]);
      }
    }
  }
  cluster.sync();                // every split's rows are in their owners

  const int rows = min(kTile, m - row0);
  const int cols = min(kTile, n - col0);
  const int r_begin = rank * chunk;
  const int r_end = min(rows, r_begin + chunk);
  constexpr int kWarps = kThreads / 32;
  if (n % 4 == 0 && cols % 4 == 0) {
    // a warp a row, 16 bytes a lane (out is 16-byte aligned, n % 4 == 0)
    const int c = 4 * lane;
    for (int r = r_begin + warp; r < r_end; r += kWarps) {
      if (c >= cols) continue;
      int4 sum = make_int4(0, 0, 0, 0);
      for (int p = 0; p < splits; ++p) {
        const int4 x = *reinterpret_cast<const int4*>(
            recv + (p * chunk + r - r_begin) * kRecvStride + c);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      *reinterpret_cast<int4*>(out + static_cast<int64_t>(row0 + r) * n
                               + col0 + c) = sum;
    }
  } else {
    for (int r = r_begin + warp; r < r_end; r += kWarps) {
      for (int c = lane; c < cols; c += 32) {
        int32_t sum = 0;
        for (int p = 0; p < splits; ++p)
          sum += recv[(p * chunk + r - r_begin) * kRecvStride + c];
        out[static_cast<int64_t>(row0 + r) * n + col0 + c] = sum;
      }
    }
  }
}

template <int kVec>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int32_t* out, int m,
                   int n, int kw, int tiles_per_split, dim3 grid,
                   cudaStream_t s, int device) {
  // the opt-in shared memory size, once a device
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        xnor_wgmma_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;     // the splits of one tile
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, xnor_wgmma_kernel<kVec>, a, b, out, m, n, kw, tiles_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// out: 16-byte aligned (a fresh torch allocation is).  split: at most
// kMaxSplit (the portable cluster size).
int bitserial_matmul_launch(const void* a, const void* b, void* out, int m,
                            int n, int kw, int split, int tiles_per_split,
                            int vec, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, split);
  if (grid.y > 65535 || split < 1 || split > kMaxSplit)
    return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<int32_t*>(out);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  return vec == 4
      ? launch<4>(pa, pb, po, m, n, kw, tiles_per_split, grid, s, device)
      : launch<1>(pa, pb, po, m, n, kw, tiles_per_split, grid, s, device);
}

const char* bitserial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
