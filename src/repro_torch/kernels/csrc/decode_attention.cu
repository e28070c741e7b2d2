// One-token GQA attention over a KV cache, for Hopper (sm_90a): a split-KV
// ("flash-decoding") pass and a combine pass.
//
// Replaces no Pallas kernel: the reference attends with jnp einsums.  It was
// added because the port's eager einsums over a (B, T, KV, hd) cache
// ("bskgd,btkd->bkgst", then "bkgst,btkd->bskgd") cannot run as one strided
// batched GEMM over (b, kv), so each made a contiguous copy of K and V over
// the whole cache, every layer and every one-token step, and then read the
// copies again.  This kernel reads the cache where it lies, reads only the
// written positions, and keeps the scores and the softmax in registers.
//
// What bounds it on this card: device-memory bytes.  A call has to read each
// written K and V row once, 2 * B * len * KV * hd * 2 bytes (OLMoE-1B-7B's
// decode at 3,138 positions: 411 MB a layer, 0.123 ms at 3.35 TB/s); the
// queries, the float32 partials (B * H * parts * (hd + 2) * 4 bytes, a few
// MB) and the output are small beside it.  One query per KV head (g = 1)
// needs 2 FMAs a loaded element, far under what the SMs offer; g = 16 (the
// 32/2 heads of Nemotron 3 Nano) needs 32 FLOP a byte, still under the FMA
// pipes' 67 TFLOP/s against 3.35 TB/s (20 FLOP a byte, with the shuffles
// and exponentials on top), so the products are float32 FMAs on the CUDA
// cores: no tensor-core tile would be filled by 1-16 queries, and FMAs keep
// the arithmetic in float32 from the loaded bf16 values on.
//
// Design.
// - Grid (blocks of key splits, KV heads x query groups, batch); a block is
//   4 warps.  Warps split a KV head's g queries (q_slices of them, each a
//   warp's q_per_warp queries) and the block's keys (k_slices, one warp's
//   share each): 4 = q_slices * k_slices.  So with g = 1 four warps read
//   four parts of the keys, and with g >= 4 four warps read the same keys
//   for four slices of the queries (the other three read them from L1/L2).
//   Every warp writes its own float32 partial (m, l, acc) of its queries
//   over its keys: n_parts = blocks of key splits * k_slices a head.
// - The number of valid keys is len = base + *pos (the graph's device
//   position, + 1) or base (a host length), clamped to [0, t_cap], read by
//   every warp at the start; a warp's keys are its ceil(len / n_parts)
//   share, so one recorded graph serves every position, the splits stay
//   balanced at any length, and no key at or past len is read.  A warp with
//   no keys writes an empty partial (m = -inf, l = 0, acc = 0).
// - Inside a warp, lanes_per_key lanes (a power of two >= hd / 8) hold one
//   key row, 8 elements (one 16-byte load) a lane; 32 / lanes_per_key keys
//   are loaded side by side, U such groups of keys in flight before any is
//   used.  Scores are float32 dot products reduced over the key's lanes by
//   xor shuffles, in the log2 domain (the scale times log2 e folded into
//   the queries); an online softmax with one max update a U-group keeps
//   (m, l, acc) per lane group, and the groups merge by shuffles at the end.
// - The combine kernel merges a head's n_parts partials and writes the
//   output in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCombineThreads = 64;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// exp2 of (x - m) where m is a running max that may still be -inf (no key
// seen): then every x is -inf too and the weight is 0, not NaN.
__device__ __forceinline__ float safe_max(float m) {
  return m == -INFINITY ? 0.f : m;
}

struct Shape {
  long long q_sb, q_sh;       // query strides (elements): batch, head
  long long k_sb, k_st;       // key cache strides: batch, position
  long long v_sb, v_st;       // value cache strides: batch, position
  int n_heads, g, hd;
  int lanes_per_key, q_slices, k_slices, q_groups, n_parts;
  int base, t_cap;
  float scale_log2;           // hd^-0.5 * log2(e)
};

template <int QW, int U>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const long long* __restrict__ pos,
                         float* __restrict__ part_ml,
                         float* __restrict__ part_acc, const Shape s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qs = warp % s.q_slices;
  const int ks = warp / s.q_slices;
  const int kvh = blockIdx.y / s.q_groups;
  const int qg = blockIdx.y % s.q_groups;
  const int b = blockIdx.z;
  const int part = blockIdx.x * s.k_slices + ks;

  long long len = s.base + (pos != nullptr ? *pos : 0);
  len = len < 0 ? 0 : (len > s.t_cap ? s.t_cap : len);
  const long long share = (len + s.n_parts - 1) / s.n_parts;
  const long long k0 = part * share;
  const long long k1 = k0 + share < len ? k0 + share : len;

  const int L = s.lanes_per_key;
  const int kpw = 32 / L;                 // keys side by side in a warp
  const int grp = lane / L;
  const int d0 = (lane % L) * 8;
  const bool on = d0 < s.hd;              // lanes past hd hold zeros
  const int j0 = (qg * s.q_slices + qs) * QW;

  const bf16* kb = k + b * s.k_sb + static_cast<long long>(kvh) * s.hd + d0;
  const bf16* vb = v + b * s.v_sb + static_cast<long long>(kvh) * s.hd + d0;

  float qf[QW][8];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int j = j0 + i;
    if (on && j < s.g) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + b * s.q_sb + static_cast<long long>(kvh * s.g + j) * s.q_sh + d0);
      unpack8(u, qf[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[i][e] *= s.scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[i][e] = 0.f;
    }
  }

  float m[QW], l[QW], acc[QW][8];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }

  // the loop's bounds are the warp's: every lane runs every iteration, so
  // the shuffles always see the whole warp
  for (long long t0 = k0; t0 < k1; t0 += kpw * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long t = t0 + u * kpw + grp;
      if (on && t < k1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + t * s.k_st));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + t * s.v_st));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float sc[U][QW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[i][e], kf[e], d);
        sc[u][i] = d;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < QW; ++i)
          sc[u][i] += __shfl_xor_sync(kFull, sc[u][i], off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u * kpw + grp >= k1) {
#pragma unroll
        for (int i = 0; i < QW; ++i) sc[u][i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][i]);
      const float corr = exp2f(m[i] - safe_max(mx));
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(vr[u], vf);
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const float p = exp2f(sc[u][i] - safe_max(m[i]));
        l[i] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
      }
    }
  }

  // merge the warp's lane groups (each saw every kpw-th key)
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const float mo = __shfl_xor_sync(kFull, m[i], off);
      const float lo = __shfl_xor_sync(kFull, l[i], off);
      const float mx = fmaxf(m[i], mo);
      const float a = exp2f(m[i] - safe_max(mx));
      const float c = exp2f(mo - safe_max(mx));
      m[i] = mx;
      l[i] = l[i] * a + lo * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[i][e], off);
        acc[i][e] = acc[i][e] * a + ao * c;
      }
    }
  }

  if (grp != 0 || !on) return;
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    const int j = j0 + i;
    if (j >= s.g) break;
    const long long row =
        (static_cast<long long>(b) * s.n_heads + kvh * s.g + j) * s.n_parts +
        part;
    float4* dst = reinterpret_cast<float4*>(part_acc + row * s.hd + d0);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    if (d0 == 0) {
      part_ml[2 * row] = m[i];
      part_ml[2 * row + 1] = l[i];
    }
  }
}

// One thread a (batch, head, 8 output elements): the head's n_parts
// partials merged under their common max.  rows = B * H.
__global__ void __launch_bounds__(kCombineThreads)
decode_attn_combine_kernel(const float* __restrict__ part_ml,
                           const float* __restrict__ part_acc,
                           bf16* __restrict__ out, long long rows, int n_parts,
                           int hd) {
  const int per_row = hd / 8;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= rows * per_row) return;
  const long long row = idx / per_row;
  const int d0 = static_cast<int>(idx % per_row) * 8;
  const float* ml = part_ml + row * n_parts * 2;
  float mx = -INFINITY;
  for (int p = 0; p < n_parts; ++p) mx = fmaxf(mx, ml[2 * p]);
  float l = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = 0; p < n_parts; ++p) {
    const float mp = ml[2 * p];
    if (mp == -INFINITY) continue;        // a part that saw no key
    const float w = exp2f(mp - mx);
    l += ml[2 * p + 1] * w;
    const float4* src = reinterpret_cast<const float4*>(
        part_acc + (row * n_parts + p) * hd + d0);
    const float4 a = src[0], c = src[1];
    acc[0] += a.x * w; acc[1] += a.y * w; acc[2] += a.z * w; acc[3] += a.w * w;
    acc[4] += c.x * w; acc[5] += c.y * w; acc[6] += c.z * w; acc[7] += c.w * w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] *= inv;
  *reinterpret_cast<uint4*>(out + row * hd + d0) = pack8(acc);
}

template <int QW, int U>
cudaError_t launch_split(dim3 grid, cudaStream_t stream, const void* q,
                         const void* k, const void* v, const void* pos,
                         void* part_ml, void* part_acc, const Shape& s) {
  decode_attn_split_kernel<QW, U><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const long long*>(pos),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), s);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* part_ml, void* part_acc, const void* pos,
                   const Shape& s, int q_per_warp, int batch, int n_kv,
                   int splits, cudaStream_t stream) {
  const dim3 grid(splits, n_kv * s.q_groups, batch);
  cudaError_t err;
  switch (q_per_warp) {
    // fewer keys in flight as the queries a lane holds grow (registers)
    case 1: err = launch_split<1, 4>(grid, stream, q, k, v, pos, part_ml, part_acc, s); break;
    case 2: err = launch_split<2, 4>(grid, stream, q, k, v, pos, part_ml, part_acc, s); break;
    case 4: err = launch_split<4, 2>(grid, stream, q, k, v, pos, part_ml, part_acc, s); break;
    case 8: err = launch_split<8, 1>(grid, stream, q, k, v, pos, part_ml, part_acc, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(batch) * s.n_heads;
  const long long threads = rows * (s.hd / 8);
  const unsigned blocks =
      static_cast<unsigned>((threads + kCombineThreads - 1) / kCombineThreads);
  decode_attn_combine_kernel<<<blocks, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<bf16*>(out), rows, s.n_parts, s.hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, 1, H, hd), k and v (B, T, KV, hd) with their last two dimensions
// contiguous and the strides given in elements; out (B, 1, H, hd)
// contiguous; part_ml float32[B * H * n_parts * 2], part_acc
// float32[B * H * n_parts * hd] with n_parts = splits * k_slices; pos an
// int64 device pointer or null; every tensor but the partials bf16.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, void* part_ml, void* part_acc,
                            const void* pos, int base, int t_cap,
                            long long q_sb, long long q_sh, long long k_sb,
                            long long k_st, long long v_sb, long long v_st,
                            int batch, int n_heads, int n_kv, int hd,
                            int lanes_per_key, int q_slices, int k_slices,
                            int q_per_warp, int q_groups, int splits,
                            float scale, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  if (q_slices * k_slices != kWarps || hd % 8 != 0 || hd > 256 ||
      lanes_per_key * 8 < hd || lanes_per_key > 32 || n_heads % n_kv != 0)
    return cudaErrorInvalidValue;
  Shape s;
  s.q_sb = q_sb; s.q_sh = q_sh;
  s.k_sb = k_sb; s.k_st = k_st;
  s.v_sb = v_sb; s.v_st = v_st;
  s.n_heads = n_heads; s.g = n_heads / n_kv; s.hd = hd;
  s.lanes_per_key = lanes_per_key; s.q_slices = q_slices;
  s.k_slices = k_slices; s.q_groups = q_groups;
  s.n_parts = splits * k_slices;
  s.base = base; s.t_cap = t_cap;
  s.scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(q, k, v, out, part_ml, part_acc, pos, s, q_per_warp, batch,
                n_kv, splits, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
