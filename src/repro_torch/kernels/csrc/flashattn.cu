// flashattn — attention forward with an online softmax, sm_90a.
//
// Replaces: src/repro/kernels/flashattn.py, `_flash_kernel` reached through
// `flash_attention` / `flash_attention_bshd` (grid (batch·heads, q blocks,
// kv blocks) with the kv axis sequential, carrying the running max,
// denominator and accumulator in VMEM scratch across grid steps).
//
// Function, per (bh, query row r), with q, k, v read as f32:
//   s_j = (q_r · k_j) * scale, scale = f32(1/sqrt(dh)); causal: s_j = -1e30
//   where j > r; softmax over j with a running max m, denominator l and
//   accumulator acc, all f32; out_r = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100 SXM: arithmetic.  2·BH·S·Sk·dh FLOPs (halved
// when causal) against q, k, v and o read or written once: at tinyllama's
// training shape (BH 128, S 2048, dh 64, bf16) 6.87e10 FLOPs causal, 69.5 us
// at the dense bf16 tensor-core peak, against 134 MB, 40 us at 3.35 TB/s.
//
// Design: a first, simple kernel, far from that bound.  There is no
// sequential grid axis on Hopper, so each CTA owns one (bh, 64-row query
// tile) and walks the kv axis in a loop, with one query row per thread:
// the row's q, running max, denominator and dh-wide accumulator live in
// that thread's registers, so the softmax needs no communication between
// threads.  K and V go through shared memory 32 keys at a time, upcast to
// f32 on the way in; every thread reads the same key row (a broadcast, no
// bank conflicts) with 16-byte loads, four FMAs per load.  The products run
// in f32 FMA on the CUDA cores, so p stays f32 in p·v as in the reference;
// tensor cores (wgmma), TMA and a pipelined K/V ring are later work.  Under
// a causal mask, tiles wholly above the CTA's last row are skipped: the
// reference's kernel masks them, and their contribution is exactly zero
// (p = exp(-1e30 - m) = 0, correction exp(0) = 1).  Causal CTAs with the
// most tiles are launched first.  Keys past Sk read as zero and score
// -1e30; query rows past S compute nothing that is written.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;       // query rows per CTA, one per thread
constexpr int kTile = 32;       // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

// 16 bytes → f32 values: 4 f32, or 8 bf16 (little-endian, low half first;
// a bf16 is the high half of the f32 with the same value, so it is exact).
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// round to nearest even, as the reference's astype does
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Keys [k0, k0 + kTile) of one (bh) slice into `dst` as f32, row-major
// (kTile, DH); rows at or past sk_len are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* __restrict__ dst, int k0,
                                          int sk_len) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = kTile * DH / kPer;
  for (int i = threadIdx.x; i < kVecs; i += kRows) {
    const int e = i * kPer;
    float f[kPer];
    if (k0 + e / DH < sk_len) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(k0) * DH + e));
      unpack(u, f, static_cast<const T*>(nullptr));
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPer; j += 4) {
      *reinterpret_cast<float4*>(dst + e + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int sk_len, int causal, float scale) {
  __shared__ __align__(16) float ks[kTile * DH];
  __shared__ __align__(16) float vs[kTile * DH];
  constexpr int kPer = 16 / sizeof(T);

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int row = q0 + threadIdx.x;
  const bool live = row < s_len;
  const T* k_bh = k + bh * sk_len * DH;
  const T* v_bh = v + bh * sk_len * DH;
  const size_t q_off = (bh * s_len + (live ? row : 0)) * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; d += kPer) {
    if (live) {
      unpack(__ldg(reinterpret_cast<const uint4*>(q + q_off + d)), qr + d,
             static_cast<const T*>(nullptr));
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) qr[d + j] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  // keys past the tile's last row are masked for every row of the tile
  const int k_end = causal ? min(sk_len, q0 + kRows) : sk_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();                     // the previous tile is consumed
    load_tile<T, DH>(k_bh, ks, k0, sk_len);
    load_tile<T, DH>(v_bh, vs, k0, sk_len);
    __syncthreads();

    float sc[kTile];
#pragma unroll
    for (int c = 0; c < kTile; ++c) sc[c] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + c * DH + d);
        sc[c] = fmaf(qr[d], kk.x, sc[c]);
        sc[c] = fmaf(qr[d + 1], kk.y, sc[c]);
        sc[c] = fmaf(qr[d + 2], kk.z, sc[c]);
        sc[c] = fmaf(qr[d + 3], kk.w, sc[c]);
      }
    }

    float m_cur = kNegInf;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const int key = k0 + c;
      float s = sc[c] * scale;
      if (key >= sk_len || (causal && key > row)) s = kNegInf;
      sc[c] = s;
      m_cur = fmaxf(m_cur, s);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      sc[c] = expf(sc[c] - m_new);
      p_sum += sc[c];
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + c * DH + d);
        acc[d] = fmaf(sc[c], vv.x, acc[d]);
        acc[d + 1] = fmaf(sc[c], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(sc[c], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(sc[c], vv.w, acc[d + 3]);
      }
    }
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < DH; d += kPer) {
    float f[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) f[j] = acc[d + j] / den;
    *reinterpret_cast<uint4*>(o + q_off + d) =
        pack(f, static_cast<const T*>(nullptr));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int sk_len, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid(bh, (s_len + kRows - 1) / kRows);
  flash_fwd_kernel<T, DH><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, sk_len, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int bh,
                int s_len, int sk_len, int dh, int causal, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (bh, s_len, dh), k and v: (bh, sk_len, dh), o: (bh, s_len, dh), all
// contiguous, 16-byte aligned, of one dtype (0 = f32, 1 = bf16); dh one of
// 16, 32, 64 (at 128 a row no longer fits in one thread's registers).
// Launches on `stream` (the caller makes the stream's device current),
// allocates nothing; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a dtype, dh or size it does not take.
extern "C" int flashattn_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int s_len, int sk_len,
                                int dh, int dtype, int causal, float scale,
                                void* stream) {
  if (bh <= 0 || s_len <= 0 || sk_len <= 0 || s_len > 65535 * kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dh<float>(q, k, v, o, bh, s_len, sk_len, dh, causal,
                                scale, st);
    case 1:
      return dispatch_dh<__nv_bfloat16>(q, k, v, o, bh, s_len, sk_len, dh,
                                        causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
