// flashattn — attention forward with an online softmax, sm_90a.
//
// Replaces: src/repro/kernels/flashattn.py, `_flash_kernel` reached through
// `flash_attention` / `flash_attention_bshd` (grid (batch·heads, q blocks,
// kv blocks) with the kv axis sequential, carrying the running max,
// denominator and accumulator in VMEM scratch across grid steps).
//
// Function, per (batch, head h, query row r): s_j = (q_r · k_j) * scale,
// scale = f32(1/sqrt(dh)), with k and v read from KV head h // (H/KV)
// (grouped-query attention; KV = H is plain multi-head); causal: s_j =
// -1e30 where j > r; softmax over j with a running max m, denominator l and
// accumulator acc, all f32; out_r = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100 SXM: arithmetic.  4·dh FLOPs per (query, key)
// pair (two products), B·H·S·Sk pairs (about half when causal), against q,
// k, v and o read or written once: at tinyllama's training shape (B 4, S
// 2048, 32 heads over 4 KV heads, dh 64, bf16, causal) 6.87e10 FLOPs, 69.5
// us at the dense bf16 tensor-core peak, against 75.5 MB, 22.5 us at 3.35
// TB/s.  The exponentials come next: one per (row,
// key) pair on the 16-lane-per-SM MUFU pipe, about 64 us at that shape.
//
// Two kernels.
//
// bf16 (the training path; `flashattn_gqa_launch`), dh 16, 32, 64 or 128,
// on the tensor cores.  q is (B, S, H, dh) and k, v are (B, Sk, KV, dh),
// each read in place through its strides by TMA: no repeated KV heads, no
// transposed copies.  A CTA owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each (240 registers a thread after
// setmaxnreg) and a producer warpgroup (24), one thread of which loads Q
// once and keeps a ring of K and V tiles (2 stages of 128 keys; 3 of 64
// at dh 128) full with TMA under mbarriers; rows past S or Sk arrive as
// zeros (TMA's out-of-bounds fill) and such keys are masked.  S = Q·Kᵀ
// is wgmma with bf16 operands from shared memory (both K-major as
// stored, swizzled as TMA wrote them) and an f32 accumulator; the
// products are exact.  The online softmax runs in f32 on the accumulator
// fragment (row max and sum across the 4 threads of a row by shuffles;
// the -1e30 mask and the 1e-30 floor of the reference; exponentials as
// exp2 of the scores scaled by log2(e)/sqrt(dh)).  P·V is wgmma with P
// from registers (the accumulator fragment of 16 keys is the A operand as
// it stands) and V from shared memory through the transpose bit.  To keep
// p's precision, p is split into hi (p truncated to bf16) and
// lo = bf16(p - hi), and both products are accumulated: p keeps 16
// significant bits and the output stays within one bf16 ulp of the f32
// plain version (P as bf16 alone misses it: 0.0156 at the training
// shape); l sums the f32 p.  Within a warpgroup, S of tile
// t is issued with P·V of tile t-1, so the softmax of one tile runs while
// the tensor cores do the previous tile's P·V; between the two warpgroups,
// named barriers make them take turns issuing their products, so one's
// softmax runs while the other's products do.  Under a causal mask tiles
// wholly above a warpgroup's rows are skipped (their contribution is
// exactly zero: p = exp(-1e30 - m) = 0, correction 1) and only tiles that
// cross the diagonal are masked; the CTAs with the most tiles launch first.
// The epilogue divides by l, rounds to nearest even and stores (B, S, H,
// dh).  No atomics, and the tiling and order are fixed: two launches on
// the same inputs give the same bits.
//
// Where it stands (NVIDIA H100 80GB HBM3, `chip_smoke.py` and variants of
// this source timed in turns, numbers in PERF.md): about 4.4x its bound at
// the training shape.  Without the softmax, the products with the split
// alone take ~72 % of the kernel's time; without the softmax and P·V, S alone
// still takes ~45 % (TMA waits, per-CTA start-up, the split).  A
// persistent grid, TMA multicast of K/V across a cluster of heads of one
// KV group, and a TMA store of the output are the next steps.
//
// f32 (`flashattn_launch`), dh 16, 32 or 64, on the CUDA cores, kept as it
// was first written: one CTA per (batch·head, 64 query rows), one query
// row per thread with q, m, l and the accumulator in registers, K/V tiles
// of 32 keys in shared memory, f32 FMA, tiles above the causal diagonal
// skipped.  The training path never launches it; the parity tests and the
// gradient check do.
//
// The tensor maps come from cuTensorMapEncodeTiled, fetched from the CUDA
// driver with cudaGetDriverEntryPointByVersion (no -lcuda at link time),
// and reach the kernel as __grid_constant__ parameters.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace simt {


constexpr int kRows = 64;       // query rows per CTA, one per thread
constexpr int kTile = 32;       // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

// 16 bytes → 4 f32 values.
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
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

int dispatch_dh(const void* q, const void* k, const void* v, void* o, int bh,
                int s_len, int sk_len, int dh, int causal, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<float, 16>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    case 32: return launch<float, 32>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    case 64: return launch<float, 64>(q, k, v, o, bh, s_len, sk_len, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

namespace tc {

// ------------------------------------------------------------------------- //
// bf16 on the tensor cores
// ------------------------------------------------------------------------- //

constexpr int kRowsCta = 128;           // query rows per CTA
constexpr int kConsumers = 256;         // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 128;  // plus a producer warpgroup
constexpr float kNegInf = -1e30f;

template <int DH>
struct Cfg {
  // a panel is a column slab of at most 128 bytes per row, the widest
  // span TMA and wgmma swizzle; dh 128 (256-byte rows) takes two panels
  static constexpr int kSw = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int kPanels = DH * 2 / kSw;
  static constexpr int kPanelElems = kSw / 2;
  static constexpr int kN = DH == 128 ? 64 : 128;     // keys per tile
  // K/V ring depth: timed in turns on an H100, 2 stages beat 3 at dh 64
  // (by ~1 %) and 3 beat 2 at dh 128 (by ~5 %); dh 16 and 32 follow dh 64
  static constexpr int kStages = DH == 128 ? 3 : 2;
  static constexpr int kQBytes = kRowsCta * DH * 2;
  static constexpr int kKVBytes = kN * DH * 2;        // one K or V tile
  // wgmma layout type of the swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : (kSw == 64 ? 2 : 3);
  static constexpr int kSbo = 8 * kSw;                // 8-row group stride
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <int N>
struct Mma;

template <>
struct Mma<16> {
  // D (64 x 16, f32) (+)= A (64 x 16, from shared memory) . B (16 x 16)
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 16, f32) += A (64 x 16, bf16 in registers) . B (16 x 16),
  // B stored N-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  // D (64 x 32, f32) (+)= A (64 x 16, from shared memory) . B (16 x 32)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 32, f32) += A (64 x 16, bf16 in registers) . B (16 x 32),
  // B stored N-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  // D (64 x 64, f32) (+)= A (64 x 16, from shared memory) . B (16 x 64)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64),
  // B stored N-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // D (64 x 128, f32) (+)= A (64 x 16, from shared memory) . B (16 x 128)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128),
  // B stored N-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// named barrier `id` over both consumer warpgroups: wait for the other's
// arrival, or arrive for it
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Cfg<DH>::kLayout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
struct Tile {
  static constexpr int kN = Cfg<DH>::kN;
  float s[kN / 2];             // scores, then p (f32)
  uint32_t hi[kN / 16][4];     // p split for P V: hi = p truncated ...
  uint32_t lo[kN / 16][4];     // ... and lo = bf16(p - hi)
};

// S = Q K^T for one warpgroup's 64 rows and one K tile, issued (not waited)
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<DH>::kN / 2],
                                         uint32_t q_wg, uint32_t k_s) {
  using C = Cfg<DH>;
  // both operands K-major as stored; a 16-column step is 32 bytes into a
  // panel
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk * 32) % C::kSw;
    const uint32_t panel = (kk * 32) / C::kSw;
    Mma<C::kN>::ss(
        s, desc<DH>(q_wg + panel * kRowsCta * C::kSw + off, 16, C::kSbo),
        desc<DH>(k_s + panel * C::kN * C::kSw + off, 16, C::kSbo), kk > 0);
  }
}

// O += P V with P = hi + lo, both in registers, issued (not waited).  V is
// N-major (dh contiguous): a 16-key step is 16 rows down; the leading
// offset steps from one panel to the next.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const Tile<DH>& t, uint32_t v_s) {
  using C = Cfg<DH>;
#pragma unroll
  for (int kk = 0; kk < C::kN / 16; ++kk) {
    const uint64_t dv = desc<DH>(v_s + kk * 16 * C::kSw, C::kN * C::kSw,
                                 C::kSbo);
    Mma<DH>::rs(o, t.hi[kk], dv);
    Mma<DH>::rs(o, t.lo[kk], dv);
  }
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

// The online softmax in f32 on the score fragment of one tile: element
// 4j + e sits at row r0 + 8 (e / 2), column 8j + c0 + (e % 2).  Updates
// the running max m (log2 domain) and this thread's part of the sum l,
// leaves p in t.s, returns the correction of each row's accumulator.
template <int DH>
__device__ __forceinline__ float2 softmax(Tile<DH>& t, float (&m)[2],
                                          float (&l)[2], int k0, int r0,
                                          int c0, bool masked, int sk_len,
                                          int causal, float scale_log2) {
  constexpr int kN = Cfg<DH>::kN;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = t.s[4 * j + e];
      if (masked) {
        const int key = k0 + 8 * j + c0 + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (key >= sk_len || (causal && key > row)) x = kNegInf;
      }
      t.s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m[i], mx[i] * scale_log2);
    corr[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(t.s[4 * j + e], scale_log2, -m[e >> 1]));
      t.s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
  return make_float2(corr[0], corr[1]);
}

// p = hi + lo, both bf16: hi is p truncated to bf16 (its upper 16 bits, no
// conversion needed), lo = bf16(p - hi) rounded to nearest (p - hi is
// exact in f32 and below one bf16 ulp of p), so p keeps 16 significant
// bits.  The accumulator fragment of 16 columns is the register A operand
// of a 16-deep step as it stands.
template <int DH>
__device__ __forceinline__ void split(Tile<DH>& t) {
#pragma unroll
  for (int kk = 0; kk < Cfg<DH>::kN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = t.s[8 * kk + 2 * r];
      const float c = t.s[8 * kk + 2 * r + 1];
      const uint32_t ua = __float_as_uint(a) & 0xFFFF0000u;
      const uint32_t uc = __float_as_uint(c) & 0xFFFF0000u;
      t.hi[kk][r] = (ua >> 16) | uc;
      t.lo[kk][r] =
          pack_bf16(a - __uint_as_float(ua), c - __uint_as_float(uc));
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int s_len, int sk_len,
                int n_heads, int group, int causal, float scale_log2) {
  using C = Cfg<DH>;
  constexpr int kN = C::kN;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                                // Q, 128 rows
  const uint32_t sk = sq + C::kQBytes;                     // K ring
  const uint32_t sv = sk + kStages * C::kKVBytes;          // V ring
  const uint32_t bars = sv + kStages * C::kKVBytes;
  const uint32_t q_full = bars;
  // full[s] = bars + 8 (1 + s); empty[s] = bars + 8 (1 + kStages + s)

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hk = h / group;                  // the KV head this head reads
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsCta;  // heaviest first
  const int k_end = causal ? min(sk_len, q0 + kRowsCta) : sk_len;
  const int n_tiles = (k_end + kN - 1) / kN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread keeps the K/V ring full with TMA
    // loads; rows past S or Sk arrive as zeros (out-of-bounds fill)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load(sq + p * kRowsCta * C::kSw, &tq, q_full,
                 p * C::kPanelElems, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + kStages + s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          const uint32_t off = s * C::kKVBytes + p * kN * C::kSw;
          tma_load(sk + off, &tk, full, p * C::kPanelElems, t * kN, hk, b);
          tma_load(sv + off, &tv, full, p * C::kPanelElems, t * kN, hk, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg +
    // 64); this thread holds rows r0 and r0 + 8 of the accumulators
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int first_row = q0 + 64 * wg;
    const int last_row = first_row + 63;
    const int r0 = first_row + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);           // first of this thread's columns
    const uint32_t q_wg = sq + 64 * wg * C::kSw;
    // under the causal mask a tile wholly above this warpgroup's rows adds
    // exactly nothing (p = 0, correction 1): only the first n_mine tiles
    // are computed, the rest are waited for and released
    const int n_mine = causal ? min(n_tiles, (last_row + kN) / kN) : n_tiles;

    float oacc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};         // running max, log2 domain
    float l[2] = {0.f, 0.f};                 // this thread's part of the sum
    Tile<DH> tile;
    auto full = [&](int t) { return bars + 8 * (1 + t % kStages); };
    auto empty = [&](int t) { return bars + 8 * (1 + kStages + t % kStages); };
    auto masked = [&](int k0) {
      return k0 + kN > sk_len || (causal && k0 + kN - 1 > first_row);
    };

    // The two warpgroups take turns on the tensor cores, so one's softmax
    // runs while the other's products do.  A warpgroup's phases are S_0,
    // then S_t with P_{t-1} V_{t-1} for t = 1 .. n_mine - 1, then the last
    // P V: n_mine + 1 in all.  Phase i of warpgroup 0 follows phase i - 1
    // of warpgroup 1, phase i of warpgroup 1 follows phase i of warpgroup
    // 0, while the other has such a phase (named barriers 1 and 2; every
    // wait has exactly one matching arrival).
    const int other_last = last_row + (wg ? -64 : 64);
    const int n_other =
        causal ? min(n_tiles, (other_last + kN) / kN) : n_tiles;
    const int other_phases = n_other + 1;
    auto turn = [&](int i) {                 // before phase i
      if (wg == 0 ? (i >= 1 && i <= other_phases) : i < other_phases) {
        named_sync(1 + wg);
      }
    };
    auto pass = [&](int i) {                 // after phase i
      if (wg == 0 ? i < other_phases : i + 1 < other_phases) {
        named_arrive(2 - wg);
      }
    };

    // phase 0: S_0, then its softmax and split
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    turn(0);
    wgmma_fence();
    issue_qk<DH>(tile.s, q_wg, sk);
    wgmma_commit();
    pass(0);
    wgmma_wait<0>();
    fence_regs(tile.s);
    softmax<DH>(tile, m, l, 0, r0, c0, masked(0), sk_len, causal,
                scale_log2);
    split<DH>(tile);
    // phase t: S_t is issued with P_{t-1} V_{t-1}; the softmax of S_t runs
    // while the tensor cores do P_{t-1} V_{t-1}
    for (int t = 1; t < n_mine; ++t) {
      const int k0 = t * kN;
      mbar_wait(full(t), (t / kStages) & 1);
      fence_regs(oacc);
      turn(t);
      wgmma_fence();
      issue_qk<DH>(tile.s, q_wg, sk + (t % kStages) * C::kKVBytes);
      wgmma_commit();
      issue_pv<DH>(oacc, tile, sv + ((t - 1) % kStages) * C::kKVBytes);
      wgmma_commit();
      pass(t);
      wgmma_wait<1>();                       // S_t is done
      fence_regs(tile.s);
      const float2 corr = softmax<DH>(tile, m, l, k0, r0, c0, masked(k0),
                                      sk_len, causal, scale_log2);
      wgmma_wait<0>();                       // P_{t-1} V_{t-1} is done
      fence_regs(oacc);
      fence_regs(tile.hi);
      fence_regs(tile.lo);
      mbar_arrive(empty(t - 1));             // tile t-1 is consumed
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        oacc[4 * j] *= corr.x;
        oacc[4 * j + 1] *= corr.x;
        oacc[4 * j + 2] *= corr.y;
        oacc[4 * j + 3] *= corr.y;
      }
      split<DH>(tile);
    }
    // the last phase: P V of the last tile
    fence_regs(oacc);
    turn(n_mine);
    wgmma_fence();
    issue_pv<DH>(oacc, tile, sv + ((n_mine - 1) % kStages) * C::kKVBytes);
    wgmma_commit();
    pass(n_mine);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(tile.hi);
    fence_regs(tile.lo);
    mbar_arrive(empty(n_mine - 1));
    for (int t = n_mine; t < n_tiles; ++t) {
      mbar_wait(full(t), (t / kStages) & 1);
      mbar_arrive(empty(t));
    }

    // epilogue: divide by l, round to nearest even, store (B, S, H, dh)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = r0 + 8 * i;
      if (row >= s_len) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* dst =
          o + ((static_cast<int64_t>(b) * s_len + row) * n_heads + h) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) = pack_bf16(
            oacc[4 * j + 2 * i] / den, oacc[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver through the runtime, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (B, rows, heads, dh) bf16 with element strides (sb, ss, sh, 1) as a 4-d
// tensor map whose box is one panel of `box_rows` rows of one head
template <int DH>
CUresult make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
                  int heads, long long sb, long long ss, long long sh,
                  int box_rows) {
  using C = Cfg<DH>;
  const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {C::kPanelElems, static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      C::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                    : (C::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, s_len, sk_len, n_heads, n_kv;
  long long qs[3], ks[3], vs[3];     // (batch, seq, head) element strides
  int causal;
  float scale;
  cudaStream_t stream;
};

// a CUresult from the tensor-map encoder comes back offset by this, to
// tell it from a runtime error
constexpr int kEncodeError = 100000;

template <int DH>
int launch(const Args& a) {
  using C = Cfg<DH>;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult r = make_map<DH>(&tq, a.q, a.batch, a.s_len, a.n_heads, a.qs[0],
                            a.qs[1], a.qs[2], kRowsCta);
  if (r == CUDA_SUCCESS) {
    r = make_map<DH>(&tk, a.k, a.batch, a.sk_len, a.n_kv, a.ks[0], a.ks[1],
                     a.ks[2], C::kN);
  }
  if (r == CUDA_SUCCESS) {
    r = make_map<DH>(&tv, a.v, a.batch, a.sk_len, a.n_kv, a.vs[0], a.vs[1],
                     a.vs[2], C::kN);
  }
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  // per device, so set at every launch (the caller made the device current)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634);
  const dim3 grid(a.batch * a.n_heads, (a.s_len + kRowsCta - 1) / kRowsCta);
  flash_tc_kernel<DH><<<grid, kThreads, C::kSmem, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.s_len, a.sk_len,
      a.n_heads, a.n_heads / a.n_kv, a.causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// f32 only.  q: (bh, s_len, dh), k and v: (bh, sk_len, dh), o: (bh, s_len,
// dh), all contiguous and 16-byte aligned; dh one of 16, 32, 64.
// Launches on `stream` (the caller makes the stream's device current),
// allocates nothing; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a dh or size it does not take.
extern "C" int flashattn_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int s_len, int sk_len,
                                int dh, int causal, float scale,
                                void* stream) {
  if (bh <= 0 || s_len <= 0 || sk_len <= 0 ||
      s_len > 65535 * simt::kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return simt::dispatch_dh(q, k, v, o, bh, s_len, sk_len, dh, causal, scale,
                           static_cast<cudaStream_t>(stream));
}

// bf16 only.  q: (batch, s_len, n_heads, dh), k and v: (batch, sk_len, n_kv,
// dh), each with element strides (batch, seq, head) and a contiguous last
// dim, 16-byte aligned, every stride a multiple of 8 elements; n_heads a
// multiple of n_kv; dh one of 16, 32, 64, 128.  o: (batch, s_len, n_heads,
// dh), contiguous.  Launches on `stream` (the caller makes the stream's
// device current), allocates nothing; returns cudaGetLastError(),
// cudaErrorInvalidValue for arguments it does not take, or 100000 plus the
// CUresult when a tensor map cannot be encoded.
extern "C" int flashattn_gqa_launch(
    const void* q, const void* k, const void* v, void* o, int batch,
    int s_len, int sk_len, int n_heads, int n_kv, int dh, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, void* stream) {
  if (batch <= 0 || s_len <= 0 || sk_len <= 0 || n_heads <= 0 ||
      n_kv <= 0 || n_heads % n_kv ||
      (s_len + tc::kRowsCta - 1) / tc::kRowsCta > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tc::Args a{q, k, v, o, batch, s_len, sk_len, n_heads, n_kv,
                   {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                   causal, scale, static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16: return tc::launch<16>(a);
    case 32: return tc::launch<32>(a);
    case 64: return tc::launch<64>(a);
    case 128: return tc::launch<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
