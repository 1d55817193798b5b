// flashattn_bwd — attention backward on the tensor cores, sm_90a.
//
// Replaces: no TPU kernel (the JAX package's Pallas flash kernel is forward
// only; its gradient is left to XLA).  On the card it takes the place of
// the plain backward, `kernels/ref.py:flash_attention_vjp_ref`, for bf16
// inputs: that one writes the f32 scores of every (query, key) pair to
// device memory, chunk by chunk, and runs five f32 products and some twenty
// elementwise passes over them.  The plain version stays beside it as the
// yardstick, and for f32 and the CPU.
//
// Function: the exact gradient of `flash_tc_kernel`'s function
// (`flashattn.cu`), per (batch, head h, query row r, key j), k and v read
// from KV head h // (H/KV):
//   p_rj = exp(s_rj·scale - lse_r), s = q·kᵀ, lse the forward's row
//          statistic (m + log l); p = 0 where the causal mask (j > r) holds
//   dp   = dO·vᵀ,  D_r = Σ_j p_rj dp_rj (f32, as the plain version sums
//          it),  ds = p ∘ (dp - D)
//   dv = pᵀ·dO,  dk = scale · dsᵀ·q  (summed over the H/KV heads of a group)
//   dq = scale · ds·k
// outputs rounded to nearest even in bf16.  D is not taken from the bf16
// output (rowsum(dO ∘ O)): that one rounds O to 8 bits, and where scores
// reach ±512 it put dq 2 % of its largest element off the plain version.
//
// What bounds it on an H100 SXM: arithmetic.  Five products of dh
// multiply-adds per (query, key) pair, 10·dh FLOPs, against q, k, v and
// dO read and dq, dk, dv written once: at smollm2-1.7b's training shape (B
// 14, S 4096, 32 heads over 32, dh 64, causal) 2.41e12 FLOPs a layer, 2.43
// ms at the dense bf16 tensor-core peak, against 1.66 GB, 0.50 ms at 3.35
// TB/s.  What it executes is more: S and dP three times (twice in the dQ
// kernel, once in the dK/dV kernel), and p and ds enter their products as
// hi + lo (below): 24·dh per pair on the tensor cores, and three
// exponentials per pair.
//
// Two launches, the usual deterministic layout of a flash backward:
//
// 1. flash_bwd_dq_kernel: a CTA per 128 query rows of one (batch, head),
//    two consumer warpgroups of 64 rows and a producer warpgroup; Q and dO
//    loaded once by TMA, a ring of K and V tiles up to the diagonal
//    (causal) walked twice.  The first pass sums D over each row's keys
//    and writes (lse·log2 e, D) to a (B, H, S padded to 128, 2) f32 table
//    (zeros in the padding); the second forms ds with the queries as rows
//    and accumulates dQ += ds·K in registers: no atomics, one store.
// 2. flash_bwd_dkdv_kernel: a CTA per 128 keys of one (batch, KV head).  K
//    and V are loaded once by TMA, in place through their strides (no
//    repeated KV heads).  The CTA walks the H/KV query heads of its group
//    and, for each, the 64-query tiles from the diagonal on (causal) or all
//    of them; a producer warpgroup keeps a TMA ring of Q, dO and (lse, D)
//    tiles full.  Two consumer warpgroups own 64 keys each and hold dK and
//    dV in registers across every tile of every head: no atomics, one
//    store.  Per tile, with the keys as rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by
//    wgmma (bf16 operands from shared memory, f32 accumulators; the
//    products are exact), pᵀ from Sᵀ while dPᵀ runs, dV += pᵀ·dO issued
//    while dsᵀ = pᵀ ∘ (dPᵀ - D) is formed, then dK += dsᵀ·Q.
//
// Precision, that of the forward: where p or ds is the A operand of a
// product it is split into hi (truncated to bf16) and lo = bf16(x - hi),
// and both products are accumulated, so it keeps 16 significant bits
// (flashattn.cu found bf16 alone misses one output ulp); lse, D and all of
// the softmax arithmetic are f32.  Tiling and order are fixed and there are
// no atomics: two launches on the same inputs give the same bits.
#include "flashattn_tc.cuh"

namespace {

namespace tc {

constexpr int kRowsCta = 128;           // keys (dK/dV) or queries (dQ) a CTA
constexpr int kConsumers = 256;         // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 128;  // plus a producer warpgroup
constexpr int kPad = 128;               // the (lse, D) table's rows pad to this
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Bwd {
  static constexpr int kNq = 64;                      // queries a tile, dK/dV
  static constexpr int kNk = DH == 128 ? 64 : 128;    // keys a tile, dQ
  static constexpr int kStages = 2;
  static constexpr int kRowsBytes = kRowsCta * DH * 2;  // a resident tile
  static constexpr int kQTile = kNq * DH * 2;
  static constexpr int kKTile = kNk * DH * 2;
  static constexpr int kStatBytes = kNq * 8;          // (lse log2, D) a query
  static constexpr int kSmemKV = 1024 + 2 * kRowsBytes +
                                 kStages * (2 * kQTile + kStatBytes) +
                                 8 * (1 + 2 * kStages);
  static constexpr int kSmemQ =
      1024 + 2 * kRowsBytes + 2 * kStages * kKTile + 8 * (1 + 2 * kStages);
};

// `bytes` contiguous bytes into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void init_bars(uint32_t bars, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + stages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float2* __restrict__ stats,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int s_len, int sk_len,
                      int s_pad, int n_heads, int n_kv, int causal,
                      float scale_log2, float scale) {
  using C = Bwd<DH>;
  using S = Sw<DH>;
  constexpr int kNq = C::kNq;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;                          // K, 128 keys
  const uint32_t sv = sk + C::kRowsBytes;            // V, 128 keys
  const uint32_t sq = sv + C::kRowsBytes;            // Q ring
  const uint32_t sdo = sq + kStages * C::kQTile;     // dO ring
  const uint32_t sst = sdo + kStages * C::kQTile;    // (lse, D) ring
  const uint32_t bars = sst + kStages * C::kStatBytes;
  const uint32_t kv_full = bars;
  // full[s] = bars + 8 (1 + s); empty[s] = bars + 8 (1 + kStages + s)
  const float4* st_ring = reinterpret_cast<const float4*>(smem_raw + (sst - raw));

  const int b = blockIdx.x / n_kv;
  const int hk = blockIdx.x % n_kv;
  const int group = n_heads / n_kv;
  // causal: the first key blocks meet the most query tiles, and launch first
  const int k0 = blockIdx.y * kRowsCta;
  const int n_qt = (s_len + kNq - 1) / kNq;
  // under the causal mask a query tile wholly before k0 adds exactly nothing
  const int t0 = causal ? min(k0 / kNq, n_qt) : 0;
  const int n_t = n_qt - t0;
  const int n_iter = group * n_t;

  init_bars(bars, kStages);

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread loads K and V, then keeps the ring of
    // Q, dO and (lse, D) tiles full; rows past S or Sk arrive as zeros
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers && n_iter > 0) {
      mbar_expect_tx(kv_full, 2 * C::kRowsBytes);
      for (int p = 0; p < S::kPanels; ++p) {
        const uint32_t off = p * kRowsCta * S::kSw;
        tma_load(sk + off, &tk, kv_full, p * S::kPanelElems, k0, hk, b);
        tma_load(sv + off, &tv, kv_full, p * S::kPanelElems, k0, hk, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int h = hk * group + it / n_t;
        const int q0 = (t0 + it % n_t) * kNq;
        const int s = it % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kQTile + C::kStatBytes);
        for (int p = 0; p < S::kPanels; ++p) {
          const uint32_t off = s * C::kQTile + p * kNq * S::kSw;
          tma_load(sq + off, &tq, full, p * S::kPanelElems, q0, h, b);
          tma_load(sdo + off, &tdo, full, p * S::kPanelElems, q0, h, b);
        }
        bulk_load(sst + s * C::kStatBytes,
                  stats + (static_cast<int64_t>(b) * n_heads + h) * s_pad + q0,
                  C::kStatBytes, full);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64); this
    // thread holds keys r0 and r0 + 8 of dK and dV, and the columns (query
    // rows) 8j + c0 and 8j + c0 + 1 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int first_key = k0 + 64 * wg;
    const int r0 = first_key + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t k_wg = sk + 64 * wg * S::kSw;
    const uint32_t v_wg = sv + 64 * wg * S::kSw;

    float dka[DH / 2], dva[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int q0 = (t0 + it % n_t) * kNq;
      const int s = it % kStages;
      const uint32_t q_s = sq + s * C::kQTile;
      const uint32_t do_s = sdo + s * C::kQTile;
      const float4* st = st_ring + s * (kNq / 2);
      // some (key, query) pair of this warpgroup's keys and the tile is
      // masked or padding
      const bool masked = q0 + kNq > s_len || first_key + 64 > sk_len ||
                          (causal && q0 < first_key + 63);
      mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);

      float pt[kNq / 2], dpt[kNq / 2];
      wgmma_fence();
      issue_ss<DH, kNq>(pt, k_wg, kRowsCta * S::kSw, q_s);
      wgmma_commit();
      issue_ss<DH, kNq>(dpt, v_wg, kRowsCta * S::kSw, do_s);
      wgmma_commit();
      wgmma_wait<1>();                       // Sᵀ is done
      fence_regs(pt);
#pragma unroll
      for (int j = 0; j < kNq / 8; ++j) {
        const float4 w = st[4 * j + c0 / 2];   // (lse, D) of two queries
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(pt[4 * j + e], scale_log2, (e & 1) ? -w.z : -w.x));
          if (masked) {
            const int key = r0 + 8 * (e >> 1);
            const int query = q0 + 8 * j + c0 + (e & 1);
            if (query >= s_len || key >= sk_len || (causal && key > query)) {
              p = 0.f;
            }
          }
          pt[4 * j + e] = p;
        }
      }
      uint32_t phi[kNq / 16][4], plo[kNq / 16][4];
      split<kNq>(pt, phi, plo);
      fence_regs(dva);
      wgmma_fence();
      issue_rs<DH, kNq>(dva, phi, plo, do_s);   // dV += pᵀ·dO
      wgmma_commit();
      wgmma_wait<1>();                       // dPᵀ is done; dV runs on
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < kNq / 8; ++j) {
        const float4 w = st[4 * j + c0 / 2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[4 * j + e] = pt[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? w.w : w.y));
        }
      }
      uint32_t shi[kNq / 16][4], slo[kNq / 16][4];
      split<kNq>(dpt, shi, slo);
      fence_regs(dka);
      wgmma_fence();
      issue_rs<DH, kNq>(dka, shi, slo, q_s);    // dK += dsᵀ·Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(phi);
      fence_regs(plo);
      fence_regs(shi);
      fence_regs(slo);
      mbar_arrive(bars + 8 * (1 + kStages + s));   // the stage is consumed
    }

    // epilogue: dK·scale and dV, rounded to nearest even, to (B, Sk, KV, dh)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= sk_len) continue;
      const int64_t off = ((static_cast<int64_t>(b) * sk_len + row) * n_kv + hk) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + c0) = pack_bf16(
            dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + c0) =
            pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float2* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dq, int s_len, int sk_len,
                    int s_pad, int n_heads, int group, int causal,
                    float scale_log2, float scale) {
  using C = Bwd<DH>;
  using S = Sw<DH>;
  constexpr int kN = C::kNk;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                          // Q, 128 rows
  const uint32_t sdo = sq + C::kRowsBytes;           // dO, 128 rows
  const uint32_t sk = sdo + C::kRowsBytes;           // K ring
  const uint32_t sv = sk + kStages * C::kKTile;      // V ring
  const uint32_t bars = sv + kStages * C::kKTile;
  const uint32_t q_full = bars;

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsCta;  // heaviest first
  const int k_end = causal ? min(sk_len, q0 + kRowsCta) : sk_len;
  const int n_tiles = (k_end + kN - 1) / kN;

  init_bars(bars, kStages);

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: Q and dO once, then the K and V tiles twice,
    // once for each pass
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * C::kRowsBytes);
      for (int p = 0; p < S::kPanels; ++p) {
        const uint32_t off = p * kRowsCta * S::kSw;
        tma_load(sq + off, &tq, q_full, p * S::kPanelElems, q0, h, b);
        tma_load(sdo + off, &tdo, q_full, p * S::kPanelElems, q0, h, b);
      }
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int t = it % n_tiles;
        const int s = it % kStages;
        const uint32_t full = bars + 8 * (1 + s);
        mbar_wait(bars + 8 * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * C::kKTile);
        for (int p = 0; p < S::kPanels; ++p) {
          const uint32_t off = s * C::kKTile + p * kN * S::kSw;
          tma_load(sk + off, &tk, full, p * S::kPanelElems, t * kN, hk, b);
          tma_load(sv + off, &tv, full, p * S::kPanelElems, t * kN, hk, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
    // this thread holds rows r0 and r0 + 8 of D and dQ
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int first_row = q0 + 64 * wg;
    const int last_row = first_row + 63;
    const int r0 = first_row + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t q_wg = sq + 64 * wg * S::kSw;
    const uint32_t do_wg = sdo + 64 * wg * S::kSw;
    // under the causal mask a tile wholly above this warpgroup's rows adds
    // exactly nothing: only the first n_mine tiles are computed
    const int n_mine = causal ? min(n_tiles, (last_row + kN) / kN) : n_tiles;
    const int64_t row_base = (static_cast<int64_t>(b) * n_heads + h);
    float lse2[2], dd[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {    // rows past S: Q and dO are zeros
      const int row = r0 + 8 * i;
      lse2[i] = row < s_len ? lse[row_base * s_len + row] * kLog2e : 0.f;
    }

    float dqa[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.f;
    mbar_wait(q_full, 0);
    // pass 0 sums D = Σ p·dP over the row's keys (f32, as the plain
    // version does); pass 1 forms ds = p (dP - D) and dQ += ds·K
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < n_tiles; ++t) {
        const int it = pass * n_tiles + t;
        const int s = it % kStages;
        mbar_wait(bars + 8 * (1 + s), (it / kStages) & 1);
        if (t < n_mine) {
          const int k0 = t * kN;
          const uint32_t k_s = sk + s * C::kKTile;
          const bool masked =
              k0 + kN > sk_len || (causal && k0 + kN - 1 > first_row);
          float pr[kN / 2], dp[kN / 2];
          wgmma_fence();
          issue_ss<DH, kN>(pr, q_wg, kRowsCta * S::kSw, k_s);
          wgmma_commit();
          issue_ss<DH, kN>(dp, do_wg, kRowsCta * S::kSw, sv + s * C::kKTile);
          wgmma_commit();
          wgmma_wait<1>();                   // S is done
          fence_regs(pr);
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = ex2(fmaf(pr[4 * j + e], scale_log2, -lse2[e >> 1]));
              if (masked) {
                const int key = k0 + 8 * j + c0 + (e & 1);
                const int row = r0 + 8 * (e >> 1);
                if (key >= sk_len || (causal && key > row)) p = 0.f;
              }
              pr[4 * j + e] = p;
            }
          }
          wgmma_wait<0>();                   // dP is done
          fence_regs(dp);
          if (pass == 0) {
#pragma unroll
            for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dd[e >> 1] = fmaf(pr[4 * j + e], dp[4 * j + e], dd[e >> 1]);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dp[4 * j + e] = pr[4 * j + e] * (dp[4 * j + e] - dd[e >> 1]);
              }
            }
            uint32_t hi[kN / 16][4], lo[kN / 16][4];
            split<kN>(dp, hi, lo);
            fence_regs(dqa);
            wgmma_fence();
            issue_rs<DH, kN>(dqa, hi, lo, k_s);    // dQ += ds·K
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dqa);
            fence_regs(hi);
            fence_regs(lo);
          }
        }
        mbar_arrive(bars + 8 * (1 + kStages + s));   // the stage is consumed
      }
      if (pass == 0) {
        // the row's D over its 4 threads; (lse·log2 e, D) for the dK/dV
        // kernel, zeros for rows past S (every row below s_pad is written)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 1);
          dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 2);
          const int row = r0 + 8 * i;
          if (row >= s_len) dd[i] = 0.f;
          if (c0 == 0) stats[row_base * s_pad + row] = make_float2(lse2[i], dd[i]);
        }
      }
    }

    // epilogue: dQ·scale, rounded to nearest even, to (B, S, H, dh)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= s_len) continue;
      __nv_bfloat16* dst =
          dq + ((static_cast<int64_t>(b) * s_len + row) * n_heads + h) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) = pack_bf16(
            dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float2* stats;
  int batch, s_len, sk_len, n_heads, n_kv, s_pad;
  long long qs[3], ks[3], vs[3], dos[3];   // (batch, seq, head) strides
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int DH>
int launch_bwd(const BwdArgs& a) {
  using C = Bwd<DH>;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // per kernel, Q and dO in boxes of its query rows, K and V of its keys
  CUtensorMap maps[8];
  const int q_rows[2] = {C::kNq, kRowsCta};
  const int k_rows[2] = {kRowsCta, C::kNk};
  for (int i = 0; i < 2; ++i) {
    CUresult r = make_map<DH>(&maps[4 * i], a.q, a.batch, a.s_len, a.n_heads,
                              a.qs[0], a.qs[1], a.qs[2], q_rows[i]);
    if (r == CUDA_SUCCESS) {
      r = make_map<DH>(&maps[4 * i + 1], a.k, a.batch, a.sk_len, a.n_kv,
                       a.ks[0], a.ks[1], a.ks[2], k_rows[i]);
    }
    if (r == CUDA_SUCCESS) {
      r = make_map<DH>(&maps[4 * i + 2], a.v, a.batch, a.sk_len, a.n_kv,
                       a.vs[0], a.vs[1], a.vs[2], k_rows[i]);
    }
    if (r == CUDA_SUCCESS) {
      r = make_map<DH>(&maps[4 * i + 3], a.dout, a.batch, a.s_len, a.n_heads,
                       a.dos[0], a.dos[1], a.dos[2], q_rows[i]);
    }
    if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  }
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634);

  // per device, so set at every launch (the caller made the device current)
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::kSmemQ);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmemKV);
  if (e != cudaSuccess) return static_cast<int>(e);

  // dQ first: its first pass writes the (lse, D) table the dK/dV kernel reads
  const dim3 grid_q(a.batch * a.n_heads, (a.s_len + kRowsCta - 1) / kRowsCta);
  flash_bwd_dq_kernel<DH><<<grid_q, kThreads, C::kSmemQ, a.stream>>>(
      maps[4], maps[5], maps[6], maps[7], a.lse, a.stats,
      static_cast<__nv_bfloat16*>(a.dq), a.s_len, a.sk_len, a.s_pad,
      a.n_heads, a.n_heads / a.n_kv, a.causal, scale_log2, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const dim3 grid_kv(a.batch * a.n_kv, (a.sk_len + kRowsCta - 1) / kRowsCta);
  flash_bwd_dkdv_kernel<DH><<<grid_kv, kThreads, C::kSmemKV, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.stats,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.s_len, a.sk_len, a.s_pad, a.n_heads, a.n_kv, a.causal, scale_log2,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// bf16 only.  q, dout: (batch, s_len, n_heads, dh); k, v: (batch, sk_len,
// n_kv, dh); each with element strides (batch, seq, head) and a contiguous
// last dim, 16-byte aligned, every stride a multiple of 8 elements.  lse:
// the forward's (batch, n_heads, s_len) f32 row statistic, contiguous.
// Writes dq ((batch, s_len, n_heads, dh) contiguous), dk and dv ((batch,
// sk_len, n_kv, dh) contiguous) and uses stats, (batch, n_heads, s_pad, 2)
// f32 scratch with s_pad = s_len rounded up to a multiple of 128.  n_heads
// a multiple of n_kv; dh one of 16, 32, 64, 128.  Two launches on
// `stream` (the caller makes the stream's device current);
// allocates nothing; returns cudaGetLastError(), cudaErrorInvalidValue for
// arguments it does not take, or 100000 plus the CUresult when a tensor
// map cannot be encoded.
extern "C" int flashattn_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, void* dq, void* dk, void* dv,
    float* stats, int batch, int s_len, int sk_len, int n_heads, int n_kv,
    int dh, int s_pad, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, float scale, void* stream) {
  if (batch <= 0 || s_len <= 0 || sk_len <= 0 || n_heads <= 0 ||
      n_kv <= 0 || n_heads % n_kv ||
      s_pad != (s_len + tc::kPad - 1) / tc::kPad * tc::kPad ||
      (s_len + tc::kRowsCta - 1) / tc::kRowsCta > 65535 ||
      (sk_len + tc::kRowsCta - 1) / tc::kRowsCta > 65535 ||
      static_cast<int64_t>(batch) * n_heads > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tc::BwdArgs a{q, k, v, dout, lse, dq, dk, dv,
                      reinterpret_cast<float2*>(stats), batch, s_len, sk_len,
                      n_heads, n_kv, s_pad, {q_sb, q_ss, q_sh},
                      {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                      {do_sb, do_ss, do_sh}, causal, scale,
                      static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16: return tc::launch_bwd<16>(a);
    case 32: return tc::launch_bwd<32>(a);
    case 64: return tc::launch_bwd<64>(a);
    case 128: return tc::launch_bwd<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
