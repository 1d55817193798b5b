// blockhash2 — per-block 64-bit digest of a leaf's raw bytes, for sm_90a.
//
// Replaces: src/repro/kernels/blockhash.py, `_hash_kernel` reached through
// `blockhash2_pallas` (two pallas_call launches, one per salt, each reading
// a zero-padded (n_blocks, block_bytes/4) u32 copy of the leaf in 8x2048
// tiles along a sequential grid axis).
//
// Function: for every hash block b of `block_bytes` bytes and each salt s in
// {0x9E3779B9, 0x85EBCA6B}, out[b][s] = sum_i fmix32(w[b,i] ^ (i*s)) with
// wrapping u32 addition, where w[b,i] is the i-th little-endian u32 word of
// the block (i counted within the block) and bytes past the leaf's end are 0.
//
// What bounds it on an H100 SXM: it reads every byte once (4.40 GB for the
// tinyllama-1.1b-shaped state: 1.31 ms at 3.35 TB/s).  For every u32 word
// it issues about 22 instructions for the two lanes (per lane: the i*s
// multiply, the xor with the word, three shifts, three xors, two multiplies,
// one add).  The integer multiplies issue on the FMA pipe and the shifts,
// xors and adds on the ALU pipe, 64 lanes per clock per SM each, co-issued;
// chip_smoke.py counts the sm_90a build's full-block loop in its SASS:
// about 17.3 ALU-pipe and 4.4 FMA-pipe instructions per word.  At 132 SMs x
// 1.98 GHz the ALU pipe needs about 1.13 ms for the state, under the 1.31 ms
// of HBM, so bytes are the bound, by a little.
//
// Design: one CTA per hash block (grid-stride beyond the grid cap) replaces
// the TPU's sequential accumulation axis; each thread reads 16-byte vectors
// and feeds the same registers to both salt lanes, so the leaf is read once
// instead of twice; partial sums reduce with warp shuffles, then shared
// memory, in wrapping u32 arithmetic (the sum is commutative, so any order
// is bit-exact).  The kernel reads the leaf in place and treats bytes past
// its end as zero — no padded copy, which on the card would double the
// traffic.  Offsets are 64-bit (a leaf may exceed 2^31 words).  The partial last
// block (a leaf smaller than a block, such as a norm vector, is only that)
// keeps the 16-byte loads, reading zero past the end without a load; only a
// leaf whose pointer is not 16-byte aligned takes a scalar path (4-byte
// loads where aligned and in range, else byte loads).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSaltA = 0x9E3779B9u;
constexpr uint32_t kSaltB = 0x85EBCA6Bu;
constexpr int kThreads = 256;
constexpr unsigned int kMaxGrid = 1u << 20;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void both_lanes(uint32_t w, uint32_t i, uint32_t& a,
                                           uint32_t& b) {
  a += fmix32(w ^ (i * kSaltA));
  b += fmix32(w ^ (i * kSaltB));
}

// The little-endian u32 word at byte offset `off`; bytes at or past `nbytes`
// read as zero.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, uint64_t off,
                                              uint64_t nbytes, bool aligned4) {
  if (aligned4 && off + 4 <= nbytes) {
    return *reinterpret_cast<const uint32_t*>(p + off);
  }
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (off + k < nbytes) w |= uint32_t(p[off + k]) << (8 * k);
  }
  return w;
}

// The 16 bytes at the 16-byte-aligned offset `off` as four words; bytes at
// or past `nbytes` read as zero.
__device__ __forceinline__ uint4 load_vec(const uint8_t* p, uint64_t off,
                                          uint64_t nbytes) {
  if (off + 16 <= nbytes) return __ldg(reinterpret_cast<const uint4*>(p + off));
  if (off >= nbytes) return make_uint4(0u, 0u, 0u, 0u);
  return make_uint4(load_word(p, off, nbytes, true),
                    load_word(p, off + 4, nbytes, true),
                    load_word(p, off + 8, nbytes, true),
                    load_word(p, off + 12, nbytes, true));
}

__global__ void __launch_bounds__(kThreads)
blockhash2_kernel(const uint8_t* __restrict__ data, uint64_t nbytes,
                  uint32_t block_bytes, uint64_t n_blocks,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t part_a[kThreads / 32];
  __shared__ uint32_t part_b[kThreads / 32];
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const bool vec = (addr % 16 == 0) && (block_bytes % 16 == 0);
  const bool aligned4 = addr % 4 == 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (uint64_t blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const uint64_t base = blk * uint64_t(block_bytes);
    uint32_t a = 0, b = 0;
    if (vec && base + block_bytes <= nbytes) {
      const uint4* v = reinterpret_cast<const uint4*>(data + base);
      const uint32_t n_vec = block_bytes / 16;
#pragma unroll 4
      for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
        const uint4 q = __ldg(v + j);
        const uint32_t i = 4 * j;
        both_lanes(q.x, i, a, b);
        both_lanes(q.y, i + 1, a, b);
        both_lanes(q.z, i + 2, a, b);
        both_lanes(q.w, i + 3, a, b);
      }
    } else if (vec) {
      // the partial last block (a norm vector is one such block): 16-byte
      // loads while the vector lies inside the leaf, zero past its end,
      // bytes only for the one vector that straddles it
      const uint32_t n_vec = block_bytes / 16;
#pragma unroll 4
      for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
        const uint4 q = load_vec(data, base + 16ull * j, nbytes);
        const uint32_t i = 4 * j;
        both_lanes(q.x, i, a, b);  // zero padding words hash too
        both_lanes(q.y, i + 1, a, b);
        both_lanes(q.z, i + 2, a, b);
        both_lanes(q.w, i + 3, a, b);
      }
    } else {
      const uint32_t n_words = block_bytes / 4;
      for (uint32_t i = threadIdx.x; i < n_words; i += kThreads) {
        const uint64_t off = base + 4ull * i;
        const uint32_t w = off < nbytes ? load_word(data, off, nbytes, aligned4)
                                        : 0u;
        both_lanes(w, i, a, b);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      part_a[warp] = a;
      part_b[warp] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t ta = 0, tb = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        ta += part_a[w];
        tb += part_b[w];
      }
      out[2 * blk] = ta;
      out[2 * blk + 1] = tb;
    }
    __syncthreads();  // the partials are reused by the next block
  }
}

}  // namespace

// data: the leaf's first byte; out: (n_blocks, 2) u32, written in full.
// Launches on `stream` (the caller makes the stream's device current),
// allocates nothing; returns cudaGetLastError().
extern "C" int blockhash2_launch(const void* data, unsigned long long nbytes,
                                 unsigned int block_bytes,
                                 unsigned long long n_blocks, void* out,
                                 void* stream) {
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid =
      n_blocks < kMaxGrid ? static_cast<unsigned int>(n_blocks) : kMaxGrid;
  blockhash2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, block_bytes, n_blocks,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
