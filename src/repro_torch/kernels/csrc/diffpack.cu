// diffpack — gather a leaf's dirty hash blocks into one dense buffer, sm_90a.
//
// Replaces: src/repro/kernels/diffpack.py, `_copy_kernel` reached through
// `diffpack_pallas` (one grid step per dirty block, the block index
// scalar-prefetched into SMEM and read by the BlockSpec index map, over a
// zero-padded (n_blocks, block_bytes/4) u32 copy of the leaf).
//
// Function: out[k] = block dirty_idx[k] of the leaf's raw bytes, as
// block_bytes/4 little-endian u32 words, bytes past the leaf's end written
// as zero (so the last row equals the reference's padded block).
//
// What bounds it on an H100 SXM: pure data movement: the leaf's bytes in
// each dirty block read once and every output row written once in full,
// over 3.35 TB/s (about 72 us for the ~1,860 dirty blocks of a sparse
// update of the tinyllama-1.1b-shaped state, whose 45 norm blocks hold
// 8 KiB each).
//
// Design: one CTA per dirty block (grid-stride beyond the grid cap).  There
// is no scalar prefetch on Hopper, so each CTA loads its own index, then
// copies the block with 16-byte loads and stores: consecutive threads touch
// consecutive 16-byte vectors, so every warp moves 512 contiguous bytes per
// instruction.  The leaf is read in place — no padded copy; the partial last
// block keeps the 16-byte loads and writes 16-byte zeros past the end, and
// only a leaf whose pointer is not 16-byte aligned takes a scalar path.  Indices are validated on the host before
// they are copied to the card; the kernel never reads outside the leaf.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kMaxGrid = 1u << 20;

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
diffpack_kernel(const uint8_t* __restrict__ data, uint64_t nbytes,
                uint32_t block_bytes, uint64_t n_blocks,
                const int32_t* __restrict__ dirty_idx, uint64_t n_dirty,
                uint32_t* __restrict__ out) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const bool vec = (addr % 16 == 0) && (block_bytes % 16 == 0);
  const bool aligned4 = addr % 4 == 0;
  for (uint64_t k = blockIdx.x; k < n_dirty; k += gridDim.x) {
    const int32_t b = dirty_idx[k];
    uint32_t* dst = out + k * (block_bytes / 4);
    if (b < 0 || uint64_t(b) >= n_blocks) {
      // out of range (the host validates, so this is a caller bug): write
      // a zero row rather than read outside the leaf
      for (uint32_t i = threadIdx.x; i < block_bytes / 4; i += kThreads) {
        dst[i] = 0u;
      }
      continue;
    }
    const uint64_t base = uint64_t(b) * block_bytes;
    if (vec && base + block_bytes <= nbytes) {
      const uint4* src = reinterpret_cast<const uint4*>(data + base);
      uint4* dst4 = reinterpret_cast<uint4*>(dst);
      const uint32_t n_vec = block_bytes / 16;
#pragma unroll 4
      for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
        dst4[j] = __ldg(src + j);
      }
    } else if (vec) {
      // the partial last block: 16-byte loads while the vector lies inside
      // the leaf, 16-byte zero stores past its end, bytes only for the one
      // vector that straddles it
      uint4* dst4 = reinterpret_cast<uint4*>(dst);
      const uint32_t n_vec = block_bytes / 16;
#pragma unroll 4
      for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
        dst4[j] = load_vec(data, base + 16ull * j, nbytes);
      }
    } else {
      const uint32_t n_words = block_bytes / 4;
      for (uint32_t i = threadIdx.x; i < n_words; i += kThreads) {
        const uint64_t off = base + 4ull * i;
        dst[i] = off < nbytes ? load_word(data, off, nbytes, aligned4) : 0u;
      }
    }
  }
}

}  // namespace

// data: the leaf's first byte; dirty_idx: (n_dirty,) int32 on the card, each
// in [0, n_blocks) (a row for an index outside is zero); out: (n_dirty,
// block_bytes/4) u32, written in full.
// Launches on `stream` (the caller makes the stream's device current),
// allocates nothing; returns cudaGetLastError().
extern "C" int diffpack_launch(const void* data, unsigned long long nbytes,
                               unsigned int block_bytes,
                               unsigned long long n_blocks,
                               const void* dirty_idx,
                               unsigned long long n_dirty, void* out,
                               void* stream) {
  if (n_dirty == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid =
      n_dirty < kMaxGrid ? static_cast<unsigned int>(n_dirty) : kMaxGrid;
  diffpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, block_bytes, n_blocks,
      static_cast<const int32_t*>(dirty_idx), n_dirty,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
