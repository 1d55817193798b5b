// diffunpack — scatter packed dirty blocks back into a leaf, in place, sm_90a.
//
// Replaces: src/repro/kernels/diffpack.py, `_scatter_kernel` reached through
// `diffunpack_pallas` (one grid step per packed row, the block index
// scalar-prefetched into SMEM and read by the out BlockSpec's index map,
// over a zero-padded (n_blocks, block_bytes/4) u32 base aliased to the
// output with input_output_aliases={2: 0}).
//
// Function: block dirty_idx[k] of the leaf's raw bytes = packed row k, for
// every k, in place.  Only bytes below the leaf's end are written: the
// reference's padded tail past the end is dropped when the flat buffer
// turns back into a leaf (u32_flat_to_leaf), so it is never materialized
// here.  A leaf of 0 bytes has one (padded) block in the reference, so
// index 0 is accepted and writes nothing.
//
// What bounds it on an H100 SXM: pure data movement: each packed row read
// once, the leaf's bytes in each dirty block written once, and the index
// read once, over 3.35 TB/s (about 72 us for the ~1,850 dirty blocks of a
// sparse update of the tinyllama-1.1b-shaped state, whose 45 norm blocks
// hold 8 KiB each).
//
// Design: one CTA per dirty row (grid-stride beyond the grid cap).  Each CTA
// loads its own index (no scalar prefetch on Hopper), then copies the row
// with 16-byte loads from `packed` and 16-byte stores into the leaf:
// consecutive threads touch consecutive 16-byte vectors, 512 contiguous
// bytes per warp instruction.  The partial last block stores whole vectors
// below the end and single bytes for the one vector that straddles it; a
// leaf (or packed buffer) whose pointer is not 16-byte aligned — a view
// with a storage offset — takes a scalar word/byte path.  The host checks
// that the indices lie in [0, n_blocks) and increase strictly before they
// are copied to the card, so no two CTAs write the same bytes; the kernel
// skips an index outside rather than write outside the leaf.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kMaxGrid = 1u << 20;

// Bytes [off, min(off + 4, nbytes)) of the leaf = the little-endian bytes of
// word w (bytes at or past nbytes are dropped).
__device__ __forceinline__ void store_word(uint8_t* p, uint64_t off,
                                           uint64_t nbytes, bool aligned4,
                                           uint32_t w) {
  if (aligned4 && off + 4 <= nbytes) {
    *reinterpret_cast<uint32_t*>(p + off) = w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (off + k < nbytes) p[off + k] = static_cast<uint8_t>(w >> (8 * k));
  }
}

__global__ void __launch_bounds__(kThreads)
diffunpack_kernel(uint8_t* __restrict__ data, uint64_t nbytes,
                  uint32_t block_bytes, uint64_t n_blocks,
                  const int32_t* __restrict__ dirty_idx, uint64_t n_dirty,
                  const uint32_t* __restrict__ packed) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  const uintptr_t paddr = reinterpret_cast<uintptr_t>(packed);
  const bool vec = (addr % 16 == 0) && (paddr % 16 == 0) &&
                   (block_bytes % 16 == 0);
  const bool aligned4 = addr % 4 == 0;
  for (uint64_t k = blockIdx.x; k < n_dirty; k += gridDim.x) {
    const int32_t b = dirty_idx[k];
    if (b < 0 || uint64_t(b) >= n_blocks) continue;   // host-validated
    const uint64_t base = uint64_t(b) * block_bytes;
    if (base >= nbytes) continue;          // the padded block of a 0-byte leaf
    const uint32_t* src = packed + k * (block_bytes / 4);
    if (vec) {
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      const uint64_t avail = nbytes - base;
      const uint32_t n_vec = block_bytes / 16;
      if (avail >= block_bytes) {
        uint4* dst4 = reinterpret_cast<uint4*>(data + base);
#pragma unroll 4
        for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
          dst4[j] = __ldg(src4 + j);
        }
      } else {
        // the partial last block: whole vectors below the end, bytes for
        // the one vector that straddles it, nothing past it
        for (uint32_t j = threadIdx.x; j < n_vec; j += kThreads) {
          const uint64_t off = base + 16ull * j;
          if (off >= nbytes) break;
          const uint4 v = __ldg(src4 + j);
          if (off + 16 <= nbytes) {
            *reinterpret_cast<uint4*>(data + off) = v;
          } else {
            store_word(data, off, nbytes, true, v.x);
            store_word(data, off + 4, nbytes, true, v.y);
            store_word(data, off + 8, nbytes, true, v.z);
            store_word(data, off + 12, nbytes, true, v.w);
          }
        }
      }
    } else {
      const uint32_t n_words = block_bytes / 4;
      for (uint32_t i = threadIdx.x; i < n_words; i += kThreads) {
        const uint64_t off = base + 4ull * i;
        if (off >= nbytes) break;
        store_word(data, off, nbytes, aligned4, __ldg(src + i));
      }
    }
  }
}

}  // namespace

// data: the leaf's first byte (written in place); dirty_idx: (n_dirty,)
// int32 on the card, strictly increasing, each in [0, n_blocks); packed:
// (n_dirty, block_bytes/4) u32, row k the new content of block dirty_idx[k].
// Launches on `stream` (the caller makes the stream's device current),
// allocates nothing; returns cudaGetLastError().
extern "C" int diffunpack_launch(void* data, unsigned long long nbytes,
                                 unsigned int block_bytes,
                                 unsigned long long n_blocks,
                                 const void* dirty_idx,
                                 unsigned long long n_dirty,
                                 const void* packed, void* stream) {
  if (n_dirty == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid =
      n_dirty < kMaxGrid ? static_cast<unsigned int>(n_dirty) : kMaxGrid;
  diffunpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(data), nbytes, block_bytes, n_blocks,
      static_cast<const int32_t*>(dirty_idx), n_dirty,
      static_cast<const uint32_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
