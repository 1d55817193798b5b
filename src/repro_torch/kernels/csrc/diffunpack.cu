// diffunpack — scatter the packed dirty blocks of many leaves back into
// them, in place, sm_90a.
//
// Replaces: src/repro/kernels/diffpack.py:45, `_scatter_kernel` reached
// through `diffunpack_pallas` (:50, `pallas_call` at :64): one grid step
// per packed row, the block index scalar-prefetched into SMEM and read by
// the out BlockSpec's index map, over a zero-padded (n_blocks,
// block_bytes/4) u32 base aliased to the output.
//
// Function: for every k, block `table[k].block` of the leaf at
// `table[k].data` (`table[k].nbytes` long) = packed row k, in place.  Only
// bytes below the leaf's end are written: the reference's padded tail past
// the end is dropped when the flat buffer turns back into a leaf, so it is
// never materialized here, and the padded block 0 of a 0-byte leaf writes
// nothing.  The table (`Row`, diffrow.cuh) has one entry per packed row,
// leaf after leaf: a restart scatters one DIFF link into every leaf it
// touches with one launch.
//
// What bounds it on an H100 SXM: pure data movement: of each packed row,
// the bytes below its leaf's end read once and written once into the
// leaf, plus the 24-byte table entry, over 3.35 TB/s (about 71 us for the
// 1,852 dirty blocks of a sparse update of the tinyllama-1.1b-shaped
// state, whose 45 norm blocks hold 8 KiB each).  One launch per leaf paid
// a launch and a grid's start-up for each of the 46 small leaves, more
// than their bytes cost.
//
// Design: one launch over the table, on a persistent grid: as many CTAs
// as fit on the 132 SMs at once, each walking the rows k = blockIdx.x,
// blockIdx.x + gridDim.x, ..., so no CTA is started per row.  The bytes of
// a row whose leaf and packed row are both 16-byte aligned move by
// asynchronous bulk copies: one elected thread copies them in chunks of up
// to 16 KiB from the packed row into shared memory (`cp.async.bulk`,
// completing on an mbarrier) and from there into the leaf (a bulk store),
// through a two-stage ring, so that one chunk's store overlaps the next
// chunk's load — within a row and from one row to the next.  The chunks
// stop at the last 16-byte boundary below the leaf's end; the fewer than
// 16 bytes past it, and every row whose leaf is not 16-byte aligned (a
// view with a storage offset), take a vector path on the other warps:
// consecutive threads copy consecutive 16-byte vectors (512 contiguous
// bytes per warp instruction), then u32 words (bytes only where a word
// straddles the leaf's end); a leaf that is not 16-byte aligned takes
// words, or bytes where it is not 4-byte aligned either.  The host checks
// that each leaf's indices lie in [0, n_blocks) and increase strictly, so
// no two rows write the same bytes.
//
// Measured against the other design, the same persistent grid with every
// row on the 16-byte vector path (the loop of the per-leaf kernel this
// replaces), timed in turns in one call on store 4's 1,852 blocks (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py at the commit that built both):
// bulk copies 0.1011 and 0.1046 ms, vector loop 0.1070 and 0.1063 ms.
// The bulk-copy design is kept.  With params/embed's 903 blocks alone
// taking 0.0556 ms in the same call, both designs stream at about 80 % of
// 3.35 TB/s after a fixed cost of about 12 us (the table's copy, the
// launch, the grid's ramp).
#include <cstdint>
#include <cuda_runtime.h>

#include "diffrow.cuh"

namespace {

constexpr int kThreads = 256;

// Leaf bytes dst[lo, end) = packed bytes src[lo, end), by threads t, t +
// nt, ...: 16-byte vectors where both are 16-byte aligned (`vec`), then u32
// words, stored as bytes where the leaf is not 4-byte aligned or a word
// straddles `end`.  `lo` is a multiple of 16; src is 4-byte aligned and
// readable up to the next multiple of 4 past `end`.
__device__ __forceinline__ void copy_span(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          uint32_t lo, uint32_t end, bool vec,
                                          int t, int nt) {
  if (vec) {
    const uint32_t full = end & ~15u;
#pragma unroll 4
    for (uint32_t off = lo + 16u * t; off < full; off += 16u * nt) {
      *reinterpret_cast<uint4*>(dst + off) =
          __ldg(reinterpret_cast<const uint4*>(src + off));
    }
    lo = full > lo ? full : lo;
  }
  const bool aligned4 = reinterpret_cast<uintptr_t>(dst) % 4 == 0;
  for (uint32_t off = lo + 4u * t; off < end; off += 4u * nt) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(src + off));
    if (aligned4 && off + 4 <= end) {
      *reinterpret_cast<uint32_t*>(dst + off) = w;
    } else {
      for (uint32_t b = 0; b < 4 && off + b < end; ++b) {
        dst[off + b] = static_cast<uint8_t>(w >> (8 * b));
      }
    }
  }
}

// Packed row k's destination: its leaf's block, the bytes of it below the
// leaf's end, and whether both sides are 16-byte aligned.  False for the
// padded block of a 0-byte leaf, which writes nothing.
struct Span {
  uint8_t* dst;
  const uint8_t* src;
  uint32_t end;
  bool vec;
};

__device__ __forceinline__ bool row_span(const Row& r, uint64_t k,
                                         uint32_t block_bytes,
                                         const uint8_t* packed, bool packed16,
                                         Span* s) {
  const uint64_t base = uint64_t(r.block) * block_bytes;
  if (base >= r.nbytes) return false;
  const uint64_t avail = r.nbytes - base;
  s->end = avail < block_bytes ? static_cast<uint32_t>(avail) : block_bytes;
  s->dst = reinterpret_cast<uint8_t*>(r.data) + base;
  s->src = packed + k * block_bytes;
  s->vec = packed16 && r.data % 16 == 0;
  return true;
}

constexpr uint32_t kChunk = 16384;
constexpr int kStages = 2;
constexpr size_t kSmemBytes = size_t(kStages) * kChunk;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The one thread's ring: chunk c lands in stage c % kStages.  Chunk c's
// load is issued once the store of chunk c - kStages has read its stage;
// then chunk c - 1, loaded meanwhile, is stored.
struct Ring {
  uint8_t* buf;          // kStages x kChunk bytes of shared memory
  uint64_t* bars;        // kStages mbarriers, one per stage
  uint32_t n = 0;        // chunks issued so far
  uint8_t* dst = nullptr;
  uint32_t bytes = 0;    // the chunk loaded and not stored yet, if any

  __device__ __forceinline__ void store_pending() {
    if (bytes == 0) return;
    const uint32_t c = n - 1;
    const uint32_t s = c % kStages;
    mbar_wait(smem_u32(&bars[s]), (c / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_u32(buf + s * kChunk)), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    bytes = 0;
  }

  // leaf bytes to[0, size) = packed bytes from[0, size); size a multiple
  // of 16 up to kChunk, both addresses 16-byte aligned
  __device__ __forceinline__ void copy(uint8_t* to, const uint8_t* from,
                                      uint32_t size) {
    const uint32_t s = n % kStages;
    // the stores issued so far are those of chunks up to n - 2; the one of
    // chunk n - kStages read this stage
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStages - 2)
                 : "memory");
    const uint32_t bar = smem_u32(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar),
                 "r"(size)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf + s * kChunk)),
        "l"(from), "r"(size), "r"(bar)
        : "memory");
    store_pending();
    ++n;
    dst = to;
    bytes = size;
  }
};

__global__ void __launch_bounds__(kThreads)
diffunpack_many_kernel(const Row* __restrict__ table, uint64_t n_rows,
                       uint32_t block_bytes,
                       const uint8_t* __restrict__ packed) {
  extern __shared__ __align__(128) uint8_t ring_buf[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bars[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const bool packed16 = reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                        block_bytes % 16 == 0;
  Ring ring{ring_buf, bars};
  // warp 0 issues the bulk copies; warps 1.. copy what they leave
  const int t = static_cast<int>(threadIdx.x) - 32;
  for (uint64_t k = blockIdx.x; k < n_rows; k += gridDim.x) {
    Span s;
    if (!row_span(table[k], k, block_bytes, packed, packed16, &s)) continue;
    const uint32_t full = s.vec ? s.end & ~15u : 0;
    if (issuer) {
      for (uint32_t off = 0; off < full; off += kChunk) {
        const uint32_t size = full - off < kChunk ? full - off : kChunk;
        ring.copy(s.dst + off, s.src + off, size);
      }
    } else if (t >= 0 && full < s.end) {
      copy_span(s.dst, s.src, full, s.end, s.vec, t, kThreads - 32);
    }
  }
  if (issuer) {
    ring.store_pending();
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace

// table: (n_rows,) Row entries on the card (leaf pointer, leaf bytes, block
// index; within each leaf the blocks lie in [0, n_blocks) and increase
// strictly, which the host checks); packed: (n_rows, block_bytes/4) u32,
// row k the new content of table[k]'s block.  Launches on `stream` (the
// caller makes the stream's device current), allocates nothing; returns
// the first CUDA error of the occupancy query or the launch.
extern "C" int diffunpack_many_launch(const void* table,
                                      unsigned long long n_rows,
                                      unsigned int block_bytes,
                                      const void* packed, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, diffunpack_many_kernel, kThreads, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long resident =
      static_cast<unsigned long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned int grid = static_cast<unsigned int>(
      n_rows < resident ? n_rows : resident);
  diffunpack_many_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(table), n_rows, block_bytes,
      static_cast<const uint8_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
