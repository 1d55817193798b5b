// The table that drives the batched pack (diffpack.cu) and unpack
// (diffunpack.cu): one entry per packed row, built on the host in numpy
// (ROW_DTYPE in kernels/diffpack.py) and copied to the card in one H2D.
#pragma once
#include <cstdint>

// Packed row k is block `block` of the leaf at `data`, `nbytes` long.
struct Row {
  uint64_t data;
  uint64_t nbytes;
  uint32_t block;
  uint32_t pad;
};
static_assert(sizeof(Row) == 24, "the host builds this table in numpy");
