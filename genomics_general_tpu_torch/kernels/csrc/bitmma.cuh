// Hopper (sm_90a) building blocks of the 1-bit tensor-core pair tile shared
// by K1 and K13 (pair_v3.cu) and K20 (pair4.cu): the closed-form schedule
// of the upper triangle's 64 x 64 tile pairs, the and-popc product
// (mma.sync m16n8k256), and where a warp's sums land in the epilogue's
// shared tile.
//
// A block of kPairThreads (8 warps) owns one 64 x 64 tile: warp w holds
// rows 16 (w % 4) .. + 15 and columns 32 (w / 4) .. + 31 as four m16n8
// column tiles, 4 x 4 int32 sums a thread.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPairTile = 64;
constexpr int kPairThreads = 256;
constexpr int kMmaWords = 8;        // m16n8k256: 8 words of depth
constexpr int kOutRow = kPairTile + 1;            // the epilogue's tile row

// Tile pair p of the T (T + 1) / 2 pairs ti <= tj, row by row: the closed
// form of p's row counted from the last, corrected for rounding.
__device__ __forceinline__ void tile_pair(int p, int T, int& ti, int& tj) {
  const long long q = (long long)T * (T + 1) / 2 - 1 - p;
  long long r = (long long)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > q) --r;
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  ti = T - 1 - (int)r;
  tj = T - 1 - (int)(q - r * (r + 1) / 2);
}

// d += the and-popc product of A (16 x 256 bits, rows) and B (256 x 8 bits,
// columns): d[r][c] += popc(A_r & B_c) over the 256 bits.  A's registers
// hold rows g, g + 8 at words t, then t + 4; B's column g at words t, t + 4
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The cell of a kPairTile x kOutRow shared tile that sum e of column tile
// nt of this thread holds: row 16 (warp % 4) + g + 8 (e / 2), column
// 32 (warp / 4) + 8 nt + 2 t + e % 2.
__device__ __forceinline__ int tile_at(int warp, int lane, int nt, int e) {
  return (16 * (warp & 3) + (lane >> 2) + 8 * (e >> 1)) * kOutRow
         + 32 * (warp >> 2) + 8 * nt + 2 * (lane & 3) + (e & 1);
}

}  // namespace
