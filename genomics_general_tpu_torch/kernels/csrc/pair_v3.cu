// Pairwise kernels for Hopper (sm_90a): per-window masked-Hamming pair
// counts from the wire-v3 (K1) and wire-v2 (K13) bit planes, the
// multi-allelic exception patch, and the epilogues of
// popgenWindows' distance analyses: per-block float64 sums, each
// individual's own pair, and the packed upper triangles.
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/pairdist.py).  Every launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// wrapper can raise on a refused launch.
//
// Wire layouts (kernels/transfer.py).  v3: four bit planes, each [h, Sp/32]
// little-endian 32-bit words, site 32q + t in bit t of word q; per-window
// class ranges meta int32 [7, wp] = firstB, nB, firstC, nC, firstD, nD,
// nconst.  v2: the called and alt planes in the same word layout, then
// first, n_sites int32 [wp].  Both end with the exception section ex_w
// int32 [ep] (== wp for padding entries) and ex_codes int8 [ep, h]; the
// exception patch reads them through a per-window entry index that the
// wrapper builds once per flush.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmma.cuh"

namespace {

constexpr int kTile = 32;        // K2 pair tile: 32 x 32 pairs
constexpr int kThreads = 256;    // 8 warps; warp y owns tile rows y + 8r
constexpr int kRowsPerThread = kTile / (kThreads / kTile);
constexpr int kExBatch = 32;     // K2 entries staged per step
constexpr int kExCols = 4;       // K2 column tiles a block
constexpr int kTailThreads = 256;
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kWideRows = 8;     // K3 wide: rows of loads in flight a thread

// ------------------------------------------------------- K1, K13 tile body
// One block per (window, 64 x 64 pair tile ti <= tj) of the upper triangle
// (the tile's schedule, product and epilogue cells in bitmma.cuh).
constexpr int kStageWords = 32;     // window words (realigned) a step
// A staged row holds the step's raw plane words, each segment's run
// copied from a 16-byte boundary: at most kStageWords + 3 (1 + 3 + 3) words
// for three segments.  60 words (15 x 16 bytes) keep rows 16-byte aligned
// and a fragment's 8 rows x 4 words on 32 banks.
constexpr int kRawRow = 60;
constexpr int kRawPlane = kPairTile * kRawRow;              // one side
constexpr int kRawWords = 2 * 2 * kRawPlane + 4;  // 2 planes x 2 sides
constexpr int kPairSmem = 4 * kRawWords;          // 61,456 bytes, dynamic
static_assert(kStageWords + 3 * 7 <= kRawRow && kRawRow % 4 == 0,
              "a step's raw runs fit a staged row");
static_assert(2 * kPairTile * kOutRow <= kRawWords,
              "the epilogue tiles reuse the stage");

// A window as up to three segments of bit planes, laid end to end on one
// axis of realigned words:
//   0: cB                  kind 0  shared   += popc(cB_i & cB_j)
//   1: aC                  kind 1  mismatch += popc(aC_i ^ aC_j)
//   2: cD (p0), aD (p1)    kind 2  shared   += popc(cD_i & cD_j),
//                          mismatch += popc((aD_i ^ aD_j) & cD_i & cD_j)
// Segment s holds bits [first[s], first[s] + n[s]) of its plane rows;
// its realigned word k is bits first + 32k .. + 31 shifted down to bit 0
// and zeroed past the end, at [start[s], start[s + 1]) of the axis, padded
// with zero words to a multiple of kMmaWords so that an m16n8k256 step
// never straddles two kinds.  K13 has segment 2 only (the called and alt
// planes).
struct Segments {
  const uint32_t* p0[3];
  const uint32_t* p1;
  int row_words[3];
  int first[3];
  int n[3];
  int start[4];
};

__device__ __forceinline__ int padded_words(int n) {
  const int words = n > 0 ? (n + 31) >> 5 : 0;
  return (words + kMmaWords - 1) / kMmaWords * kMmaWords;
}

__device__ __forceinline__ void set_starts(Segments& sg) {
  sg.start[0] = 0;
  sg.start[1] = padded_words(sg.n[0]);
  sg.start[2] = sg.start[1] + padded_words(sg.n[1]);
  sg.start[3] = sg.start[2] + padded_words(sg.n[2]);
}

// Segment s's part of the staging step at v0: its raw run is n4 16-byte
// chunks from plane word q4, at word off of each staged row, and its
// realigned word k reads staged words base + k and base + k + 1.  n4 = 0
// when the step holds none of its sites.
struct Run {
  int q4, n4, off, base;
};

__device__ __forceinline__ Run step_run(const Segments& sg, int s, int v0,
                                        int& off) {
  Run run{0, 0, 0, 0};
  const int n = sg.n[s];
  const int ka = max(v0, sg.start[s]) - sg.start[s];
  const int kr = min(min(v0 + kStageWords, sg.start[s + 1]) - sg.start[s],
                     n > 0 ? (n + 31) >> 5 : 0);
  if (kr <= ka) return run;
  const int qa = (sg.first[s] >> 5) + ka;
  const int qb = min(qa + kr - ka, (sg.first[s] + n - 1) >> 5);
  run.q4 = qa & ~3;
  run.n4 = ((qb - run.q4) >> 2) + 1;
  run.off = off;
  run.base = off + qa - run.q4 - ka;
  off += 4 * run.n4;
  return run;
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Copies the step's raw runs of the tile's rows (side 0, haplotypes i0..)
// and columns (side 1, j0..; not on a diagonal tile, which reads side 0
// for both) into raw[plane][side][row][word] with 16-byte cp.async, every
// copy of the block in flight at once: consecutive threads copy
// consecutive chunks of one row.  Rows past h are not copied (their counts
// are never stored).
template <bool kV3>
__device__ __forceinline__ void stage_step(const Segments& sg,
                                           const Run (&run)[3], int h,
                                           int i0, int j0, bool diag,
                                           uint32_t* raw) {
  const int l0 = kV3 ? run[0].n4 : 0;
  const int l1 = kV3 ? run[1].n4 : 0;
  const int len = l0 + l1 + 2 * run[2].n4;
  const int total = (diag ? 1 : 2) * kPairTile * len;
  for (int idx = threadIdx.x; idx < total; idx += kPairThreads) {
    const int side_row = idx / len;
    int c = idx - side_row * len;
    const int g = ((side_row >> 6) ? j0 : i0) + (side_row & 63);
    if (g >= h) continue;
    int s = 2, plane = 0;
    if (c < l0) {
      s = 0;
    } else if (c < l0 + l1) {
      s = 1;
      c -= l0;
    } else {
      c -= l0 + l1;
      plane = c >= run[2].n4;
      c -= plane * run[2].n4;
    }
    const int off = s == 0 ? run[0].off : s == 1 ? run[1].off : run[2].off;
    const int q4 = s == 0 ? run[0].q4 : s == 1 ? run[1].q4 : run[2].q4;
    const uint32_t* src = plane ? sg.p1 : s == 0 ? sg.p0[0]
                                         : s == 1 ? sg.p0[1] : sg.p0[2];
    const int rw = s == 0 ? sg.row_words[0]
                   : s == 1 ? sg.row_words[1] : sg.row_words[2];
    cp_async16(raw + plane * 2 * kRawPlane + side_row * kRawRow + off
                   + 4 * c,
               src + (size_t)g * rw + q4 + 4 * c);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Realigned word k of one staged row: staged words base + k, base + k + 1
// shifted down by sh, masked by keep (0 past the segment's end: then
// nothing is read).
__device__ __forceinline__ uint32_t realigned(const uint32_t* row, int at,
                                              int sh, uint32_t keep) {
  return keep ? __funnelshift_r(row[at], row[at + 1], sh) & keep : 0u;
}

// The called sites' reference bits R and alternate bits A of realigned
// word k (at staged word at) of row of a kind's planes:
//   kind 0: R = cB, A = 0;  kind 1: R = ~aC, A = aC;
//   kind 2: R = cD & ~aD, A = aD
template <int kKind>
__device__ __forceinline__ void ref_alt(const uint32_t* row, int at, int sh,
                                        uint32_t keep, uint32_t& r,
                                        uint32_t& a) {
  const uint32_t w0 = realigned(row, at, sh, keep);
  if (kKind == 0) {
    r = w0;
    a = 0;
  } else if (kKind == 1) {
    r = ~w0 & keep;
    a = w0;
  } else {
    a = realigned(row + 2 * kRawPlane, at, sh, keep);
    r = w0 & ~a;
  }
}

__device__ __forceinline__ uint32_t keep_bits(int rem) {
  return rem >= 32 ? ~0u : rem > 0 ? (1u << rem) - 1u : 0u;
}

// One m16n8k256 step of a warp over 8 realigned words of one kind: rows
// arow (+8), columns brow + 8 nt (+ g), words at + t and at + 4 + t (keep0,
// keep1 their bits in the segment).  Kind 0 adds to s only, kind 1 to m
// only, kind 2 to both.
template <int kKind>
__device__ __forceinline__ void mma_step(const uint32_t* arow,
                                         const uint32_t* brow, int at,
                                         int sh, uint32_t keep0,
                                         uint32_t keep1, int (&sacc)[4][4],
                                         int (&macc)[4][4]) {
  uint32_t ar[4], aa[4];
  ref_alt<kKind>(arow, at, sh, keep0, ar[0], aa[0]);
  ref_alt<kKind>(arow + 8 * kRawRow, at, sh, keep0, ar[1], aa[1]);
  ref_alt<kKind>(arow, at + 4, sh, keep1, ar[2], aa[2]);
  ref_alt<kKind>(arow + 8 * kRawRow, at + 4, sh, keep1, ar[3], aa[3]);
  const uint32_t ac[4] = {ar[0] | aa[0], ar[1] | aa[1], ar[2] | aa[2],
                          ar[3] | aa[3]};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    uint32_t br0, ba0, br1, ba1;
    ref_alt<kKind>(brow + 8 * nt * kRawRow, at, sh, keep0, br0, ba0);
    ref_alt<kKind>(brow + 8 * nt * kRawRow, at + 4, sh, keep1, br1, ba1);
    if (kKind != 1) mma_and_popc(sacc[nt], ac, br0 | ba0, br1 | ba1);
    if (kKind != 0) {
      mma_and_popc(macc[nt], aa, br0, br1);
      mma_and_popc(macc[nt], ar, ba0, ba1);
    }
  }
}

// The m16n8k256 steps of segment kKind's words in the staging step at v0
// (nk words staged).
template <int kKind>
__device__ __forceinline__ void segment_steps(const Segments& sg,
                                              const Run (&run)[3], int v0,
                                              int nk, const uint32_t* arow,
                                              const uint32_t* brow, int t,
                                              int (&sacc)[4][4],
                                              int (&macc)[4][4]) {
  const int sh = sg.first[kKind] & 31;
  const int end = min(sg.start[kKind + 1], v0 + nk);
  for (int v = max(sg.start[kKind], v0); v < end; v += kMmaWords) {
    const int k = v - sg.start[kKind] + t;
    const int rem = sg.n[kKind] - 32 * k;
    mma_step<kKind>(arow, brow, run[kKind].base + k, sh, keep_bits(rem),
                    keep_bits(rem - 128), sacc, macc);
  }
}

// The tile body of K1 and K13 for window wl: counts of rows i0.. against
// columns j0.. over the window's segments, written to m_out and s_out at
// (i, j) and, off the diagonal, at (j, i).
//
// Inner step: Hopper's 1-bit tensor-core product (mma.sync m16n8k256
// and.popc) offers only AND.  With R and A the called sites' reference
// and alternate bits and C = R | A, the counts are AND-only products
// G(x, y) = popc(x_i & y_j) summed over words:
//   s = nconst + G(C, C)               over kinds 0 and 2
//   m = G(A, R) + G(R, A)              over kinds 1 and 2
// exact because a called site is R or A, never both: the XOR of two alt
// bits where both are called is one alt and one reference bit.  Warp w
// owns rows 16 (w % 4).. and columns 32 (w / 4).. of the tile: four
// m16n8 column tiles, 32 int32 sums a thread.  Fragments are realigned
// from the staged raw words as they load (two shared loads and a funnel
// shift a word).
template <bool kV3>
__device__ __forceinline__ void pair_tile(const Segments& sg, int h, int wl,
                                          int i0, int j0, int nconst,
                                          int32_t* __restrict__ m_out,
                                          int32_t* __restrict__ s_out) {
  extern __shared__ __align__(16) uint32_t raw[];
  const bool diag = i0 == j0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t* arow = raw + (16 * (warp & 3) + g) * kRawRow;
  const uint32_t* brow =
      raw + (diag ? 0 : kRawPlane) + (32 * (warp >> 2) + g) * kRawRow;
  int sacc[4][4] = {}, macc[4][4] = {};
  for (int v0 = 0; v0 < sg.start[3]; v0 += kStageWords) {
    int off = 0;
    Run run[3];
#pragma unroll
    for (int s = 0; s < 3; ++s)
      run[s] = kV3 || s == 2 ? step_run(sg, s, v0, off) : Run{0, 0, 0, 0};
    stage_step<kV3>(sg, run, h, i0, j0, diag, raw);
    __syncthreads();
    const int nk = min(kStageWords, sg.start[3] - v0);
    if (kV3) {
      segment_steps<0>(sg, run, v0, nk, arow, brow, t, sacc, macc);
      segment_steps<1>(sg, run, v0, nk, arow, brow, t, sacc, macc);
    }
    segment_steps<2>(sg, run, v0, nk, arow, brow, t, sacc, macc);
    __syncthreads();
  }

  // epilogue: the m and s tiles through shared memory (the stage's
  // space), then 16-byte streaming stores of rows i0.. and, off the
  // diagonal, of their transpose at rows j0..; a warp writes two 256-byte
  // runs of one matrix a store
  int* tm = reinterpret_cast<int*>(raw);
  int* ts = tm + kPairTile * kOutRow;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = tile_at(warp, lane, nt, e);
      tm[at] = macc[nt][e];
      ts[at] = nconst + sacc[nt][e];
    }
  }
  __syncthreads();
  const bool vec = (h & 3) == 0;
  const size_t base = (size_t)wl * h;
  for (int q = threadIdx.x; q < kPairTile * kPairTile / 4;
       q += kPairThreads) {
    const int r = q >> 4;
    const int c4 = (q & 15) << 2;
#pragma unroll
    for (int mirror = 0; mirror < 2; ++mirror) {
      if (mirror && diag) break;
      // out row (i0 + r, cols j0 + c4..) from tile (r, c4..), or the
      // mirror's out row (j0 + r, cols i0 + c4..) from tile (c4.., r)
      const int oi = (mirror ? j0 : i0) + r;
      const int oj = (mirror ? i0 : j0) + c4;
      if (oi >= h || oj >= h) continue;
      int vm[4], vs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = mirror ? (c4 + u) * kOutRow + r
                              : r * kOutRow + c4 + u;
        vm[u] = tm[at];
        vs[u] = ts[at];
      }
      const size_t o = (base + oi) * h + oj;
      if (vec) {
        __stcs(reinterpret_cast<int4*>(m_out + o),
               make_int4(vm[0], vm[1], vm[2], vm[3]));
        __stcs(reinterpret_cast<int4*>(s_out + o),
               make_int4(vs[0], vs[1], vs[2], vs[3]));
      } else {
        for (int u = 0; u < 4 && oj + u < h; ++u) {
          __stcs(m_out + o + u, vm[u]);
          __stcs(s_out + o + u, vs[u]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- K1
// pair_counts_v3 — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_v3 (with _gather_bits) and kernels/transfer.py
// unpack_pair_wire_v3.  For window w and haplotypes i, j:
//   shared   = nconst[w] + popc(cB_i & cB_j) + popc(cD_i & cD_j)
//   mismatch = popc(aC_i ^ aC_j) + popc((aD_i ^ aD_j) & cD_i & cD_j)
// over the window's class ranges, through pair_tile's AND-only products
// (equal to the JAX kernel's bf16 Gram forms, in exact integers, with no
// 2^24 bound on the window length).  An all-monomorphic window only
// writes nconst.
//
// Bound: bytes.  The 1-bit tensor-core product does a pair's 32 sites of
// a word in a fraction of a __popc (the data sheet gives no 1-bit rate;
// on the card the __popc step on the same tile took twice as long), and
// the [nwin, h, h] m and s (8 bytes a pair) dwarf the planes read.
// Design: a 1-D grid of (window, tile pair ti <= tj) blocks, window-major,
// so the symmetric matrix costs half the products and each plane word read
// feeds a 64 x 64 tile.  The three class ranges stage together, their raw
// plane words in 16-byte cp.async copies all in flight at once (a step's
// latency is paid once: one pair of barriers a step, and a ~625-site
// window is one step), realigned as the fragments load; 80 registers and
// 61 KB of shared memory keep three blocks on an SM, so one block's
// staging overlaps another's stores.
__global__ void __launch_bounds__(kPairThreads, 3)
pair_counts_v3_kernel(const uint32_t* __restrict__ planes,
                      const int32_t* __restrict__ meta,
                      int h, int wb, int wc, int wd, int wp, int w0,
                      int32_t* __restrict__ m_out,
                      int32_t* __restrict__ s_out) {
  const int T = (h + kPairTile - 1) / kPairTile;
  const int pairs = T * (T + 1) / 2;
  const int wl = blockIdx.x / pairs;
  int ti, tj;
  tile_pair(blockIdx.x - wl * pairs, T, ti, tj);
  const int w = w0 + wl;
  Segments sg;
  sg.p0[0] = planes;
  sg.p0[1] = sg.p0[0] + (size_t)h * wb;
  sg.p0[2] = sg.p0[1] + (size_t)h * wc;
  sg.p1 = sg.p0[2] + (size_t)h * wd;
  sg.row_words[0] = wb;
  sg.row_words[1] = wc;
  sg.row_words[2] = wd;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    sg.first[s] = meta[2 * s * wp + w];
    sg.n[s] = meta[(2 * s + 1) * wp + w];
  }
  set_starts(sg);
  pair_tile<true>(sg, h, wl, ti * kPairTile, tj * kPairTile,
                  meta[6 * wp + w], m_out, s_out);
}

// ---------------------------------------------------------------- K13
// pair_counts_v2 — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_v2's count stage (_pair_counts_v2 with
// gather_window_code2) and kernels/transfer.py unpack_pair_wire.  For
// window w and haplotypes i, j, over the bits [first[w], first[w] +
// n_sites[w]) of the called (c) and alt (a) planes:
//   shared   = popc(c_i & c_j)
//   mismatch = popc((a_i ^ a_j) & c_i & c_j)
// K1's class-D term over one plane pair (pair_tile's segment 2).  The alt
// bits lie inside the called bits, so these equal the JAX bf16 Gram forms
// (c.c^T, ca.c^T + (ca.c^T)^T - 2 ca.ca^T) exactly.
//
// Bound and design: K1's.  Unlike wire v3, wire v2 ships every site of a
// window in both planes (v3 skips the constant class), so K13 does more
// products than K1 on the same flush.
__global__ void __launch_bounds__(kPairThreads, 3)
pair_counts_v2_kernel(const uint32_t* __restrict__ called,
                      const uint32_t* __restrict__ alt,
                      const int32_t* __restrict__ first,
                      const int32_t* __restrict__ n_sites, int h, int words,
                      int w0, int32_t* __restrict__ m_out,
                      int32_t* __restrict__ s_out) {
  const int T = (h + kPairTile - 1) / kPairTile;
  const int pairs = T * (T + 1) / 2;
  const int wl = blockIdx.x / pairs;
  int ti, tj;
  tile_pair(blockIdx.x - wl * pairs, T, ti, tj);
  Segments sg;
  sg.p0[0] = sg.p0[1] = sg.p0[2] = called;
  sg.p1 = alt;
  sg.row_words[0] = sg.row_words[1] = sg.row_words[2] = words;
  sg.first[0] = sg.first[1] = 0;
  sg.n[0] = sg.n[1] = 0;
  sg.first[2] = first[w0 + wl];
  sg.n[2] = n_sites[w0 + wl];
  set_starts(sg);
  pair_tile<false>(sg, h, wl, ti * kPairTile, tj * kPairTile, 0, m_out,
                   s_out);
}

// ---------------------------------------------------------------- K2
// exception_patch — replaces genomics_general_tpu/kernels/pairdist.py
// _exception_patch.  Each exception entry (a multi-allelic site inside one
// window) adds 1 to shared[w, i, j] where both haplotypes are called
// (code >= 0) and 1 to mismatch[w, i, j] where they also differ.
//
// Bound: the read-modify-write of the touched windows' [h, h] counts (the
// codes are small and stay in L2).  Design: the wrapper sorts the entries
// by window once per flush (order, starts: window w's entries are
// order[starts[w] .. starts[w+1]), padding entries after starts[wp]);
// one block per (window of the chunk, 32 x 128 pairs: four of K1's tiles
// side by side) walks its window's entries kExBatch at a time, the tile's
// row and column codes staged in shared memory, adds both-called and
// unequal pairs in int registers on top of its tile of m and s, read
// first (16 loads a thread in flight), and writes the tile back once.  No
// atomics: each (window, pair) belongs to one block, and integer sums are
// exact in any order.  A window with no entries returns at once.
__global__ void __launch_bounds__(kThreads)
exception_patch_kernel(const int32_t* __restrict__ order,
                       const int32_t* __restrict__ starts,
                       const int8_t* __restrict__ ex_codes, int h, int w0,
                       int32_t* __restrict__ m, int32_t* __restrict__ s) {
  constexpr int kCols = kExCols * kTile;
  __shared__ int8_t ci_s[kExBatch][kTile];       // [entry][tile row]
  __shared__ int8_t cj_s[kExBatch][kCols];       // [entry][tile column]
  const int wl = blockIdx.z;
  const int e0 = starts[w0 + wl];
  const int e1 = starts[w0 + wl + 1];
  if (e0 >= e1) return;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kCols;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  // the tile's counts, loaded first: their latency overlaps the walk
  int acc_s[kRowsPerThread][kExCols] = {};
  int acc_m[kRowsPerThread][kExCols] = {};
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int i = i0 + ty + rr * (kThreads / kTile);
#pragma unroll
    for (int cc = 0; cc < kExCols; ++cc) {
      const int j = j0 + tx + cc * kTile;
      if (i < h && j < h) {
        const size_t o = ((size_t)wl * h + i) * h + j;
        acc_m[rr][cc] = m[o];
        acc_s[rr][cc] = s[o];
      }
    }
  }
  for (int eb = e0; eb < e1; eb += kExBatch) {
    const int nb = min(kExBatch, e1 - eb);
    for (int idx = threadIdx.x; idx < nb * (kTile + kCols);
         idx += kThreads) {
      const int k = idx / (kTile + kCols);
      const int r = idx % (kTile + kCols);
      const int g = r < kTile ? i0 + r : j0 + r - kTile;
      const int8_t c =
          g < h ? ex_codes[(size_t)order[eb + k] * h + g] : (int8_t)-1;
      if (r < kTile) {
        ci_s[k][r] = c;
      } else {
        cj_s[k][r - kTile] = c;
      }
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
#pragma unroll
      for (int cc = 0; cc < kExCols; ++cc) {
        const int cj = cj_s[k][tx + cc * kTile];
#pragma unroll
        for (int rr = 0; rr < kRowsPerThread; ++rr) {
          const int ci = ci_s[k][ty + rr * (kThreads / kTile)];
          const int both = (ci >= 0) & (cj >= 0);
          acc_s[rr][cc] += both;
          acc_m[rr][cc] += both & (ci != cj);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int i = i0 + ty + rr * (kThreads / kTile);
#pragma unroll
    for (int cc = 0; cc < kExCols; ++cc) {
      const int j = j0 + tx + cc * kTile;
      if (i < h && j < h) {
        const size_t o = ((size_t)wl * h + i) * h + j;
        m[o] = acc_m[rr][cc];
        s[o] = acc_s[rr][cc];
      }
    }
  }
}

// ---------------------------------------------------------------- K3
// blocks_tail — replaces the "blocks" mode of
// genomics_general_tpu/kernels/pairdist.py _modes_tail.  For each window
// and population pair (p, q):
//   sums[w, p, q] = sum over i in p, j in q, i != j, s >= max(min_sites, 1)
//                   of (double) m / (double) s
//   cnts[w, p, q] = the number of such pairs
// which is the JAX einsum("whg,ph,qg->wpq") for a 0/1 mask in which every
// haplotype row belongs to exactly one group (the wrapper checks this and
// passes the rows grouped: perm[offs[p] .. offs[p+1]) are the rows of p).
// The diagonal is left out by haplotype row (i != j), so groups may
// interleave.  Each division is the correctly rounded one (the source is
// built without fast math); only the order of the sums differs from the
// einsum, and it is fixed: no floating-point atomics, so the sums are
// identical run to run.
//
// Bound: bytes — 8 bytes of counts read per pair and 16 written per cell,
// against a few f64 operations.  Each count is read once over all cells.
// The wrapper picks one of two launch shapes from the largest group:
//
// narrow (no group of more than pairdist._K3_NARROW_ROWS = 16 rows, where
// it beats the wide shape on the card; an individual mask, P ~ H/2, has a
// handful of pairs a cell): one thread per (window, p, q) cell, q
// fastest, on a 1-D grid.  The thread sums each column of its block over
// the rows in order, then adds the columns' sums in order: the order of the
// host executor's pm @ d0 @ pm.T, so groups of at most 2 rows (an
// individual mask) give its sums bit for bit.  It walks kColSums columns
// at a time row by row, their sums in registers and their loads in flight
// together: 8 columns for groups of 3 to 16 rows, 1 for groups of at most 2
// (there the registers of more cost more blocks a SM than the loads gain).
// No shared memory and no barrier; a warp's loads of one row and its stores
// of out[w, 0|1, p, q .. q+31] are contiguous runs when the groups are.
template <int kColSums>
__global__ void __launch_bounds__(kTailThreads)
blocks_tail_narrow_kernel(const int32_t* __restrict__ m,
                          const int32_t* __restrict__ s,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ offs, int P, int h,
                          int nwin, int min_sites, double* __restrict__ out) {
  const long long pq = (long long)P * P;
  const long long cell = (long long)blockIdx.x * kTailThreads + threadIdx.x;
  if (cell >= nwin * pq) return;
  const int wl = (int)(cell / pq);
  const int pqi = (int)(cell - wl * pq);
  const int p = pqi / P;
  const int q = pqi - p * P;
  const int pa = offs[p];
  const int pn = offs[p + 1] - pa;
  const int qa = offs[q];
  const int qn = offs[q + 1] - qa;
  const int ms = max(min_sites, 1);
  const size_t base = (size_t)wl * h * h;
  double sum = 0.0;
  int cnt = 0;
  for (int b0 = 0; b0 < qn; b0 += kColSums) {
    int js[kColSums];
    double col[kColSums];
#pragma unroll
    for (int u = 0; u < kColSums; ++u) {
      js[u] = b0 + u < qn ? perm[qa + b0 + u] : -1;
      col[u] = 0.0;
    }
    for (int a = 0; a < pn; ++a) {
      const int i = perm[pa + a];
      const size_t row = base + (size_t)i * h;
#pragma unroll
      for (int u = 0; u < kColSums; ++u) {
        if (js[u] < 0) continue;
        const int sv = s[row + js[u]];
        const int mv = m[row + js[u]];
        if (i != js[u] && sv >= ms) {
          col[u] += (double)mv / (double)sv;
          cnt += 1;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kColSums; ++u) sum += col[u];
  }
  out[(size_t)wl * 2 * pq + pqi] = sum;
  out[((size_t)wl * 2 + 1) * pq + pqi] = (double)cnt;
}

// wide (a larger group: popDist's 4 x 128): one block per (window,
// p, q).  Lane l takes the columns b = l, l + 32, ... of q's rows, warp w
// the rows a = w, w + 8, ... of p's, kWideRows rows in flight; all in
// 32-bit ints.  A warp's loads of one row are a contiguous run when the groups
// are.  Each thread sums in its fixed order, a fixed shuffle tree sums each
// warp and thread 0 sums the warps in order.  Counts are 64-bit: a cell
// holds up to h^2 pairs.
__global__ void __launch_bounds__(kTailThreads)
blocks_tail_wide_kernel(const int32_t* __restrict__ m,
                        const int32_t* __restrict__ s,
                        const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ offs, int P, int h,
                        int min_sites, double* __restrict__ out) {
  __shared__ double warp_sum[kTailWarps];
  __shared__ long long warp_cnt[kTailWarps];
  const int q = blockIdx.x;
  const int p = blockIdx.y;
  const int wl = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int pa = offs[p];
  const int pn = offs[p + 1] - pa;
  const int qa = offs[q];
  const int qn = offs[q + 1] - qa;
  const int ms = max(min_sites, 1);
  const int32_t* mw = m + (size_t)wl * h * h;
  const int32_t* sw = s + (size_t)wl * h * h;
  double sum = 0.0;
  long long cnt = 0;
  for (int b = lane; b < qn; b += 32) {
    const int j = perm[qa + b];
    int a = warp;
    for (; a + (kWideRows - 1) * kTailWarps < pn;
         a += kWideRows * kTailWarps) {
      int i[kWideRows], sv[kWideRows], mv[kWideRows];
#pragma unroll
      for (int u = 0; u < kWideRows; ++u) {
        i[u] = perm[pa + a + u * kTailWarps];
        const size_t o = (size_t)i[u] * h + j;
        sv[u] = sw[o];
        mv[u] = mw[o];
      }
#pragma unroll
      for (int u = 0; u < kWideRows; ++u) {
        if (i[u] != j && sv[u] >= ms) {
          sum += (double)mv[u] / (double)sv[u];
          cnt += 1;
        }
      }
    }
    for (; a < pn; a += kTailWarps) {
      const int i = perm[pa + a];
      const size_t o = (size_t)i * h + j;
      const int sv = sw[o];
      const int mv = mw[o];
      if (i != j && sv >= ms) {
        sum += (double)mv / (double)sv;
        cnt += 1;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    warp_sum[warp] = sum;
    warp_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    long long pairs = 0;
    for (int w = 0; w < kTailWarps; ++w) {
      total += warp_sum[w];
      pairs += warp_cnt[w];
    }
    const size_t pq = (size_t)P * P;
    out[((size_t)wl * 2) * pq + (size_t)p * P + q] = total;
    out[((size_t)wl * 2 + 1) * pq + (size_t)p * P + q] = (double)pairs;
  }
}

// ---------------------------------------------------------------- K4
// tri_pack — replaces the "tri" mode of genomics_general_tpu/kernels/
// pairdist.py _modes_tail.  Copies the upper triangles (i <= j, row by row:
// np.triu_indices order) of a chunk's m and s into out [nwin, 2T],
// T = h (h + 1) / 2, m half first, narrowed to uint16 when the wrapper
// knows every count is below 2^16 (each is at most its window's sites).
//
// Bound: bytes — a pure gather.  Design: one block per (row i, window);
// its threads walk j = i .. h - 1, so both the reads of row i and the
// writes of its T-segment (which starts at i h - i (i - 1) / 2) are
// consecutive addresses across a warp.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
tri_pack_kernel(const int32_t* __restrict__ m,
                const int32_t* __restrict__ s, int h,
                T* __restrict__ out) {
  const int i = blockIdx.x;
  const int wl = blockIdx.y;
  const size_t tri = (size_t)h * (h + 1) / 2;
  const size_t row = (size_t)i * h - (size_t)i * (i - 1) / 2;
  const size_t src = ((size_t)wl * h + i) * h;
  T* om = out + (size_t)wl * 2 * tri + row;
  T* os = om + tri;
  for (int j = i + threadIdx.x; j < h; j += kTailThreads) {
    om[j - i] = (T)m[src + j];
    os[j - i] = (T)s[src + j];
  }
}

// ---------------------------------------------------------------- K5
// het_pairs — replaces the het gather of the "blocks_het" mode of
// genomics_general_tpu/kernels/pairdist.py _modes_tail:
//   out[w, k] = ((double) m[w, r1[k], r2[k]], (double) s[w, r1[k], r2[k]])
// for each individual k (r1 == r2 for a non-diploid; the host discards
// that value).  Integers below 2^31 are exact in f64.
//
// Bound: bytes — one 32-byte sector per read of m and s, 16 bytes out.
// Design: one thread per (window, individual); nothing to share.  At run
// B's chunk (128 windows, 256 individuals) it takes about 0.001 ms more
// than launch_probe_kernel, a kernel that does nothing at its grid, in a
// CUDA graph on the H100: under twice its bound, so it stays at its launch
// floor (folding it into K3's launch would remove that floor).
__global__ void __launch_bounds__(kTailThreads)
het_pairs_kernel(const int32_t* __restrict__ m,
                 const int32_t* __restrict__ s,
                 const int32_t* __restrict__ r1,
                 const int32_t* __restrict__ r2, int h, int n_ind, int nwin,
                 double* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kTailThreads + threadIdx.x;
  if (t >= (long long)nwin * n_ind) return;
  const int wl = (int)(t / n_ind);
  const int k = (int)(t % n_ind);
  const size_t o = ((size_t)wl * h + r1[k]) * h + r2[k];
  out[2 * t] = (double)m[o];
  out[2 * t + 1] = (double)s[o];
}

// The launch floor: a kernel that does nothing, launched with K5's grid
// and block (one thread per (window, individual) cell).  It replaces no
// JAX function; its time beside K5's says how much of K5 is the launch.
__global__ void __launch_bounds__(kTailThreads) launch_probe_kernel() {}

}  // namespace

namespace {
// K1's and K13's 1-D grid: the upper triangle's tile pairs of each window.
unsigned pair_blocks(int h, int nwin) {
  const long long T = (h + kPairTile - 1) / kPairTile;
  return (unsigned)(T * (T + 1) / 2 * nwin);
}

// K1's or K13's shared-memory limit, raised once per device (the attribute
// is a device's, so a process that launches on several cards raises it on
// each; not at every launch, so launches can be captured in a CUDA graph).
template <typename Kernel>
cudaError_t raise_pair_smem(Kernel kernel, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kPairSmem);
  if (e == cudaSuccess && dev < 64) raised[dev] = true;
  return e;
}
}  // namespace

extern "C" {

// m_out, s_out: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1.
int ggt_pair_counts_v3(const void* planes, const void* meta, int h, int wb,
                       int wc, int wd, int wp, int w0, int nwin, void* m_out,
                       void* s_out, void* stream) {
  static bool raised[64];
  const cudaError_t attr = raise_pair_smem(pair_counts_v3_kernel, raised);
  if (attr != cudaSuccess) return (int)attr;
  pair_counts_v3_kernel<<<pair_blocks(h, nwin), kPairThreads, kPairSmem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (const int32_t*)meta, h, wb, wc, wd, wp, w0,
      (int32_t*)m_out, (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// called, alt: [h, words] 32-bit words; first, n_sites: int32 [wp];
// m_out, s_out: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1.
int ggt_pair_counts_v2(const void* called, const void* alt, const void* first,
                       const void* n_sites, int h, int words, int w0,
                       int nwin, void* m_out, void* s_out, void* stream) {
  static bool raised[64];
  const cudaError_t attr = raise_pair_smem(pair_counts_v2_kernel, raised);
  if (attr != cudaSuccess) return (int)attr;
  pair_counts_v2_kernel<<<pair_blocks(h, nwin), kPairThreads, kPairSmem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)called, (const uint32_t*)alt, (const int32_t*)first,
      (const int32_t*)n_sites, h, words, w0, (int32_t*)m_out,
      (int32_t*)s_out);
  return (int)cudaGetLastError();
}

// m, s: int32 [nwin, h, h] for windows w0 .. w0 + nwin - 1, patched in
// place; order int32 [ep] lists the entries window by window and window
// w's are order[starts[w] .. starts[w + 1]) (starts int32 [wp + 1]).
int ggt_exception_patch(const void* order, const void* starts,
                        const void* ex_codes, int h, int w0, int nwin,
                        void* m, void* s, void* stream) {
  const int tiles = (h + kTile - 1) / kTile;
  dim3 grid((tiles + kExCols - 1) / kExCols, tiles, nwin);
  exception_patch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)starts,
      (const int8_t*)ex_codes, h, w0, (int32_t*)m, (int32_t*)s);
  return (int)cudaGetLastError();
}

// out: float64 [nwin, 2, P, P] (sums, then valid-pair counts); wide picks
// the block-per-cell shape, else a thread per cell; max_rows is the largest
// group's row count.
int ggt_blocks_tail(const void* m, const void* s, const void* perm,
                    const void* offs, int P, int h, int nwin, int min_sites,
                    int max_rows, int wide, void* out, void* stream) {
  if (wide) {
    dim3 grid(P, P, nwin);
    blocks_tail_wide_kernel<<<grid, kTailThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, (const int32_t*)perm,
        (const int32_t*)offs, P, h, min_sites, (double*)out);
  } else {
    const long long cells = (long long)nwin * P * P;
    const unsigned blocks =
        (unsigned)((cells + kTailThreads - 1) / kTailThreads);
    auto narrow = max_rows <= 2 ? blocks_tail_narrow_kernel<1>
                                : blocks_tail_narrow_kernel<8>;
    narrow<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, (const int32_t*)perm,
        (const int32_t*)offs, P, h, nwin, min_sites, (double*)out);
  }
  return (int)cudaGetLastError();
}

// out: [nwin, 2 h (h + 1) / 2], uint16 when u16 != 0, else int32.
int ggt_tri_pack(const void* m, const void* s, int h, int nwin, int u16,
                 void* out, void* stream) {
  dim3 grid(h, nwin);
  if (u16) {
    tri_pack_kernel<uint16_t><<<grid, kTailThreads, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, h, (uint16_t*)out);
  } else {
    tri_pack_kernel<int32_t><<<grid, kTailThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)m, (const int32_t*)s, h, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// out: float64 [nwin, n_ind, 2].
int ggt_het_pairs(const void* m, const void* s, const void* r1,
                  const void* r2, int h, int n_ind, int nwin, void* out,
                  void* stream) {
  const long long n = (long long)nwin * n_ind;
  const unsigned blocks = (unsigned)((n + kTailThreads - 1) / kTailThreads);
  het_pairs_kernel<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)m, (const int32_t*)s, (const int32_t*)r1,
      (const int32_t*)r2, h, n_ind, nwin, (double*)out);
  return (int)cudaGetLastError();
}

// The zero-work probe at K5's grid for n cells (not a kernel of the port).
int ggt_launch_probe(long long n, void* stream) {
  const unsigned blocks = (unsigned)((n + kTailThreads - 1) / kTailThreads);
  launch_probe_kernel<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
