// General 4-state pair counts for Hopper (sm_90a): per-window masked-Hamming
// counts straight from the int8 allele matrix, for distMat --windType cat,
// the device-array and raw-upload routes of the tri counts, the long-span
// helper, the window-stats step and the mesh's window slabs (K9), and for
// the mesh's row blocks of the tensor-parallel counts (K14): one kernel on
// the int8 tensor cores, walking the upper triangle (K9) or a rectangle of
// rows (K14); and the same counts read in place from a one-transfer flush
// buffer and tri-packed (K20, on the 1-bit tensor cores with K1's tile).
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/pairdist.py).  The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmma.cuh"
#include "wgmma.cuh"

namespace {

// Store one count into a cell: plainly, or with an int32 atomic add when
// the window's sites are split over blocks (the output is then zeroed).
__device__ __forceinline__ void put(int32_t* cell, int v, int atomic) {
  if (!atomic)
    *cell = v;
  else if (v)
    atomicAdd(cell, v);
}

// ------------------------------------------------------------ K9, K14
// pair_counts_4state — replaces genomics_general_tpu/kernels/pairdist.py
// pairwise_counts with gather_window_batch (and so _gathered_pair_counts'
// count stage).  For window w = [first, first + n) and haplotypes i, j:
//   shared(i, j)   = #sites where both codes are >= 0
//   match(i, j)    = #sites where both codes are the same one of 0..3
//   mismatch(i, j) = shared - match
// which is the JAX kernel's one-hot Gram (called . called^T minus
// sum_c onehot_c . onehot_c^T).  Missing is below 0, and a code above 3
// is called but matches nothing; a site outside the window, the span or
// the matrix reads as missing, so no padding is needed and each window is
// read at its own length.
//
// Bound: operations, at the int8 tensor-core rate — every pair of the
// upper triangle meets every site of its window in five 0/1 Grams, while
// the input is read once per 128 x 128 tile; at short windows the two
// [W, H, H] int32 outputs set the bound instead.  The tensor cores do the
// Grams, so the integer work of building their 0/1 operands from the code
// bytes (and the staging) must hide behind them.  Design:
// - the Grams run on wgmma m64n128k32 s8 x s8 -> s32: two warpgroups,
//   each 64 rows of the 128 x 128 pair tile against its 128 columns, five
//   products a 32-site step (one per code into the match sums, the called
//   plane into the shared sums), 2 x 64 int32 sums a thread;
// - shared memory holds the raw code bytes, 1 byte a (row, site).  A (the
//   tile's rows) comes from registers: ldmatrix brings 4 sites of one row
//   into each fragment register, and decode() builds the five 0/1 planes
//   there (11 integer operations a register, each row built once, by its
//   own warp; the next step's planes are built while the tensor cores
//   count this step's).  B (the columns) is built by the whole block, a
//   step ahead into the other of two buffers, as five planes in wgmma's
//   no-swizzle K-major layout (8-row x 16-byte core matrices) that both
//   warpgroups read;
// - a block owns one window (blockIdx.z), one 128 x 128 tile (blockIdx.x:
//   of the upper triangle, or with kRect of K14's rectangle; a tile whose
//   rows are its columns stages its 128 rows once) and one range of the
//   window's sites (blockIdx.y: split-K when the tiles alone leave SMs
//   idle, the ranges then adding with exact int32 atomics into the zeroed
//   output);
// - staging, double-buffered with cp.async: when the row stride is a
//   multiple of 16 every row has the same alignment, so the stage origin
//   moves back to a 16-byte boundary, whole chunks land in place, and the
//   sites outside the block's range in the first and last stages are then
//   set to -1 (the raw upload pads its rows to such a stride).  Other
//   strides (each row its own alignment: a contiguous matrix of odd
//   width, a view) copy each row's aligned chunks into a raw buffer, and
//   a pass in shared memory moves them into place with a funnel shift;
// - the epilogue goes through a 128 x 129 int32 tile in shared memory, so
//   the (i, j) rows and the mirrored (j, i) rows both leave as coalesced
//   128-byte stores (or atomics under split-K).
//
// pair_counts_4state_rows (K14) — replaces the row-sharded pair counts of
// genomics_general_tpu/parallel/mesh.py sharded_pair_counts_tp (the JAX
// gather_window_batch + pairwise_counts with the [W, H, H] output's rows
// split over the mesh): K9's counts for the rectangle of rows r0 .. r1 - 1
// and all h columns of every window, into [nwin, r1 - r0, h].  Bound:
// operations, as K9's, over the rectangle.  Design: K9's kernel with kRect:
// blockIdx.x walks the 128-row tiles from r0 times the 128-column tiles of
// [0, h), and the epilogue writes the rows below r1 at i - r0 with no
// mirror (staged rows at or past r1 are counted, not written).
namespace k9 {

constexpr int kTile = 128;             // pair tile: 128 x 128 haplotypes
constexpr int kThreads = 256;          // 2 warpgroups of 64 tile rows
constexpr int kStage = 128;            // sites staged per step
constexpr int kPitch = kStage + 16;    // staged row: 144 bytes (36 words)
constexpr int kBuf = 2 * kTile * kPitch;   // i rows, then j rows
// B planes of a 32-site step: plane p (codes 0..3, then called) at
// p * kPlane, each in wgmma.cuh's operand layout
constexpr int kPlane = kTile * 32;     // 4,096 bytes
constexpr int kPlanes = 5 * kPlane;    // one step's planes: 20,480 bytes
constexpr int kOutPitch = kTile + 1;   // epilogue tile row, in words
// shared memory: two steps' B planes, then two stage buffers (kUniform)
// or two raw buffers and the staged one; the epilogue tile reuses it
constexpr int kSmemUniform = 2 * kPlanes + 2 * kBuf;    // 114,688 bytes
constexpr int kSmemRealign = 2 * kPlanes + 3 * kBuf;    // 151,552 bytes
static_assert(kTile * kOutPitch * 4 <= kSmemUniform, "epilogue tile fits");

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A's planes of 32-site step kk: this warp's 16 rows from the staged
// codes at shared address codes, the fragment row address off
__device__ __forceinline__ void load_a(uint32_t codes, uint32_t off, int kk,
                                       uint32_t (&a)[5][4]) {
  uint32_t r[4];
  ldmatrix4(r, codes + off + 32 * kk);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t oh[4];
    decode(r[e], oh, a[4][e]);
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c][e] = oh[c];
  }
}

// rows r0 .. r1 - 1 of the counts go to rows 0 .. r1 - r0 - 1 of each
// window's [r1 - r0, h] output (K9: r0 = 0, r1 = h); tiles: the upper
// triangle's tiles a side (K9), the column tiles (kRect)
template <bool kUniform, bool kRect>
__global__ void __launch_bounds__(kThreads, 1)
pair_counts_4state_kernel(const int8_t* __restrict__ alleles, long long ld,
                          long long S, const int32_t* __restrict__ first,
                          const int32_t* __restrict__ n_sites, int h,
                          int r0, int r1, int tiles, int split_len,
                          int atomic, int32_t* __restrict__ m_out,
                          int32_t* __restrict__ s_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* planes = smem;
  uint8_t* bufs = smem + 2 * kPlanes;
  const int wl = blockIdx.z;

  int i0, j0;
  if (kRect) {
    // rectangle tile: row tiles from r0 times column tiles
    i0 = r0 + (blockIdx.x / tiles) * kTile;
    j0 = (blockIdx.x % tiles) * kTile;
  } else {
    // upper-triangle tile (ti <= tj), row by row
    int ti = 0;
    int rem = blockIdx.x;
    while (rem >= tiles - ti) {
      rem -= tiles - ti;
      ++ti;
    }
    i0 = ti * kTile;
    j0 = (ti + rem) * kTile;
  }
  const bool diag = i0 == j0;
  const int rows = diag ? kTile : 2 * kTile;     // staged rows
  const int jbase = diag ? 0 : kTile;            // the j rows' first

  const int n = n_sites[wl];
  const int lo = blockIdx.y * split_len;
  const int hi = min(n, lo + split_len);
  if (atomic && lo >= hi) return;                // the zeroed output stands
  const long long f = first[wl];
  const long long vlo = max(f + lo, 0LL);
  const long long vhi = min(f + max(hi, lo), S);
  long long c0 = vlo;
  int nst = 0;
  if (vhi > vlo) {
    if (kUniform) c0 -= (long long)((uintptr_t)(alleles + vlo) & 15);
    nst = (int)((vhi - c0 + kStage - 1) / kStage);
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;                      // tile rows 64 wg ..
  const int wr = 64 * wg + 16 * (warp & 3);      // this warp's 16 rows
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  // ldmatrix row address of A: rows wr + (lane & 7) + 8 (lane >> 3 & 1),
  // bytes 16 (lane >> 4)
  const uint32_t offA = (uint32_t)((wr + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * kPitch +
                                   16 * (lane >> 4));

  int acc_m[64];        // match sums: this thread's cells of 64 x 128
  int acc_s[64];        // shared sums
#pragma unroll
  for (int e = 0; e < 64; ++e) acc_m[e] = acc_s[e] = 0;

  // Start the copy of stage st (columns c0 + 128 st ..) into buffer b.
  // kUniform: the stage's 16-byte chunks of each row land in place.
  // Otherwise the aligned 16-byte chunks that cover the stage of each row
  // land in a raw buffer, the row's shift from its alignment in front, for
  // realign() to move into place.  Chunks that hold no column of
  // [vlo, vhi) (and rows at or past h) are not read: kUniform stores -1
  // there, realign() masks them.
  auto stage = [&](int st, int b) {
    const long long cs = c0 + (long long)st * kStage;
    uint8_t* buf = bufs + b * kBuf;
    constexpr int kChunks = kUniform ? kStage / 16 : kStage / 16 + 1;
    for (int task = tid; task < rows * kChunks; task += kThreads) {
      const int r = task / kChunks;
      const int q = task - r * kChunks;
      const int row = r < kTile ? i0 + r : j0 + r - kTile;
      const int8_t* src = alleles + row * ld + cs;
      const int sh = kUniform ? 0 : (int)((uintptr_t)src & 15);
      const long long cc = cs - sh + 16 * q;
      uint8_t* dst = buf + r * kPitch + 16 * q;
      if (row < h && cc < vhi && cc + 16 > vlo)
        cp_async16((uint32_t)__cvta_generic_to_shared(dst),
                   src - sh + 16 * q);
      else if (kUniform)
        *reinterpret_cast<uint4*>(dst) = make_uint4(~0u, ~0u, ~0u, ~0u);
    }
  };
  // Fill the staged rows of columns cs .. cs + 127 in buffer `out`: from
  // the raw buffer `raw` (the row's shift undone with a funnel shift), or
  // in place (raw == out: kUniform's edge stages); columns outside
  // [vlo, vhi) and rows at or past h read -1.
  auto realign = [&](long long cs, const uint8_t* raw, uint8_t* out) {
    for (int task = tid; task < rows * (kStage / 4); task += kThreads) {
      const int r = task >> 5;
      const int q = task & 31;
      const int row = r < kTile ? i0 + r : j0 + r - kTile;
      const long long col = cs + 4 * q;
      const bool inside = col >= vlo && col + 4 <= vhi;
      if (kUniform && inside) continue;
      uint32_t v = ~0u;
      if (row < h && col < vhi && col + 4 > vlo) {
        const int sh = kUniform ? 0
            : (int)((uintptr_t)(alleles + row * ld + cs) & 15);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
            raw + r * kPitch) + ((sh + 4 * q) >> 2);
        v = kUniform ? w[0] : __funnelshift_r(w[0], w[1], 8 * (sh & 3));
        if (!inside) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (col + k < vlo || col + k >= vhi) v |= 0xFFu << (8 * k);
        }
      }
      *reinterpret_cast<uint32_t*>(out + r * kPitch + 4 * q) = v;
    }
  };

  // Make stage st's codes ready to count in buffer codes_buf(st): wait
  // for its copy, then realign it (or set its edge columns missing).
  auto codes_buf = [&](int st) {
    return bufs + (kUniform ? (st & 1) : 2) * kBuf;
  };
  auto ready = [&](int st) {
    const long long cs = c0 + (long long)st * kStage;
    if (!kUniform)
      realign(cs, bufs + (st & 1) * kBuf, codes_buf(st));
    else if (cs < vlo || cs + kStage > vhi)
      realign(cs, codes_buf(st), codes_buf(st));
  };
  // B: the j rows' five planes of 32-site step kk of a stage's codes into
  // plane buffer pb, a warp a group of 8 rows x 16 bytes (one core matrix
  // of each plane), conflict-free both ways
  auto build_b = [&](const uint8_t* codes, int kk, int pb) {
    uint8_t* planes_b = planes + pb * kPlanes;
    for (int g = warp; g < kTile / 8 * 2; g += kThreads / 32) {
      const int rg = g >> 1;                     // rows 8 rg ..
      const int kh = g & 1;                      // the step's 16-byte half
      const int r = 8 * rg + (lane >> 2);
      const uint32_t x = *reinterpret_cast<const uint32_t*>(
          codes + (jbase + r) * kPitch + 32 * kk + 16 * kh + 4 * (lane & 3));
      uint32_t oh[4], called;
      decode(x, oh, called);
      uint8_t* dst = planes_b + rg * kSbo + kh * kLbo + 16 * (lane >> 2) +
                     4 * (lane & 3);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(dst + c * kPlane) = oh[c];
      *reinterpret_cast<uint32_t*>(dst + 4 * kPlane) = called;
    }
    fence_proxy_async();
  };

  // The steps (32 sites) of all stages in one pipeline: step k's products
  // run while the block builds step k + 1's B planes and each warp its A
  // planes; a stage boundary also waits for the next stage's copy (started
  // a stage ahead) and readies it.  Only wgmma touches the sums between
  // the first product and the last wait.
  uint32_t a[2][5][4];
  if (nst > 0) {
    stage(0, 0);
    cp_async_commit();
    if (nst > 1) {
      stage(1, 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    ready(0);
    __syncthreads();
    build_b(codes_buf(0), 0, 0);
    load_a(sbase + (uint32_t)(codes_buf(0) - smem), offA, 0, a[0]);
    __syncthreads();
  }
  fence_operands(acc_m);
  fence_operands(acc_s);
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
#pragma unroll
    for (int kk = 0; kk < kStage / 32; ++kk) {
      // step 4 st + kk: planes in buffer kk & 1, A in a[kk & 1]
      wgmma_fence();
      const uint32_t pb = sbase + (kk & 1) * kPlanes;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma(acc_m, a[kk & 1][c], plane_desc(pb + c * kPlane));
      wgmma(acc_s, a[kk & 1][4], plane_desc(pb + 4 * kPlane));
      wgmma_commit();
      int nst_ = st;                             // the next step's stage
      if (kk + 1 == kStage / 32) {
        if (st + 1 == nst) break;
        // stage st + 1: its copy, then the copy of stage st + 2 into the
        // buffer stage st used
        nst_ = st + 1;
        cp_async_wait<0>();
        __syncthreads();
        ready(nst_);
        if (nst_ + 1 < nst) {
          stage(nst_ + 1, (nst_ + 1) & 1);
          cp_async_commit();
        }
      }
      const int nkk = (kk + 1) % (kStage / 32);
      // the previous step's products (both warpgroups) read the plane
      // buffer and the a[] half that the next step fills
      wgmma_wait<1>();
      __syncthreads();
      build_b(codes_buf(nst_), nkk, (kk + 1) & 1);
      load_a(sbase + (uint32_t)(codes_buf(nst_) - smem), offA, nkk,
             a[(kk + 1) & 1]);
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  fence_operands(acc_m);
  fence_operands(acc_s);
  __syncthreads();

  // epilogue: shared, then mismatch = shared - match, each through the
  // 128 x 129 tile; (i, j) for i below r1 and, off K9's diagonal tiles,
  // the mirror (j, i) (a diagonal tile holds both, so each cell is written
  // once per block)
  int* tile = reinterpret_cast<int*>(smem);
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)wl * (r1 - r0) * h;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(wr + g + 8 * (e >> 1)) * kOutPitch + 8 * j + 2 * t + (e & 1)] =
            acc_s[4 * j + e] - (which ? acc_m[4 * j + e] : 0);
    __syncthreads();
    int32_t* out = (which ? m_out : s_out) + base;
    for (int rr = warp; rr < kTile && i0 + rr < r1; rr += kThreads / 32)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = lane + 32 * e;
        if (j0 + cc < h)
          put(&out[(size_t)(i0 + rr - r0) * h + j0 + cc],
              tile[rr * kOutPitch + cc], atomic);
      }
    if (!kRect && !diag)
      for (int cc = warp; cc < kTile && j0 + cc < h; cc += kThreads / 32)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = lane + 32 * e;
          if (i0 + rr < h)
            put(&out[(size_t)(j0 + cc) * h + i0 + rr],
                tile[rr * kOutPitch + cc], atomic);
        }
    __syncthreads();
  }
}

}  // namespace k9

// --------------------------------------------------------------- K20
// flush_pair_counts — replaces genomics_general_tpu/kernels/pairdist.py
// _fused_flush_pair_counts with transfer.unpack_flush_buffer: the
// one-transfer flush buffer
//   [2-bit codes h x sp/4 | miss bits h x sp/8 | first i32[wp] | n i32[wp]]
// is read in place (no unpacked [h, sp] matrix), each window w counts its
// sites first[w] .. first[w] + min(n[w], s_max) - 1 (the JAX gather keeps
// s_max slots; sites outside 0 .. sp - 1 read as missing) as K9 does, and
// the upper triangles (i <= j, np.triu_indices order) of mismatch and
// shared go straight into row w of out [wp, 2T], T = h (h + 1) / 2, m half
// then s half, as uint16 (s_max < 2^16) or int32: one kernel, one output,
// no [W, h, h] intermediate.
//
// Bound: bytes — the windows' words of the buffer read once and the tri
// rows written once (the 1-bit tensor-core product has no data-sheet
// rate; on K1's tiles it kept pace with the stores).  Design: K1's tile
// (bitmma.cuh), a 1-D grid of (window, 64 x 64 tile pair ti <= tj) blocks.
// - Staging decodes words, not sites.  A step covers kStepWords 32-site
//   words of the window from a 64-site boundary (a ~625-site window is one
//   step); each thread loads 64 sites of a row at once, 16 code bytes and
//   8 miss bytes (one 16-byte and one 8-byte load when sp is a multiple of
//   64, else bytes), kBatch of them in flight, and decodes them in
//   registers with word operations into five bit planes a word in shared
//   memory: the called bits c = ~miss & in-window, and the one-hot bits
//   oh_k = c & [code == k].  The planes keep a site order of their own
//   (bit 2t is site t, bit 2t + 1 site 16 + t): the code words' low and
//   high bits interleave with two masks and a shift, and the miss word is
//   shuffled to match; the counts do not depend on the order, and sites
//   outside the window are masked in place, so nothing is realigned.
// - AND-only products on the 1-bit tensor cores (mma.sync m16n8k256
//   and.popc), G(x, y) = popc(x_i & y_j) summed over words:
//     shared = G(c, c),  mismatch = shared - sum_k G(oh_k, oh_k)
//   exact because a called site has exactly one code.
// - The epilogue routes the tile through shared memory: each row i of the
//   tile leaves as one contiguous run of its j >= i (a diagonal tile skips
//   its lower half), in 16-byte streaming stores where the run covers a
//   whole aligned chunk, every thread on its own chunks (a warp a row ran
//   1.2x slower).  Windows with no sites (pad windows past W, empty
//   windows) write zero rows.
namespace k20 {

constexpr int kStepWords = 24;                   // 768 sites a step
constexpr int kRowPitch = 5 * kStepWords + 4;    // 124: fragments on 32 banks
constexpr int kUnits = kStepWords / 2;           // 64-site loads a row a step
constexpr int kBatch = 3;                        // loads in flight a thread
constexpr int kSmem = 2 * kPairTile * kRowPitch * 4;   // 63,488 bytes
static_assert(2 * kPairTile * kOutRow * 4 <= kSmem, "epilogue tiles fit");

__device__ __forceinline__ int load_i32(const uint8_t* p) {
  return (int)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// Bit t (t < 16) to bit 2t, bit 16 + t to bit 2t + 1: the planes' order.
__device__ __forceinline__ uint32_t interleave_halves(uint32_t x) {
  uint32_t t = (x ^ (x >> 8)) & 0x0000FF00u;
  x ^= t ^ (t << 8);
  t = (x ^ (x >> 4)) & 0x00F000F0u;
  x ^= t ^ (t << 4);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu;
  x ^= t ^ (t << 2);
  t = (x ^ (x >> 1)) & 0x22222222u;
  x ^= t ^ (t << 1);
  return x;
}

// The bits of word q (sites 32 q ..) inside sites [lo, hi).
__device__ __forceinline__ uint32_t window_bits(int q, int lo, int hi) {
  const int a = lo - 32 * q;
  const int b = hi - 32 * q;
  const uint32_t from = a <= 0 ? ~0u : a >= 32 ? 0u : ~0u << a;
  const uint32_t to = b >= 32 ? ~0u : b <= 0 ? 0u : (1u << b) - 1u;
  return from & to;
}

// The five planes of one word: x0, x1 its 2-bit codes (sites 0..15 and
// 16..31, site s at bits 2 (s % 16)), miss its miss bits (site s at bit
// s) with the sites outside the window set.
__device__ __forceinline__ void decode_word(uint32_t x0, uint32_t x1,
                                            uint32_t miss,
                                            uint32_t (&p)[5]) {
  const uint32_t c = ~interleave_halves(miss);
  const uint32_t lo = (x0 & 0x55555555u) | ((x1 & 0x55555555u) << 1);
  const uint32_t hi = ((x0 >> 1) & 0x55555555u) | (x1 & 0xAAAAAAAAu);
  p[0] = c & ~hi & ~lo;
  p[1] = c & ~hi & lo;
  p[2] = c & hi & ~lo;
  p[3] = c & hi & lo;
  p[4] = c;
}

// Stage the step of words q .. q + kStepWords - 1 (q even) of the tile's
// rows (0 .. 63: haplotypes i0..; 64 .. 127: j0..) as planes[row][plane]
// [word], rows at or past h and words outside [lo, hi) zero.
template <bool kAligned>
__device__ __forceinline__ void stage_step(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ miss,
    int c4, int m8, int h, int i0, int j0, int rows, int q, int lo, int hi,
    uint32_t* planes) {
  const int total = rows * kUnits;
  for (int base = threadIdx.x; base < total;
       base += kBatch * kPairThreads) {
    uint32_t cw[kBatch][4], mw[kBatch][2];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * kPairThreads;
      const int r = u / kUnits;
      const int qu = q + 2 * (u - r * kUnits);
      const int g = (r < kPairTile ? i0 : j0 - kPairTile) + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) cw[b][k] = 0u;
      mw[b][0] = mw[b][1] = ~0u;
      if (u >= total || g >= h || 32 * qu >= hi || 32 * qu + 64 <= lo)
        continue;
      const uint8_t* crow = codes + (size_t)g * c4;
      const uint8_t* mrow = miss + (size_t)g * m8;
      if (kAligned) {
        const uint4 c = *reinterpret_cast<const uint4*>(crow + 8 * qu);
        const uint2 m = *reinterpret_cast<const uint2*>(mrow + 4 * qu);
        cw[b][0] = c.x;
        cw[b][1] = c.y;
        cw[b][2] = c.z;
        cw[b][3] = c.w;
        mw[b][0] = m.x;
        mw[b][1] = m.y;
      } else {
        // a row of its own alignment (sp not a multiple of 64): bytes,
        // those past the row's end missing
        mw[b][0] = mw[b][1] = 0u;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int at = 8 * qu + k;
          if (at < c4) cw[b][k >> 2] |= (uint32_t)crow[at] << (8 * (k & 3));
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int at = 4 * qu + k;
          mw[b][k >> 2] |= (at < m8 ? (uint32_t)mrow[at] : 0xFFu)
                           << (8 * (k & 3));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * kPairThreads;
      if (u >= total) break;
      const int r = u / kUnits;
      const int k = 2 * (u - r * kUnits);
      uint32_t p0[5], p1[5];
      decode_word(cw[b][0], cw[b][1], mw[b][0] | ~window_bits(q + k, lo, hi),
                  p0);
      decode_word(cw[b][2], cw[b][3],
                  mw[b][1] | ~window_bits(q + k + 1, lo, hi), p1);
      uint32_t* dst = planes + r * kRowPitch + k;
#pragma unroll
      for (int p = 0; p < 5; ++p)
        *reinterpret_cast<uint2*>(dst + p * kStepWords) =
            make_uint2(p0[p], p1[p]);
    }
  }
}

// The tile's rows to out: row r (i = i0 + r) holds its run of j >= i
// (c0 .. cols - 1 of the tile) at t0(i) + j0 + c0 of each half, m then
// s.  Every thread takes (half, row, 16-byte chunk) tasks: a chunk inside
// the run leaves as one 16-byte streaming store, the partial chunks at the
// run's two ends element by element, so all the block's stores are in
// flight at once.
template <typename Out>
__device__ __forceinline__ void store_tile(Out* row, long long tri, int h,
                                           int i0, int j0, bool diag,
                                           const int* tm, const int* ts) {
  constexpr int kVec = 16 / (int)sizeof(Out);
  constexpr int kChunks = kPairTile / kVec + 1;   // a run spans at most
  const int cols = min(kPairTile, h - j0);
  for (int task = threadIdx.x; task < 2 * kPairTile * kChunks;
       task += kPairThreads) {
    const int half = task / (kPairTile * kChunks);
    const int rem = task - half * kPairTile * kChunks;
    const int r = rem / kChunks;
    const int q = rem - r * kChunks;
    const int i = i0 + r;
    const int c0 = diag ? r : 0;
    const int len = cols - c0;
    if (i >= h || len <= 0) continue;
    const long long t0 = (long long)i * h - (long long)i * (i - 1) / 2 - i;
    Out* dst = row + (half ? tri : 0) + t0 + j0 + c0;
    const int* src = (half ? ts : tm) + r * kOutRow + c0;
    // chunk q of the 16-byte chunks the run touches, from element e0
    const int e0 = q * kVec - (int)(((uintptr_t)dst & 15) / sizeof(Out));
    if (e0 >= len) continue;
    if (e0 >= 0 && e0 + kVec <= len) {
      const int* v = src + e0;
      uint4 x;
      if constexpr (sizeof(Out) == 2) {
        x = make_uint4((v[0] & 0xFFFFu) | ((uint32_t)v[1] << 16),
                       (v[2] & 0xFFFFu) | ((uint32_t)v[3] << 16),
                       (v[4] & 0xFFFFu) | ((uint32_t)v[5] << 16),
                       (v[6] & 0xFFFFu) | ((uint32_t)v[7] << 16));
      } else {
        x = make_uint4(v[0], v[1], v[2], v[3]);
      }
      __stcs(reinterpret_cast<uint4*>(dst + e0), x);
    } else {
      for (int u = max(0, -e0); u < kVec && e0 + u < len; ++u)
        dst[e0 + u] = (Out)src[e0 + u];
    }
  }
}

template <typename Out, bool kAligned>
__global__ void __launch_bounds__(kPairThreads, 3)
flush_pair_counts_kernel(const uint8_t* __restrict__ buf, int h, int sp,
                         int wp, int w0, int s_max, Out* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t planes[];
  const int T = (h + kPairTile - 1) / kPairTile;
  const int pairs = T * (T + 1) / 2;
  const int wl = w0 + blockIdx.x / pairs;
  int ti, tj;
  tile_pair(blockIdx.x % pairs, T, ti, tj);
  const int i0 = ti * kPairTile;
  const int j0 = tj * kPairTile;
  const bool diag = ti == tj;
  const int c4 = sp / 4;
  const int m8 = sp / 8;
  const uint8_t* miss = buf + (size_t)h * c4;
  const uint8_t* meta = miss + (size_t)h * m8;
  // the window's sites [lo, hi) of 0 .. sp - 1, its words from q0 (even)
  const int f = load_i32(meta + 4 * (size_t)wl);
  const int n = min(load_i32(meta + 4 * ((size_t)wp + wl)), s_max);
  const int lo = max(f, 0);
  const int hi = (int)min((long long)f + max(n, 0), (long long)sp);
  const int q0 = (lo >> 6) << 1;
  const int words = hi > lo ? ((hi + 31) >> 5) - q0 : 0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t* arow = planes + (16 * (warp & 3) + g) * kRowPitch + t;
  const uint32_t* brow = planes + ((diag ? 0 : kPairTile) +
                                   32 * (warp >> 2) + g) * kRowPitch + t;
  int sacc[4][4] = {}, macc[4][4] = {};
  for (int v0 = 0; v0 < words; v0 += kStepWords) {
    stage_step<kAligned>(buf, miss, c4, m8, h, i0, j0,
                         diag ? kPairTile : 2 * kPairTile, q0 + v0, lo, hi,
                         planes);
    __syncthreads();
    const int nk = min(kStepWords, words - v0);
    for (int kk = 0; kk < nk; kk += kMmaWords) {
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const uint32_t* a = arow + p * kStepWords + kk;
        const uint32_t af[4] = {a[0], a[8 * kRowPitch], a[4],
                                a[8 * kRowPitch + 4]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* b = brow + 8 * nt * kRowPitch + p * kStepWords + kk;
          mma_and_popc(p == 4 ? sacc[nt] : macc[nt], af, b[0], b[4]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: shared and mismatch through two tiles in shared memory
  int* ts = reinterpret_cast<int*>(planes);
  int* tm = ts + kPairTile * kOutRow;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = tile_at(warp, lane, nt, e);
      ts[at] = sacc[nt][e];
      tm[at] = sacc[nt][e] - macc[nt][e];
    }
  }
  __syncthreads();
  const long long tri = (long long)h * (h + 1) / 2;
  store_tile(out + (size_t)wl * 2 * tri, tri, h, i0, j0, diag, tm, ts);
}

// The variant of the output type and the buffer's alignment, its shared
// memory limit raised once per device and variant (not at every launch,
// so launches can be captured in a CUDA graph).
template <typename Out, bool kAligned>
int launch_flush(const void* buf, int h, int sp, int wp, int w0, int nwin,
                 int s_max, void* out, void* stream) {
  auto kernel = flush_pair_counts_kernel<Out, kAligned>;
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  const int T = (h + kPairTile - 1) / kPairTile;
  kernel<<<T * (T + 1) / 2 * nwin, kPairThreads, kSmem,
           (cudaStream_t)stream>>>((const uint8_t*)buf, h, sp, wp, w0, s_max,
                                   (Out*)out);
  return (int)cudaGetLastError();
}

}  // namespace k20

// K9 or K14 (kRect) on grid (tiles, splits, nwin): the kernel variant of
// the row stride, its shared-memory limit raised once per device and
// variant (not at every launch, so launches can be captured in a CUDA
// graph).
template <bool kRect>
int launch_4state(const void* alleles, long long ld, long long S,
                  const void* first, const void* n_sites, int h, int r0,
                  int r1, int tiles, int grid_tiles, int nwin, int splits,
                  int split_len, void* m_out, void* s_out, void* stream) {
  const dim3 grid(grid_tiles, splits, nwin);
  // a row stride that is a multiple of 16 gives every row one alignment
  const bool uniform = ld % 16 == 0;
  auto kernel = uniform ? k9::pair_counts_4state_kernel<true, kRect>
                        : k9::pair_counts_4state_kernel<false, kRect>;
  const int smem = uniform ? k9::kSmemUniform : k9::kSmemRealign;
  static bool raised[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[uniform][dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[uniform][dev] = true;
  }
  kernel<<<grid, k9::kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)alleles, ld, S, (const int32_t*)first,
      (const int32_t*)n_sites, h, r0, r1, tiles, split_len,
      splits > 1 ? 1 : 0, (int32_t*)m_out, (int32_t*)s_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// alleles: int8 rows of ld elements, columns 0 .. S - 1 valid; first,
// n_sites: int32 [nwin]; m_out, s_out: int32 [nwin, h, h], zeroed by the
// caller when splits > 1 (the splits then add with atomics).
int ggt_pair_counts_4state(const void* alleles, long long ld, long long S,
                           const void* first, const void* n_sites, int h,
                           int nwin, int splits, int split_len, void* m_out,
                           void* s_out, void* stream) {
  const int tiles = (h + k9::kTile - 1) / k9::kTile;
  return launch_4state<false>(alleles, ld, S, first, n_sites, h, 0, h, tiles,
                              tiles * (tiles + 1) / 2, nwin, splits,
                              split_len, m_out, s_out, stream);
}

// As ggt_pair_counts_4state for rows r0 .. r1 - 1 (0 <= r0 < r1 <= h) and
// all h columns: m_out, s_out int32 [nwin, r1 - r0, h].
int ggt_pair_counts_4state_rows(const void* alleles, long long ld,
                                long long S, const void* first,
                                const void* n_sites, int h, int r0, int r1,
                                int nwin, int splits, int split_len,
                                void* m_out, void* s_out, void* stream) {
  const int row_tiles = (r1 - r0 + k9::kTile - 1) / k9::kTile;
  const int col_tiles = (h + k9::kTile - 1) / k9::kTile;
  return launch_4state<true>(alleles, ld, S, first, n_sites, h, r0, r1,
                             col_tiles, row_tiles * col_tiles, nwin, splits,
                             split_len, m_out, s_out, stream);
}

// buf: a flush buffer of h rows, sp sites and wp windows; windows w0 ..
// w0 + nwin - 1 (nwin <= 65535) into rows w0 .. of out [wp, 2T], uint16
// when u16 != 0, else int32.
int ggt_flush_pair_counts(const void* buf, int h, int sp, int wp, int w0,
                          int nwin, int s_max, int u16, void* out,
                          void* stream) {
  // 16- and 8-byte loads of every row when each row starts 16-byte aligned
  const bool aligned = sp % 64 == 0 && ((uintptr_t)buf & 15) == 0;
  if (u16)
    return aligned ? k20::launch_flush<uint16_t, true>(
                         buf, h, sp, wp, w0, nwin, s_max, out, stream)
                   : k20::launch_flush<uint16_t, false>(
                         buf, h, sp, wp, w0, nwin, s_max, out, stream);
  return aligned ? k20::launch_flush<int32_t, true>(
                       buf, h, sp, wp, w0, nwin, s_max, out, stream)
                 : k20::launch_flush<int32_t, false>(
                       buf, h, sp, wp, w0, nwin, s_max, out, stream);
}

}  // extern "C"
