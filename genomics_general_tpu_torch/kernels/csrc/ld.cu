// Joint allele tables of every site pair of an LD window for Hopper
// (sm_90a): K17, the device half of stats/ld.ld_matrix(use_device=True).
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/ld.py).  The launches go on the caller's stream, do not
// synchronise, allocate nothing (the wrapper passes the one-hot scratch),
// and the entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;              // 2 warpgroups of 64 Gram rows
constexpr int kSites = 32;                 // sites per tile side
constexpr int kRows = 4 * kSites;          // Gram rows per tile: 128
constexpr int kStep = kRows * 32;          // a tile's 32-haplotype step: 4 KB
constexpr int kSteps = 4;                  // steps staged at once
constexpr int kStageBytes = kSteps * kStep;      // 16 KB per operand
constexpr int kOutPitch = kRows + 1;       // epilogue tile row, in words
// shared memory: two stages of A and B; the epilogue tile reuses it
constexpr int kSmemStages = 2 * 2 * kStageBytes;    // 65,536 bytes
constexpr int kSmemTile = kRows * kOutPitch * 4;    // 66,048 bytes
constexpr int kSmem = kSmemStages > kSmemTile ? kSmemStages : kSmemTile;

// ---------------------------------------------------------------- K17
// pair_allele_tables — replaces genomics_general_tpu/kernels/ld.py
// pair_allele_tables (window_pair_tables' device step):
//   N[x, y, a, b] = #haplotypes h with alleles[h, x] == a and
//                   alleles[h, y] == b,  a, b in 0..3
// the JAX one-hot Gram G = onehot^T onehot over rows 4 x + a (codes
// outside 0..3 one-hot to zero, so -1 and any other code count in no
// table), with N[x, y, a, b] = G[4 x + a, 4 y + b].
//
// Bound: the tables are 64 S^2 bytes written against H S bytes read, and
// the Gram is 2 (4 S)^2 H int8 operations: both grow as S^2, so the
// bound is bytes while H < ~1,200 (3.35 TB/s against 1,979 int8 TOP/s)
// and operations above that.  Design: the Gram on the int8 tensor cores,
// so the products cost a fraction of the stores:
// - a prologue (onehot_kernel) writes the one-hot K-major, haplotypes
//   along K padded with zeros to a multiple of 32: for each tile of 32
//   sites (128 Gram rows) and each 32-haplotype step, one 4 KB block in
//   wgmma.cuh's operand layout (≤ 4 MB at 2,048 sites and H = 512);
// - one block per 128 x 128 tile of the upper triangle (32 x 32 sites
//   with all 16 allele pairs): its two operands' steps arrive as
//   contiguous 16-byte cp.async copies, 4 steps a stage, double-buffered
//   (a diagonal tile stages its one operand once), and two warpgroups run
//   s8 x s8 -> s32 wgmma m64n128k32 with both operands in shared memory;
// - the epilogue goes through a 128 x 129 int32 tile in shared memory: a
//   site x's 32 tables of the tile are one contiguous 2 KB run of out,
//   and so are the mirror's, out[y, x, b, a] = G[4 x + a, 4 y + b], so
//   both leave as coalesced 16-byte streaming (evict-first) stores, four
//   conflict-free scalar reads each, so the tables pass through L2
//   without evicting the one-hot (on the H100 they ran faster than plain
//   stores); two blocks a SM let one tile's stores overlap the next
//   tile's copies and products.  Each table is written once, with no
//   atomics: exact counts (≤ H) in a fixed order.  (Staging the code
//   bytes and decoding the planes in the block, 4x fewer L2 reads, ran
//   no faster.)
//
// onehot: for site tile R and step q, block (R * nsteps + q) of kStep
// bytes; Gram row r = 4 (x % 32) + a, haplotype 32 q + k at byte
// (r / 8) * kSbo + (k / 16) * kLbo + (r % 8) * 16 + k % 16.  A thread
// writes one row's 16 haplotypes of all 4 alleles (a warp: 32 sites, so
// each of its 16 row reads is 32 consecutive bytes); haplotypes at or
// past h and sites at or past S read as missing, so padding is zero.
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const int8_t* __restrict__ alleles, long long ld, int h, int S,
              int nsteps, uint8_t* __restrict__ onehot) {
  const int sl = threadIdx.x & 31;
  const int hc = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  if (hc >= 2 * nsteps) return;
  const int s = blockIdx.x * kSites + sl;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 16 * hc + 4 * j + k;
      const uint32_t c = s < S && r < h
          ? (uint8_t)alleles[(long long)r * ld + s] : 0xFFu;
      v |= c << (8 * k);
    }
    w[j] = v;
  }
  uint32_t oh[4][4];                       // [allele][word]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t p[4], called;
    decode(w[j], p, called);
#pragma unroll
    for (int a = 0; a < 4; ++a) oh[a][j] = p[a];
  }
  uint8_t* blk = onehot + ((size_t)blockIdx.x * nsteps + (hc >> 1)) * kStep +
                 (hc & 1) * kLbo;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * sl + a;
    *reinterpret_cast<uint4*>(blk + (r >> 3) * kSbo + (r & 7) * 16) =
        make_uint4(oh[a][0], oh[a][1], oh[a][2], oh[a][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
pair_tables_kernel(const uint8_t* __restrict__ onehot, int S, int nsteps,
                   int tiles, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  // upper-triangle tile (ti <= tj), row by row
  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const uint8_t* ga = onehot + (size_t)ti * nsteps * kStep;
  const uint8_t* gb = onehot + (size_t)tj * nsteps * kStep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;                // Gram rows 64 wg ..
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);

  // Start the copy of stage st (steps kSteps st ..) into buffer b: A at
  // 2 b kStageBytes, B after it; each operand's steps are contiguous.
  auto stage = [&](int st, int b) {
    const int q0 = st * kSteps;
    const int n = min(kSteps, nsteps - q0) * (kStep / 16);
    const uint32_t dst = sbase + b * 2 * kStageBytes;
    const uint8_t* sa = ga + (size_t)q0 * kStep;
    const uint8_t* sb = gb + (size_t)q0 * kStep;
    for (int i = tid; i < n; i += kThreads) {
      cp_async16(dst + 16 * i, sa + 16 * i);
      if (!diag) cp_async16(dst + kStageBytes + 16 * i, sb + 16 * i);
    }
  };

  int acc[64];          // this thread's cells of the warpgroup's 64 x 128
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  const int nst = (nsteps + kSteps - 1) / kSteps;
  stage(0, 0);
  cp_async_commit();
  fence_operands(acc);
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    // stage st + 1 goes into the buffer stage st - 1 used, whose products
    // ended before the barrier at the end of the last round
    if (st + 1 < nst) {
      stage(st + 1, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t ab = sbase + (st & 1) * 2 * kStageBytes;
    const uint32_t bb = diag ? ab : ab + kStageBytes;
    const int ns = min(kSteps, nsteps - st * kSteps);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      if (kk < ns)
        wgmma_ss(acc, plane_desc(ab + kk * kStep + wg * (kStep / 2)),
                 plane_desc(bb + kk * kStep));
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();
  }
  fence_operands(acc);

  // epilogue: the warpgroups' sums into the 128 x 129 tile
  int* tile = reinterpret_cast<int*>(smem);
  const int wr = 64 * wg + 16 * (warp & 3);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(wr + g + 8 * (e >> 1)) * kOutPitch + 8 * j + 2 * t + (e & 1)] =
          acc[4 * j + e];
  __syncthreads();
  const int x0 = ti * kSites;
  const int y0 = tj * kSites;
  // (x, y) tables: run xl, vector v = 4 yl + a holds b = 0..3
  for (int i = tid; i < kSites * kSites * 4; i += kThreads) {
    const int xl = i >> 7;
    const int yl = (i >> 2) & 31;
    const int a = i & 3;
    if (x0 + xl < S && y0 + yl < S) {
      const int* src = tile + (4 * xl + a) * kOutPitch + 4 * yl;
      __stcs(reinterpret_cast<int4*>(
                 out + (((size_t)(x0 + xl) * S + y0 + yl) * 4 + a) * 4),
             make_int4(src[0], src[1], src[2], src[3]));
    }
  }
  if (diag) return;                        // the tile holds its mirror
  // (y, x) tables: run yl, vector v = 4 xl + b holds a = 0..3
  for (int i = tid; i < kSites * kSites * 4; i += kThreads) {
    const int yl = i >> 7;
    const int xl = (i >> 2) & 31;
    const int b = i & 3;
    if (x0 + xl < S && y0 + yl < S) {
      const int* src = tile + 4 * xl * kOutPitch + 4 * yl + b;
      __stcs(reinterpret_cast<int4*>(
                 out + (((size_t)(y0 + yl) * S + x0 + xl) * 4 + b) * 4),
             make_int4(src[0], src[kOutPitch], src[2 * kOutPitch],
                       src[3 * kOutPitch]));
    }
  }
}

}  // namespace

extern "C" {

// alleles: int8 rows of ld elements, columns 0 .. S - 1 (h rows); onehot:
// uint8 scratch of ceil(S / 32) * max(ceil(h / 32), 1) * 4,096 bytes;
// out: int32 [S, S, 4, 4].
int ggt_pair_allele_tables(const void* alleles, long long ld, int h, int S,
                           void* onehot, void* out, void* stream) {
  const int nsteps = h > 32 ? (h + 31) / 32 : 1;
  const int tiles = (S + kSites - 1) / kSites;
  const cudaStream_t st = (cudaStream_t)stream;
  // the shared-memory limit raised once per device (not at every launch,
  // so launches can be captured in a CUDA graph)
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(pair_tables_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  const dim3 pro(tiles, (2 * nsteps + kThreads / 32 - 1) / (kThreads / 32));
  onehot_kernel<<<pro, kThreads, 0, st>>>((const int8_t*)alleles, ld, h, S,
                                          nsteps, (uint8_t*)onehot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pair_tables_kernel<<<tiles * (tiles + 1) / 2, kThreads, kSmem, st>>>(
      (const uint8_t*)onehot, S, nsteps, tiles, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
