// Joint allele tables of every site pair of an LD window for Hopper
// (sm_90a): K17, the device half of stats/ld.ld_matrix(use_device=True).
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/ld.py).  The launches go on the caller's stream, do not
// synchronise, allocate nothing (the wrapper passes the plane scratch), and
// the entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                  // sites per tile side
constexpr int kThreads = kTile * kTile;    // one thread per site pair
constexpr int kChunk = 32;                 // plane words staged per step
constexpr int kPitch = 4 * kChunk + 1;     // a site's staged words, padded
constexpr int kPackThreads = 256;

// ---------------------------------------------------------------- K17
// pair_allele_tables — replaces genomics_general_tpu/kernels/ld.py
// pair_allele_tables (window_pair_tables' device step):
//   N[x, y, a, b] = #haplotypes h with alleles[h, x] == a and
//                   alleles[h, y] == b,  a, b in 0..3
// the JAX one-hot Gram (onehot^T onehot, codes outside 0..3 one-hot to
// zero, so -1 and any other code count in no table).
//
// Bound: bytes — the output is 64 S^2 bytes against H S bytes read and
// S^2 16 H / 32 popcounts.  Design: a prologue packs each site's four code
// planes as haplotype bitmasks (planes[s][a][w], bit h % 32 of word h / 32
// set when alleles[h, s] == a; bits past H stay clear); then one block
// per (x tile, y tile) of 16 x 16 sites stages both tiles' planes, 32
// words at a time, in shared memory (a site's 128 words padded to 129, so
// the 16 y sites a warp reads fall in distinct banks), and each thread
// sums its pair's 16 counts as AND + popcount over the words in registers.
// The pair's 4 x 4 table is contiguous in [S, S, 4, 4]: each thread writes
// it as four 16-byte stores.
__global__ void __launch_bounds__(kPackThreads)
pack_planes_kernel(const int8_t* __restrict__ alleles, long long ld, int h,
                   int S, int nw, uint32_t* __restrict__ planes) {
  // thread (site, word): site fastest, so a warp reads 32 consecutive
  // bytes of each row
  const long long idx = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  if (idx >= (long long)S * nw) return;
  const int s = (int)(idx % S);
  const int w = (int)(idx / S);
  uint32_t p[4] = {0u, 0u, 0u, 0u};
  const int h0 = 32 * w;
  const int h1 = min(h, h0 + 32);
  for (int r = h0; r < h1; ++r) {
    const int c = alleles[(long long)r * ld + s];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (c == a) p[a] |= 1u << (r - h0);
  }
  uint32_t* o = planes + (size_t)s * 4 * nw + w;
#pragma unroll
  for (int a = 0; a < 4; ++a) o[(size_t)a * nw] = p[a];
}

__global__ void __launch_bounds__(kThreads)
pair_tables_kernel(const uint32_t* __restrict__ planes, int S, int nw,
                   int32_t* __restrict__ out) {
  __shared__ uint32_t sx[kTile][kPitch];
  __shared__ uint32_t sy[kTile][kPitch];
  const int tid = threadIdx.x;
  const int ty = tid / kTile;              // x site of the tile
  const int tx = tid % kTile;              // y site: a warp's fastest axis
  const int x0 = blockIdx.y * kTile;
  const int y0 = blockIdx.x * kTile;
  int acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0;

  for (int w0 = 0; w0 < nw; w0 += kChunk) {
    const int nk = min(kChunk, nw - w0);
    // stage: word k of plane a of tile site t at sx[t][a * kChunk + k];
    // sites past S and words past nw stage as 0
    for (int i = tid; i < kTile * 4 * kChunk; i += kThreads) {
      const int t = i / (4 * kChunk);
      const int a = (i / kChunk) % 4;
      const int k = i % kChunk;
      const int sxs = x0 + t;
      const int sys = y0 + t;
      uint32_t vx = 0u, vy = 0u;
      if (k < nk) {
        if (sxs < S) vx = planes[((size_t)sxs * 4 + a) * nw + w0 + k];
        if (sys < S) vy = planes[((size_t)sys * 4 + a) * nw + w0 + k];
      }
      sx[t][a * kChunk + k] = vx;
      sy[t][a * kChunk + k] = vy;
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      uint32_t px[4], py[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        px[a] = sx[ty][a * kChunk + k];
        py[a] = sy[tx][a * kChunk + k];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += __popc(px[a] & py[b]);
    }
    __syncthreads();
  }

  const int x = x0 + ty;
  const int y = y0 + tx;
  if (x >= S || y >= S) return;
  int4* o = reinterpret_cast<int4*>(out + ((size_t)x * S + y) * 16);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    o[a] = make_int4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

}  // namespace

extern "C" {

// alleles: int8 rows of ld elements, columns 0 .. S - 1 (h rows); planes:
// uint32 scratch of S * 4 * ceil(h / 32) words; out: int32 [S, S, 4, 4].
int ggt_pair_allele_tables(const void* alleles, long long ld, int h, int S,
                           void* planes, void* out, void* stream) {
  const int nw = (h + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nw > 0) {
    const long long n = (long long)S * nw;
    pack_planes_kernel<<<(unsigned)((n + kPackThreads - 1) / kPackThreads),
                         kPackThreads, 0, st>>>(
        (const int8_t*)alleles, ld, h, S, nw, (uint32_t*)planes);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const unsigned tiles = (unsigned)((S + kTile - 1) / kTile);
  dim3 grid(tiles, tiles);
  pair_tables_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)planes, S, nw, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
