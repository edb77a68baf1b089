// Per-site, per-population allele counts for Hopper (sm_90a): K6 reads the
// 2-bit span wire in place, K12 an int8 allele matrix (the raw upload, or a
// view of a device array).  Beside them the mesh's two reductions: K15 bins
// a shard's per-site counts into the folded joint SFS, K16 sums or takes
// the minimum of a stack of accumulators; and two per-site library
// functions on an int8 matrix: K18 counts the called haplotypes of each
// population, K19 writes each haplotype's one-hot code.
//
// Plain C launch interface (extern "C", bound with ctypes from
// kernels/counts.py).  The launch goes on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
//
// Span wire (kernels/transfer.py pack_span) for [h, sp] sites: codes, h rows
// of sp/4 bytes, site 4b + k in bits 2k..2k+1 of byte b; then miss, h rows
// of sp/8 bytes, site 8b + k in bit k of byte b (1 = missing; pad sites
// past the span are missing).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------- K6, K12
// site_pop_counts (K6) — replaces genomics_general_tpu/kernels/counts.py
// site_pop_counts / _site_pop_counts_u16 with the _unpack of
// kernels/transfer.py unpack_span, on the span wire; site_pop_counts_raw
// (K12) — the same JAX functions on an int8 [H, S] allele matrix:
//   out[s - s0, p, a] = #rows r of group p with a called code a at site s
// for s in [s0, s1) and a in 0..3, the JAX one-hot matmul for a partition
// (perm[offs[p] .. offs[p+1]) are the rows of p; the wrapper checks that
// every row is in exactly one group).  On the span wire a set miss bit is
// missing; in an int8 matrix a code below 0 is missing and a code above 3
// counts nowhere, as in the JAX one-hot.
//
// Bound: bytes — 3/8 byte (K6) or one byte (K12) per (row, site) read
// against a few integer operations, so the card must be filled with short
// chains of loads.  Design: the row-slot loop count_groups (below, shared
// with K18) on the 4 one-hot planes, the rows read through a policy
// (ByteRows for int8 rows, SpanRows for the span wire) that gives a lane
// the codes of 4 sites of a row as one word of 4 int8 codes:
// - a block owns 4 * lanes sites of one group (blockIdx.y) and its 256
//   threads form 256 / lanes row slots: the group's rows are dealt over
//   the slots, so every warp reads its share.  lanes is 16 a row while the
//   span's blocks still give four a SM, else 8, so that a few groups fill
//   the card too (on the H100, 32 lanes ran no faster than 16 with many
//   groups, and 8 lanes were faster only with few);
// - K12's lane reads 4 sites of a row as one 32-bit word (two aligned
//   words and a funnel shift where the row's address is not 4-byte
//   aligned: rows are read through their stride, which may be odd); K6's
//   lane reads one code byte and the miss nibble beside it (s0 is a
//   multiple of 8, so a lane's 4 sites start on a code byte and a miss
//   nibble) and spreads them into the same word;
// - a warp's lanes lie along the row, and count the word in packed byte
//   lanes: its 4 one-hot planes (K9's decode) are added as 4 bytes at
//   once, widened into 32-bit counters after at most 255 rows; a slot
//   loads 4 rows at once;
// - the slots' counters meet through warp shuffles, then in shared
//   memory, and the block writes its group's [sites, 4] once: no global
//   atomics, so the order is fixed and the counts exact.  The wrapper
//   picks uint16 only when h < 2^16.
constexpr uint32_t kLow = 0x01010101u;  // bit 0 of each byte

// Codes of sites c .. c + 3 of a row, -1 at sites >= s1 (c < s1 reads
// only the aligned words that hold a site below s1).
__device__ __forceinline__ uint32_t load_codes4(const int8_t* row, int c,
                                                int s1) {
  const int nv = s1 - c;
  if (nv <= 0) return ~0u;
  const uintptr_t p = (uintptr_t)(row + c);
  const int sh = (int)(p & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - sh);
  const uint32_t hi = sh && nv > 4 - sh ? w[1] : ~0u;
  uint32_t v = __funnelshift_r(w[0], hi, 8 * sh);
  if (nv < 4) v |= ~0u << (8 * nv);
  return v;
}

// int8 rows of `stride` bytes, sites contiguous (K12, K18).
struct ByteRows {
  const int8_t* alleles;
  long long stride;
  int s1;
  __device__ __forceinline__ uint32_t operator()(int row, int c) const {
    return load_codes4(alleles + row * stride, c, s1);
  }
};

// The span wire's rows (K6): codes, c4 bytes a row, site 4 b + k in bits
// 2 k .. 2 k + 1 of byte b; miss, m8 bytes a row, site 8 b + k in bit k of
// byte b.  A lane's sites c .. c + 3 (c a multiple of 4) are code byte
// c / 4 and the miss nibble at bit c & 4 of byte c / 8: the code byte's
// pairs go to bits 0..1 of bytes 0..3, the nibble's bits to bit 0 of
// bytes 0..3 (its four shifted copies occupy disjoint bits, so nothing
// carries), and a missing site's byte becomes 0xFF (-1); sites at or past
// s1 read as missing, and nothing is read past a row.
struct SpanRows {
  const uint8_t* codes;
  const uint8_t* miss;
  int c4, m8, s1;
  __device__ __forceinline__ uint32_t operator()(int row, int c) const {
    const int nv = s1 - c;
    if (nv <= 0) return ~0u;
    const uint32_t b = codes[(long long)row * c4 + (c >> 2)];
    const uint32_t m = (miss[(long long)row * m8 + (c >> 3)] >> (c & 4)) &
                       0xFu;
    const uint32_t x = (b | b << 6 | b << 12 | b << 18) & 0x03030303u;
    uint32_t v = x | ((m * 0x00204081u) & kLow) * 0xFFu;
    if (nv < 4) v |= ~0u << (8 * nv);
    return v;
  }
};

constexpr int kRowsAtOnce = 4;   // rows a row slot loads before counting

// The 0/1 planes of a word of 4 codes, byte k for code k: kPlanes 4, the
// codes 0..3 (K9's decode: bits 2..7 of a byte, moved to bits 1..6 and
// added to 0x7E, carry into bit 7 unless they are all 0); kPlanes 1,
// called (code >= 0).
template <int kPlanes>
__device__ __forceinline__ void planes_of(uint32_t v,
                                          uint32_t (&pl)[kPlanes]) {
  if constexpr (kPlanes == 1) {
    pl[0] = ~(v >> 7) & kLow;
  } else {
    static_assert(kPlanes == 4, "4 one-hot planes or 1 called plane");
    const uint32_t v1 = v >> 1;
    const uint32_t t = (v1 & 0x7E7E7E7Eu) + 0x7E7E7E7Eu;
    const uint32_t ia = ~(t >> 7) & kLow;         // code in 0..3
    pl[0] = ia & ~v & ~v1;
    pl[1] = ia & v & ~v1;
    pl[2] = ia & ~v & v1;
    pl[3] = ia & v & v1;
  }
}

// Shared memory of count_groups' slot sums: [warp][lane][plane][site].
template <int kPlanes, int kLanes>
constexpr int kPartInts = kThreads / 32 * kLanes * 4 * kPlanes;

// The row-slot loop K6, K12 and K18 share.  A block owns sites b0 ..
// b0 + 4 kLanes - 1 (rows(row, c) gives the codes of sites c .. c + 3 of
// a row, -1 at and past the span's end) and counts groups g0, g0 + gstep,
// .. below G one after another (perm[offs[g] .. offs[g + 1]) are the rows
// of g): for each, kPlanes x 4 counts a lane over its slot's rows, summed
// over the slots into part; then epi(g, part) reads the block's sums
// through slot_sum(), and the next group's first rows load while the sums
// meet.
template <int kPlanes, int kLanes, typename Rows, typename Epi>
__device__ __forceinline__ void count_groups(
    Rows rows, int b0, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ offs, int g0, int gstep, int G, int* part,
    Epi&& epi) {
  constexpr int kSlots = kThreads / kLanes;           // row slots
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int slot = tid / kLanes;
  const int lane_r = tid % kLanes;                    // lane in the row
  const int c = b0 + 4 * lane_r;                      // this lane's sites
  // this lane's codes of rows r0, r0 + kSlots, .. (kRowsAtOnce of them)
  // of group g, -1 words past the group: independent loads, in flight
  // together
  uint32_t x[kRowsAtOnce];
  auto fetch = [&](int g, int r0) {
    const int r_end = offs[g + 1];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      const int r = r0 + u * kSlots;
      x[u] = r < r_end ? rows(perm[r], c) : ~0u;
    }
  };
  if (g0 < G) fetch(g0, offs[g0] + slot);
  for (int g = g0; g < G; g += gstep) {
    int cnt[kPlanes][4];                              // [plane][site]
#pragma unroll
    for (int a = 0; a < kPlanes; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt[a][k] = 0;
    uint32_t acc[kPlanes];                            // byte k: site k
#pragma unroll
    for (int a = 0; a < kPlanes; ++a) acc[a] = 0u;
    int packed = 0;                                   // rows in acc
    const int r_end = offs[g + 1];
    for (int r0 = offs[g] + slot;;) {
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        uint32_t pl[kPlanes];
        planes_of<kPlanes>(x[u], pl);
#pragma unroll
        for (int a = 0; a < kPlanes; ++a) acc[a] += pl[a];
      }
      packed += kRowsAtOnce;
      r0 += kRowsAtOnce * kSlots;
      const bool more = r0 < r_end;
      if (!more || packed > 255 - kRowsAtOnce) {
        // widen the byte lanes before they could pass 255
#pragma unroll
        for (int a = 0; a < kPlanes; ++a) {
#pragma unroll
          for (int k = 0; k < 4; ++k) cnt[a][k] += (acc[a] >> (8 * k)) & 0xFF;
          acc[a] = 0u;
        }
        packed = 0;
      }
      if (!more) break;
      fetch(g, r0);
    }
    // the next group's first rows load during this group's sums
    if (g + gstep < G) fetch(g + gstep, offs[g + gstep] + slot);
    // sum the warp's slots (lanes kLanes apart), then the warps
#pragma unroll
    for (int a = 0; a < kPlanes; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          cnt[a][k] += __shfl_xor_sync(0xFFFFFFFFu, cnt[a][k], o);
    if ((tid & 31) < kLanes) {
      int4* mine = reinterpret_cast<int4*>(
          part + 4 * kPlanes * (warp * kLanes + lane_r));
#pragma unroll
      for (int a = 0; a < kPlanes; ++a)
        mine[a] = make_int4(cnt[a][0], cnt[a][1], cnt[a][2], cnt[a][3]);
    }
    __syncthreads();
    epi(g, (const int*)part);
    __syncthreads();
  }
}

// The block's count of plane a at its site `site` (0 .. 4 kLanes - 1),
// summed over the warps' slot sums in part.
template <int kPlanes, int kLanes>
__device__ __forceinline__ int slot_sum(const int* part, int site, int a) {
  const int* src = part + 4 * kPlanes * (site >> 2) + 4 * a + (site & 3);
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w)
    sum += src[4 * kPlanes * kLanes * w];
  return sum;
}

// K6's and K12's body: sites s0 .. s1 - 1 of every group, rows read
// through `rows`, into out [s1 - s0, P, 4].
template <typename T, int kLanes, typename Rows>
__device__ __forceinline__ void count_sites(Rows rows, int s0, int s1,
                                            const int32_t* __restrict__ perm,
                                            const int32_t* __restrict__ offs,
                                            int P, T* __restrict__ out) {
  __shared__ __align__(16) int part[kPartInts<4, kLanes>];
  const int b0 = s0 + blockIdx.x * 4 * kLanes;
  // element e: site e / 4 of the block, code e % 4
  count_groups<4, kLanes>(
      rows, b0, perm, offs, blockIdx.y, gridDim.y, P, part,
      [&](int p, const int* sums) {
        for (int e = threadIdx.x; e < 16 * kLanes; e += kThreads) {
          const int site = e >> 2;
          if (b0 + site < s1)
            out[((size_t)(b0 + site - s0) * P + p) * 4 + (e & 3)] =
                (T)slot_sum<4, kLanes>(sums, site, e & 3);
        }
      });
}

// The kernels take the rows' fields as scalars: with a struct parameter
// K12 took more registers, and one block a SM fewer fit.
template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
site_pop_counts_kernel(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ miss, int c4, int m8,
                       int s0, int s1, const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offs, int P,
                       T* __restrict__ out) {
  count_sites<T, kLanes>(SpanRows{codes, miss, c4, m8, s1}, s0, s1, perm,
                         offs, P, out);
}

template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
site_pop_counts_raw_kernel(const int8_t* __restrict__ alleles,
                           long long row_stride, int s0, int s1,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ offs, int P,
                           T* __restrict__ out) {
  count_sites<T, kLanes>(ByteRows{alleles, row_stride, s1}, s0, s1, perm,
                         offs, P, out);
}

// ---------------------------------------------------------------- K15
// global_sfs_hist — replaces the per-shard body of
// genomics_general_tpu/parallel/mesh.py sharded_global_sfs (its local():
// complete-data and 1-2 allele gate, second-commonest allele as target,
// scatter-add into a dense histogram):
//   site s passes when every population's count sum equals n_hap[p] and
//   its totals over the populations have 1 or 2 non-zero alleles; its
//   target is the allele at position 2 of the STABLE ascending order of
//   the totals (jnp.argsort's: rank(i) = #{j : t_j < t_i} +
//   #{j < i : t_j == t_i}); it adds 1 to bin sum_p c[s, p, target] *
//   stride_p, row-major with population 0 most significant.
//
// Bound: bytes — the [S, P, 4] counts read once and the histogram written
// once (its zeroing, by the wrapper), against a few integer operations a
// site.  What bounds it on the H100 is atomics (k15_breakdown.py): every
// monomorphic site lands in bin 0 (the third zero total is the target),
// 4.7 % of the cohort's sites, serialised on one address; and the other
// sites scatter (31.2 distinct bins in 32 consecutive sites), one L2
// atomic each, which alone take longer than the bytes (the 455,188 sites
// outside the corner take 0.0146 ms, the reads 0.0033).  Design:
// - a grid of a few blocks an SM walks tiles of `tile` sites; a tile's
//   counts are one contiguous run, read as 16-byte vectors into shared
//   memory at the same offset mod 16 as in device memory (so a view off a
//   16-byte boundary, c[1:], reads a scalar head and tail), and each
//   thread takes its sites from there;
// - 64-bit arithmetic, wrapping as the int64 plain version does (int32
//   counts may be negative or sum past 2^31; a histogram may pass 2^31
//   bins);
// - the low corner (every population's target count below cdim[p], the
//   wrapper's choice within a byte budget) is each block's private int32
//   histogram in shared memory: bin 0 and the lowest bins add there, and
//   the block flushes each non-zero corner entry with one global atomic
//   at its end (a large corner loses: a block holds few sites of any but
//   the hottest bins, so its flush costs about an atomic a site);
// - every passing site first joins its warp's lanes with the same bin
//   (__match_any_sync) and the group's first lane adds the group's size,
//   shared or global: a run of one bin outside the corner (a file of
//   fixed differences) costs an atomic a warp, not a site.
// Exact in any order: integer adds.  The populations' strides, n_hap and
// corner radices (the wrapper's int64 [4, P]) sit in shared memory.
__host__ __device__ constexpr long long align16(long long n) {
  return (n + 15) & ~15LL;
}

// K15's dynamic shared memory: the corner's int32 entries, the
// populations' constants, then the tile (16 bytes of slack for its
// offset mod 16).
template <typename T>
__host__ __device__ constexpr long long sfs_smem_bytes(int P, int ncorner,
                                                       int tile) {
  return align16(4LL * ncorner) + align16(24LL * P)
         + align16(4LL * P * tile * (long long)sizeof(T)) + 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
global_sfs_hist_kernel(const T* __restrict__ counts, int S, int P, int tile,
                       const long long* __restrict__ pop, int ncorner,
                       long long nbins, int32_t* __restrict__ hist) {
  constexpr int V = 16 / sizeof(T);            // elements a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* corner = reinterpret_cast<int32_t*>(smem);
  unsigned long long* stride =
      reinterpret_cast<unsigned long long*>(smem + align16(4LL * ncorner));
  long long* nh = reinterpret_cast<long long*>(stride + P);
  int* cdim = reinterpret_cast<int*>(nh + P);
  int* cstride = cdim + P;
  T* stage = reinterpret_cast<T*>(smem + align16(4LL * ncorner) +
                                  align16(24LL * P));
  for (int p = threadIdx.x; p < P; p += kThreads) {
    stride[p] = (unsigned long long)pop[p];
    nh[p] = pop[P + p];
    cdim[p] = (int)pop[2 * P + p];
    cstride[p] = (int)pop[3 * P + p];
  }
  for (int i = threadIdx.x; i < ncorner; i += kThreads) corner[i] = 0;

  const int lane = threadIdx.x & 31;
  const long long per = 4LL * P;               // elements a site
  const int m0 = (int)(((uintptr_t)counts / sizeof(T)) % V);
  const int ntiles = (S + tile - 1) / tile;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int s0 = t * tile;
    const int ns = min(tile, S - s0);
    const long long e0 = s0 * per;
    const long long e1 = e0 + ns * per;
    // element e sits at stage[e - e0 + r]: the same offset mod 16 as in
    // device memory, so [ea, eb) moves as aligned vectors
    const int r = (int)((m0 + e0) % V);
    const long long ea = min(e1, e0 + (V - r) % V);
    const long long eb = max(ea, e1 - (m0 + e1) % V);
    __syncthreads();                           // the last tile is read
    const uint4* src = reinterpret_cast<const uint4*>(counts + ea);
    uint4* dst = reinterpret_cast<uint4*>(stage + (ea - e0 + r));
    const int nv = (int)((eb - ea) / V);
    for (int i = threadIdx.x; i < nv; i += kThreads)
      dst[i] = __ldcs(src + i);
    if (threadIdx.x < ea - e0)
      stage[r + threadIdx.x] = counts[e0 + threadIdx.x];
    if (threadIdx.x < e1 - eb)
      stage[eb - e0 + r + threadIdx.x] = counts[eb + threadIdx.x];
    __syncthreads();
    // every lane runs every step, so the warp's vote and match see it
    for (int j0 = 0; j0 < ns; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      const T* c = stage + r + (j < ns ? j : 0) * per;
      long long tot[4] = {0, 0, 0, 0};
      bool ok = j < ns;
      for (int p = 0; p < P; ++p) {
        long long sum = 0;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const long long v = c[4 * p + a];
          sum += v;
          tot[a] += v;
        }
        ok &= sum == nh[p];
      }
      const int n_alleles = (tot[0] > 0) + (tot[1] > 0) + (tot[2] > 0) +
                            (tot[3] > 0);
      ok &= n_alleles >= 1 && n_alleles <= 2;
      int target = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int rank = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          rank += tot[k] < tot[i] || (k < i && tot[k] == tot[i]);
        if (rank == 2) target = i;
      }
      unsigned long long idx = 0;
      unsigned ci = 0;
      bool in_corner = true;
      for (int p = 0; p < P; ++p) {
        const long long x = c[4 * p + target];
        idx += (unsigned long long)x * stride[p];
        in_corner &= x >= 0 && x < cdim[p];
        ci += (unsigned)x * (unsigned)cstride[p];
      }
      const unsigned want = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const unsigned grp = __match_any_sync(want, idx);
        if (lane == __ffs(grp) - 1) {
          if (in_corner)
            atomicAdd(&corner[ci], __popc(grp));
          else if ((long long)idx >= 0 && (long long)idx < nbins)
            atomicAdd(&hist[idx], __popc(grp));
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ncorner; i += kThreads) {
    const int v = corner[i];
    if (!v) continue;
    unsigned q = i;
    unsigned long long idx = 0;
    for (int p = P - 1; p >= 0; --p) {
      const unsigned d = q % (unsigned)cdim[p];
      q /= (unsigned)cdim[p];
      idx += (unsigned long long)d * stride[p];
    }
    atomicAdd(&hist[idx], v);
  }
}

// The shared-memory limit is raised once per device (the attribute is a
// device's) to the device's opt-in limit.
template <typename T>
int launch_global_sfs(const void* counts, int S, int P, int tile,
                      const void* pop, int ncorner, long long nbins,
                      int blocks, void* hist, cudaStream_t stream) {
  static bool raised[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(global_sfs_hist_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised[dev] = true;
  }
  const long long smem = sfs_smem_bytes<T>(P, ncorner, tile);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  global_sfs_hist_kernel<T><<<blocks, kThreads, (size_t)smem, stream>>>(
      (const T*)counts, S, P, tile, (const long long*)pop, ncorner, nbins,
      (int32_t*)hist);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K16
// stacked_reduce — replaces the reduce of
// genomics_general_tpu/parallel/multihost.py mesh_reduce_stacked (and the
// psum of mesh.py sharded_global_sfs): out[i] = sum or min over r of
// x[r, i] for a [k, n] stack of integer accumulators.
//
// Bound: bytes — k n elements read once, n written, one operation each.
// Design: 16-byte vectors of columns (four int32 or two int64 a thread),
// a grid of a few blocks an SM striding over them.  The output starts on
// a 16-byte boundary (the wrapper allocates it), but row r of the stack
// starts sh_r 4-byte words into its 16-byte word (n need not be a
// multiple of the vector, nor the stack's start aligned): such a row reads
// the two aligned words a vector straddles and shifts them together; each
// of the two holds bytes of the vector, so no load leaves the granules the
// row lies in.  Columns past the last whole vector take a scalar tail.
// The sum wraps modulo 2^bits (added as unsigned), as torch.sum in that
// type does.
__device__ __forceinline__ uint4 shift_words(uint4 a, uint4 b, int sh) {
  switch (sh) {
    case 0: return a;
    case 1: return make_uint4(a.y, a.z, a.w, b.x);
    case 2: return make_uint4(a.z, a.w, b.x, b.y);
    default: return make_uint4(a.w, b.x, b.y, b.z);
  }
}

template <typename T>
__device__ __forceinline__ T reduce_op(T acc, T v, int op_min) {
  using U = typename std::make_unsigned<T>::type;
  return op_min ? (v < acc ? v : acc) : (T)((U)acc + (U)v);
}

__device__ __forceinline__ long long word_pair(uint32_t lo, uint32_t hi) {
  return (long long)(((unsigned long long)hi << 32) | lo);
}

// a vector of four int32 or two int64 columns, as 32-bit words
template <typename T>
__device__ __forceinline__ uint4 reduce_vec(uint4 acc, uint4 v, int op_min) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(
        (uint32_t)reduce_op<int>((int)acc.x, (int)v.x, op_min),
        (uint32_t)reduce_op<int>((int)acc.y, (int)v.y, op_min),
        (uint32_t)reduce_op<int>((int)acc.z, (int)v.z, op_min),
        (uint32_t)reduce_op<int>((int)acc.w, (int)v.w, op_min));
  } else {
    const unsigned long long lo = (unsigned long long)reduce_op<long long>(
        word_pair(acc.x, acc.y), word_pair(v.x, v.y), op_min);
    const unsigned long long hi = (unsigned long long)reduce_op<long long>(
        word_pair(acc.z, acc.w), word_pair(v.z, v.w), op_min);
    return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                      (uint32_t)(hi >> 32));
  }
}

// nv whole vectors, columns 0 .. nv * V - 1 (nv = 0 when out is not
// 16-byte aligned); the tail nv * V .. n - 1 is scalar
template <typename T>
__global__ void __launch_bounds__(kThreads)
stacked_reduce_kernel(const T* __restrict__ x, int k, long long n,
                      long long nv, int op_min, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long j = first; j < nv; j += stride) {
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      const uintptr_t a = (uintptr_t)(x + (long long)r * n);
      const uint4* w = (const uint4*)(a & ~(uintptr_t)15) + j;
      const int sh = (int)(a & 15) >> 2;
      uint4 v = __ldg(w);
      if (sh) v = shift_words(v, __ldg(w + 1), sh);
      acc = r ? reduce_vec<T>(acc, v, op_min) : v;
    }
    reinterpret_cast<uint4*>(out)[j] = acc;
  }
  for (long long i = nv * V + first; i < n; i += stride) {
    T acc = x[i];
    for (int r = 1; r < k; ++r)
      acc = reduce_op<T>(acc, x[(long long)r * n + i], op_min);
    out[i] = acc;
  }
}

template <typename T>
void launch_stacked_reduce(const void* x, int k, long long n, int op_min,
                           void* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long nv = ((uintptr_t)out & 15) ? 0 : n / V;
  const long long items = nv > n - nv * V ? nv : n - nv * V;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
  stacked_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, k, n, nv, op_min, (T*)out);
}

// ---------------------------------------------------------------- K18
// site_nonmissing — replaces genomics_general_tpu/kernels/counts.py
// site_nonmissing:
//   out[s, p] = #rows r with mask[p, r] == 1 and alleles[r, s] >= 0
// the JAX matmul of the 0/1 mask with the called matrix.  Any 0/1 mask is
// counted on its membership classes (perm / offs as in K6, one group per
// distinct mask column; the wrapper leaves out the class in no mask row);
// bits[c, p] says whether class c lies in mask row p, so overlapping rows
// and rows in no mask count as in the matmul.
//
// Bound: bytes — one byte per (row, site) read against one comparison.
// Design: K12's row-slot loop (count_groups) on the one called plane, with
// the classes folded into mask rows inside the block:
// - a block owns 4 * lanes sites (lanes as K12's) and every class of them,
//   one class after another, and up to kFoldRows mask rows (blockIdx.y);
// - after each class, the block's thread e adds the class's count of site
//   e / pc into its (site, mask row) sums in registers where bits say so:
//   out is written once, with no zeroing pass and no atomics, in a fixed
//   order, so the counts are exact.
// On the H100 each class adds a step to the block's time; keeping two to
// four rounds of rows in flight a slot (the next class's loading while
// this one counts) ran no faster, and cost K12 registers.
constexpr int kFoldRows = 64;    // mask rows a block folds its classes into

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
site_nonmissing_kernel(const int8_t* __restrict__ alleles,
                       long long row_stride, int S,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offs, int C,
                       const int32_t* __restrict__ bits, int P,
                       int32_t* __restrict__ out) {
  constexpr int kSites = 4 * kLanes;
  constexpr int kPer = kSites * kFoldRows / kThreads;  // sums a thread
  __shared__ __align__(16) int part[kPartInts<1, kLanes>];
  const int b0 = blockIdx.x * kSites;
  const int p0 = blockIdx.y * kFoldRows;
  const int pc = min(P - p0, kFoldRows);
  const int n = kSites * pc;               // element e: site e / pc
  int sum[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) sum[i] = 0;
  count_groups<1, kLanes>(
      ByteRows{alleles, row_stride, S}, b0, perm, offs, 0, 1, C, part,
      [&](int c, const int* sums) {
        const int32_t* b = bits + (size_t)c * P + p0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = threadIdx.x + i * kThreads;
          if (e < n) {
            const int site = e / pc;
            if (b[e - site * pc]) sum[i] += slot_sum<1, kLanes>(sums, site, 0);
          }
        }
      });
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int site = e / pc;
    if (e < n && b0 + site < S)
      out[(size_t)(b0 + site) * P + p0 + e - site * pc] = sum[i];
  }
}

// ---------------------------------------------------------------- K19
// sample_base_counts — replaces genomics_general_tpu/kernels/counts.py
// sample_base_counts:
//   out[h, s, a] = (alleles[h, s] == a),  a in 0..3
// the JAX one-hot, so a missing call (-1) or any code outside 0..3 gives
// four zeros.
//
// Bound: bytes — 16 bytes written per byte read.  Design: one thread per
// (row, site), grid-stride over the H S cells in row-major order, so a
// warp reads 32 consecutive bytes and writes 512 consecutive bytes as one
// 16-byte int4 a thread.
__global__ void __launch_bounds__(kThreads)
sample_base_counts_kernel(const int8_t* __restrict__ alleles,
                          long long row_stride, int S, long long n,
                          int4* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / S;
    const int c = alleles[r * row_stride + (i - r * S)];
    out[i] = make_int4(c == 0, c == 1, c == 2, c == 3);
  }
}

// The kernel of the rows' kind: K6 for the span wire, K12 for int8 rows.
template <typename T, int kLanes>
void launch_rows(const SpanRows& r, dim3 blocks, cudaStream_t st, int s0,
                 int s1, const int32_t* perm, const int32_t* offs, int P,
                 void* out) {
  site_pop_counts_kernel<T, kLanes><<<blocks, kThreads, 0, st>>>(
      r.codes, r.miss, r.c4, r.m8, s0, s1, perm, offs, P, (T*)out);
}

template <typename T, int kLanes>
void launch_rows(const ByteRows& r, dim3 blocks, cudaStream_t st, int s0,
                 int s1, const int32_t* perm, const int32_t* offs, int P,
                 void* out) {
  site_pop_counts_raw_kernel<T, kLanes><<<blocks, kThreads, 0, st>>>(
      r.alleles, r.stride, s0, s1, perm, offs, P, (T*)out);
}

// K6 or K12 on grid (site blocks, groups): the kernel variant of lanes
// (16 or 8) a row and the output type.
template <typename Rows>
int launch_site_counts(const Rows& rows, int s0, int s1, const void* perm,
                       const void* offs, int P, int lanes, int u16,
                       void* out, void* stream) {
  const dim3 blocks((unsigned)((s1 - s0 + 4 * lanes - 1) / (4 * lanes)),
                    (unsigned)(P < 65535 ? P : 65535));
  const int32_t* pm = (const int32_t*)perm;
  const int32_t* of = (const int32_t*)offs;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 16 && u16)
    launch_rows<uint16_t, 16>(rows, blocks, st, s0, s1, pm, of, P, out);
  else if (lanes == 16)
    launch_rows<int32_t, 16>(rows, blocks, st, s0, s1, pm, of, P, out);
  else if (lanes == 8 && u16)
    launch_rows<uint16_t, 8>(rows, blocks, st, s0, s1, pm, of, P, out);
  else if (lanes == 8)
    launch_rows<int32_t, 8>(rows, blocks, st, s0, s1, pm, of, P, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buf: the span wire of [h, sp]; out: [s1 - s0, P, 4] for sites s0 .. s1-1
// (s0 a multiple of 8), uint16 when u16 != 0, else int32; lanes (16 or 8)
// a row, 4 sites a lane.
int ggt_site_pop_counts(const void* buf, int h, int sp, int s0, int s1,
                        const void* perm, const void* offs, int P, int lanes,
                        int u16, void* out, void* stream) {
  const uint8_t* codes = (const uint8_t*)buf;
  const SpanRows rows{codes, codes + (size_t)h * (sp / 4), sp / 4, sp / 8,
                      s1};
  return launch_site_counts(rows, s0, s1, perm, offs, P, lanes, u16, out,
                            stream);
}

// alleles: int8 rows of row_stride bytes (sites contiguous); out:
// [s1 - s0, P, 4] for sites s0 .. s1-1, uint16 when u16 != 0, else int32;
// lanes (16 or 8) a row, 4 sites a lane.
int ggt_site_pop_counts_raw(const void* alleles, long long row_stride,
                            int s0, int s1, const void* perm,
                            const void* offs, int P, int lanes, int u16,
                            void* out, void* stream) {
  const ByteRows rows{(const int8_t*)alleles, row_stride, s1};
  return launch_site_counts(rows, s0, s1, perm, offs, P, lanes, u16, out,
                            stream);
}

// counts: [S, P, 4], uint16 when u16 != 0, else int32; pop: int64 [4,
// P], each population's stride, n_hap, corner radix and corner stride;
// ncorner: the corner's entries (the product of the radices); tile: sites
// a tile; hist: int32 [nbins], zeroed by the caller.
int ggt_global_sfs_hist(const void* counts, int u16, int S, int P, int tile,
                        const void* pop, int ncorner, long long nbins,
                        int blocks, void* hist, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (u16)
    return launch_global_sfs<uint16_t>(counts, S, P, tile, pop, ncorner,
                                       nbins, blocks, hist, st);
  return launch_global_sfs<int32_t>(counts, S, P, tile, pop, ncorner, nbins,
                                    blocks, hist, st);
}

// x: [k, n] (k >= 1), int64 when is64 != 0, else int32; out: [n] of the
// same type: the sum over k, or the minimum when op_min != 0.
int ggt_stacked_reduce(const void* x, int is64, int k, long long n,
                       int op_min, void* out, void* stream) {
  if (is64)
    launch_stacked_reduce<long long>(x, k, n, op_min, out,
                                     (cudaStream_t)stream);
  else
    launch_stacked_reduce<int32_t>(x, k, n, op_min, out,
                                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// alleles: int8 rows of row_stride bytes (sites contiguous, columns
// 0 .. S - 1); perm, offs: the C membership classes; bits: int32 [C, P]
// 0/1; out: int32 [S, P]; lanes (16 or 8) a row, 4 sites a lane.
int ggt_site_nonmissing(const void* alleles, long long row_stride, int S,
                        const void* perm, const void* offs, int C,
                        const void* bits, int P, int lanes, void* out,
                        void* stream) {
  const dim3 blocks((unsigned)((S + 4 * lanes - 1) / (4 * lanes)),
                    (unsigned)((P + kFoldRows - 1) / kFoldRows));
  const int8_t* a = (const int8_t*)alleles;
  const int32_t* pm = (const int32_t*)perm;
  const int32_t* of = (const int32_t*)offs;
  const int32_t* bt = (const int32_t*)bits;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 16)
    site_nonmissing_kernel<16><<<blocks, kThreads, 0, st>>>(
        a, row_stride, S, pm, of, C, bt, P, (int32_t*)out);
  else if (lanes == 8)
    site_nonmissing_kernel<8><<<blocks, kThreads, 0, st>>>(
        a, row_stride, S, pm, of, C, bt, P, (int32_t*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// alleles: int8 [h, S] rows of row_stride bytes (sites contiguous); out:
// int32 [h, S, 4].
int ggt_sample_base_counts(const void* alleles, long long row_stride, int h,
                           int S, void* out, void* stream) {
  const long long n = (long long)h * S;
  long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  sample_base_counts_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)alleles, row_stride, S, n, (int4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
