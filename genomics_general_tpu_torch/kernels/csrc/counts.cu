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

// ---------------------------------------------------------------- K6
// site_pop_counts — replaces genomics_general_tpu/kernels/counts.py
// site_pop_counts / _site_pop_counts_u16 and the _unpack of
// kernels/transfer.py unpack_span:
//   out[s - s0, p, a] = #rows r of group p with a called code a at site s
// for s in [s0, s1).  Rows are grouped (perm[offs[p] .. offs[p+1]) are the
// rows of p); the wrapper checks that every row is in exactly one group,
// which is the JAX one-hot matmul for such a 0/1 mask.
//
// Bound: bytes — 3/8 byte per (row, site) read against a few integer
// operations.  Design: one thread per code byte (4 sites) walks the rows
// group by group; a warp's 32 threads read 32 consecutive code bytes and 16
// miss bytes of one row per step, and keep 16 counters (4 sites x 4
// alleles) in registers.  s0 is a multiple of 8, so the block starts on a
// whole byte of both planes.  Counts are exact integers; the wrapper picks
// uint16 only when h < 2^16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
site_pop_counts_kernel(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ miss, int c4, int m8,
                       int s0, int s1, const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ offs, int P,
                       T* __restrict__ out) {
  const int b = s0 / 4 + blockIdx.x * kThreads + threadIdx.x;
  const int site0 = 4 * b;
  if (site0 >= s1) return;
  const int shift = (b & 1) * 4;
  for (int p = 0; p < P; ++p) {
    int cnt[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int a = 0; a < 4; ++a) cnt[k][a] = 0;
    const int r_end = offs[p + 1];
    for (int r = offs[p]; r < r_end; ++r) {
      const size_t row = (size_t)perm[r];
      const unsigned c = codes[row * c4 + b];
      const unsigned mb = (miss[row * m8 + (b >> 1)] >> shift) & 0xFu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned a = (c >> (2 * k)) & 3u;
        const int called = !((mb >> k) & 1u);
#pragma unroll
        for (int x = 0; x < 4; ++x) cnt[k][x] += called & (a == (unsigned)x);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int site = site0 + k;
      if (site < s1) {
        T* o = out + ((size_t)(site - s0) * P + p) * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a) o[a] = (T)cnt[k][a];
      }
    }
  }
}

// ---------------------------------------------------------------- K12
// site_pop_counts_raw — replaces genomics_general_tpu/kernels/counts.py
// site_pop_counts / _site_pop_counts_u16 on an int8 [H, S] allele matrix:
//   out[s - s0, p, a] = #rows r of group p with alleles[r, s] == a
// for s in [s0, s1) and a in 0..3, the JAX one-hot matmul for a partition
// (perm / offs as in K6).  A code below 0 is missing and a code above 3
// counts nowhere, as in the JAX one-hot.
//
// Bound: bytes — one byte per (row, site) read against a few integer
// operations, so the card must be filled with short chains of loads.
// Design: the row-slot loop count_groups (below, shared with K18) on the
// 4 one-hot planes:
// - a block owns 4 * lanes sites of one group (blockIdx.y) and its 256
//   threads form 256 / lanes row slots: the group's rows are dealt over
//   the slots, so every warp reads its share.  lanes is 16 a row while the
//   span's blocks still give four a SM, else 8, so that a few groups fill
//   the card too (on the H100, 32 lanes ran no faster than 16 with many
//   groups, and 8 lanes were faster only with few);
// - a lane reads 4 sites of a row as one 32-bit word (two aligned words
//   and a funnel shift where the row's address is not 4-byte aligned:
//   rows are read through their stride, which may be odd), a warp's lanes
//   along the row, and counts them in packed byte lanes: the 4 one-hot
//   planes of the word (K9's decode) are added as 4 bytes at once, widened
//   into 32-bit counters after at most 255 rows; a slot loads 4 rows at
//   once;
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

// The row-slot loop K12 and K18 share.  A block owns sites b0 ..
// b0 + 4 kLanes - 1 (those at or past s1 read as missing) and counts
// groups g0, g0 + gstep, .. below G one after another (perm[offs[g] ..
// offs[g + 1]) are the rows of g): for each, kPlanes x 4 counts a lane
// over its slot's rows, summed over the slots into part; then
// epi(g, part) reads the block's sums through slot_sum(), and the next
// group's first rows load while the sums meet.
template <int kPlanes, int kLanes, typename Epi>
__device__ __forceinline__ void count_groups(
    const int8_t* __restrict__ alleles, long long row_stride, int b0, int s1,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ offs,
    int g0, int gstep, int G, int* part, Epi&& epi) {
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
      x[u] = r < r_end ? load_codes4(alleles + (long long)perm[r] * row_stride,
                                     c, s1)
                       : ~0u;
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

template <typename T, int kLanes>
__global__ void __launch_bounds__(kThreads)
site_pop_counts_raw_kernel(const int8_t* __restrict__ alleles,
                           long long row_stride, int s0, int s1,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ offs, int P,
                           T* __restrict__ out) {
  __shared__ __align__(16) int part[kPartInts<4, kLanes>];
  const int b0 = s0 + blockIdx.x * 4 * kLanes;
  // element e: site e / 4 of the block, code e % 4
  count_groups<4, kLanes>(
      alleles, row_stride, b0, s1, perm, offs, blockIdx.y, gridDim.y, P, part,
      [&](int p, const int* sums) {
        for (int e = threadIdx.x; e < 16 * kLanes; e += kThreads) {
          const int site = e >> 2;
          if (b0 + site < s1)
            out[((size_t)(b0 + site - s0) * P + p) * 4 + (e & 3)] =
                (T)slot_sum<4, kLanes>(sums, site, e & 3);
        }
      });
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
// once, against a few integer operations a site.  Design: one thread per
// site, the totals and the stable rank in registers, one int32 atomicAdd
// into the zeroed histogram per passing site (exact in any order).
template <typename T>
__global__ void __launch_bounds__(kThreads)
global_sfs_hist_kernel(const T* __restrict__ counts, int S, int P,
                       const int32_t* __restrict__ n_hap, long long nbins,
                       int32_t* __restrict__ hist) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const T* c = counts + (size_t)s * P * 4;
  long long tot[4] = {0, 0, 0, 0};
  for (int p = 0; p < P; ++p) {
    long long sum = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long v = c[4 * p + a];
      sum += v;
      tot[a] += v;
    }
    if (sum != n_hap[p]) return;
  }
  int n_alleles = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) n_alleles += tot[a] > 0;
  if (n_alleles < 1 || n_alleles > 2) return;
  int target = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rank += tot[j] < tot[i] || (j < i && tot[j] == tot[i]);
    if (rank == 2) target = i;
  }
  long long idx = 0;
  long long stride = 1;
  for (int p = P - 1; p >= 0; --p) {
    idx += (long long)c[4 * p + target] * stride;
    stride *= n_hap[p] + 1;
  }
  if (idx >= 0 && idx < nbins) atomicAdd(&hist[idx], 1);
}

// ---------------------------------------------------------------- K16
// stacked_reduce — replaces the reduce of
// genomics_general_tpu/parallel/multihost.py mesh_reduce_stacked (and the
// psum of mesh.py sharded_global_sfs): out[i] = sum or min over r of
// x[r, i] for a [k, n] stack of integer accumulators.
//
// Bound: bytes — k n elements read once, n written, one operation each.
// Design: one thread per column, grid-stride, reading row r of a warp's 32
// columns as one coalesced segment; the sum wraps modulo 2^bits (added as
// unsigned), as torch.sum in that type does.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stacked_reduce_kernel(const T* __restrict__ x, int k, long long n,
                      int op_min, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    using U = typename std::make_unsigned<T>::type;
    T acc = x[i];
    for (int r = 1; r < k; ++r) {
      const T v = x[(long long)r * n + i];
      acc = op_min ? (v < acc ? v : acc) : (T)((U)acc + (U)v);
    }
    out[i] = acc;
  }
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
      alleles, row_stride, b0, S, perm, offs, 0, 1, C, part,
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

}  // namespace

extern "C" {

// buf: the span wire of [h, sp]; out: [s1 - s0, P, 4] for sites s0 .. s1-1,
// uint16 when u16 != 0, else int32.
int ggt_site_pop_counts(const void* buf, int h, int sp, int s0, int s1,
                        const void* perm, const void* offs, int P, int u16,
                        void* out, void* stream) {
  const int c4 = sp / 4;
  const int m8 = sp / 8;
  const uint8_t* codes = (const uint8_t*)buf;
  const uint8_t* miss = codes + (size_t)h * c4;
  const int nbytes = (s1 - s0 + 3) / 4;
  const unsigned blocks = (unsigned)((nbytes + kThreads - 1) / kThreads);
  if (u16) {
    site_pop_counts_kernel<uint16_t><<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        codes, miss, c4, m8, s0, s1, (const int32_t*)perm,
        (const int32_t*)offs, P, (uint16_t*)out);
  } else {
    site_pop_counts_kernel<int32_t><<<blocks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        codes, miss, c4, m8, s0, s1, (const int32_t*)perm,
        (const int32_t*)offs, P, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// alleles: int8 rows of row_stride bytes (sites contiguous); out:
// [s1 - s0, P, 4] for sites s0 .. s1-1, uint16 when u16 != 0, else int32;
// lanes (16 or 8) a row, 4 sites a lane.
int ggt_site_pop_counts_raw(const void* alleles, long long row_stride,
                            int s0, int s1, const void* perm,
                            const void* offs, int P, int lanes, int u16,
                            void* out, void* stream) {
  const dim3 blocks((unsigned)((s1 - s0 + 4 * lanes - 1) / (4 * lanes)),
                    (unsigned)(P < 65535 ? P : 65535));
  const int8_t* a = (const int8_t*)alleles;
  const int32_t* pm = (const int32_t*)perm;
  const int32_t* of = (const int32_t*)offs;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 16 && u16)
    site_pop_counts_raw_kernel<uint16_t, 16><<<blocks, kThreads, 0, st>>>(
        a, row_stride, s0, s1, pm, of, P, (uint16_t*)out);
  else if (lanes == 16)
    site_pop_counts_raw_kernel<int32_t, 16><<<blocks, kThreads, 0, st>>>(
        a, row_stride, s0, s1, pm, of, P, (int32_t*)out);
  else if (lanes == 8 && u16)
    site_pop_counts_raw_kernel<uint16_t, 8><<<blocks, kThreads, 0, st>>>(
        a, row_stride, s0, s1, pm, of, P, (uint16_t*)out);
  else if (lanes == 8)
    site_pop_counts_raw_kernel<int32_t, 8><<<blocks, kThreads, 0, st>>>(
        a, row_stride, s0, s1, pm, of, P, (int32_t*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// counts: [S, P, 4], uint16 when u16 != 0, else int32; n_hap: int32 [P];
// hist: int32 [nbins], zeroed by the caller.
int ggt_global_sfs_hist(const void* counts, int u16, int S, int P,
                        const void* n_hap, long long nbins, void* hist,
                        void* stream) {
  const unsigned blocks = (unsigned)((S + kThreads - 1) / kThreads);
  if (u16) {
    global_sfs_hist_kernel<uint16_t><<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const uint16_t*)counts, S, P, (const int32_t*)n_hap, nbins,
        (int32_t*)hist);
  } else {
    global_sfs_hist_kernel<int32_t><<<blocks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const int32_t*)counts, S, P, (const int32_t*)n_hap, nbins,
        (int32_t*)hist);
  }
  return (int)cudaGetLastError();
}

// x: [k, n] (k >= 1), int64 when is64 != 0, else int32; out: [n] of the
// same type: the sum over k, or the minimum when op_min != 0.
int ggt_stacked_reduce(const void* x, int is64, int k, long long n,
                       int op_min, void* out, void* stream) {
  long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  if (is64) {
    stacked_reduce_kernel<long long><<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const long long*)x, k, n, op_min, (long long*)out);
  } else {
    stacked_reduce_kernel<int32_t><<<blocks, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const int32_t*)x, k, n, op_min, (int32_t*)out);
  }
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
