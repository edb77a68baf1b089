// Split one gzip member at its flush points and inflate the pieces apart.
//
// A deflate stream written with zlib's Z_SYNC_FLUSH or Z_FULL_FLUSH after
// independently compressed pieces (`pigz -i`, or any writer that deflates
// pieces in parallel and joins them) ends each piece with an empty stored
// block, whose LEN/NLEN bytes `00 00 FF FF` are the last four bytes before
// the next block, on a byte boundary.  The offset just past such bytes is a
// candidate piece start; the bytes can also occur inside a block, so a
// candidate is only proved true by inflating the piece before it from a
// true start to exactly that offset.
//
// Built by io/native.py (g++ -lz, a plain C interface for ctypes).

#include <cstdint>
#include <cstring>

#include <zlib.h>
#ifdef __SSE2__
#include <emmintrin.h>
#endif

namespace {

constexpr int64_t OK = 0, OUT_TOO_SMALL = -1, BAD = -2, NEEDS_WINDOW = -3;
constexpr int64_t ZCHUNK = 1 << 30;      // zlib's avail_* are 32-bit

// zlib raw inflate of in[0, len), primed with `dict` when it is given.
int64_t zlib_inflate(const uint8_t* in, int64_t len, int32_t last,
                     const uint8_t* dict, int64_t dict_len, uint8_t* out,
                     int64_t cap, int64_t* out_len, int64_t* in_used) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return BAD;
  if (dict_len > 0 &&
      inflateSetDictionary(&zs, dict, (uInt)dict_len) != Z_OK) {
    inflateEnd(&zs);
    return BAD;
  }
  int64_t in_off = 0, out_off = 0;
  int zr = Z_OK;
  while (true) {
    int64_t ni = len - in_off < ZCHUNK ? len - in_off : ZCHUNK;
    int64_t no = cap - out_off < ZCHUNK ? cap - out_off : ZCHUNK;
    zs.next_in = (Bytef*)(in + in_off);
    zs.avail_in = (uInt)ni;
    zs.next_out = out + out_off;
    zs.avail_out = (uInt)no;
    zr = inflate(&zs, Z_NO_FLUSH);
    in_off += ni - zs.avail_in;
    out_off += no - zs.avail_out;
    if (zr != Z_OK) break;
    if (in_off == len || out_off == cap) break;
  }
  // data_type: 128 when inflate stopped between blocks, 64 inside the
  // final block, plus the bits left unused in the last byte read
  int at_boundary = (zs.data_type & 128) && !(zs.data_type & 64) &&
                    (zs.data_type & 63) == 0;
  bool too_far = zr == Z_DATA_ERROR && zs.msg &&
                 strcmp(zs.msg, "invalid distance too far back") == 0;
  inflateEnd(&zs);
  *out_len = out_off;
  *in_used = in_off;
  if (too_far) return NEEDS_WINDOW;
  if (last ? zr == Z_STREAM_END
           : (zr == Z_OK || zr == Z_BUF_ERROR) && in_off == len && at_boundary)
    return OK;
  if (out_off == cap && zr != Z_DATA_ERROR && zr != Z_STREAM_END)
    return OUT_TOO_SMALL;
  return BAD;
}

// gzip's CRC-32 of out[0, n)
uint32_t crc32_of(const uint8_t* out, int64_t n) {
  uLong c = crc32(0L, Z_NULL, 0);
  for (int64_t off = 0; off < n; off += ZCHUNK) {
    int64_t k = n - off < ZCHUNK ? n - off : ZCHUNK;
    c = crc32(c, out + off, (uInt)k);
  }
  return (uint32_t)c;
}

}  // namespace

extern "C" {

// Candidate segment starts in d[from, to), grouped so that every segment
// holds at least `seg_min` bytes.  kind 1: flush points, the offset just
// past `00 00 FF FF`; kind 0: gzip member headers, `1F 8B 08` and a flag
// byte below 0x20.  Writes the bounds (from, ..., to) to bounds[0, cap)
// and returns their count, or -1 when cap is too small.
int64_t gzs_scan(const uint8_t* d, int64_t from, int64_t to, int64_t seg_min,
                 int32_t kind, int64_t* bounds, int64_t cap) {
  if (cap < 2) return -1;
  const uint8_t b0 = kind ? 0xFF : 0x1F, b1 = kind ? 0xFF : 0x8B;
  int64_t n = 0;
  bounds[n++] = from;
  // a hit is a pair (b0, b1) at j, j + 1; the rest of the pattern is
  // checked around it
  auto hit = [&](int64_t j) -> int64_t {
    int64_t c = -1;
    if (kind) {
      if (j - 2 >= from && d[j - 1] == 0 && d[j - 2] == 0) c = j + 2;
    } else if (j + 3 < to && d[j + 2] == 0x08 && d[j + 3] < 0x20) {
      c = j;
    }
    if (c > from && c - bounds[n - 1] >= seg_min && to - c >= seg_min) {
      if (n + 1 >= cap) return -1;
      bounds[n++] = c;
    }
    return 0;
  };
  int64_t i = from;
#ifdef __SSE2__
  const __m128i v0 = _mm_set1_epi8((char)b0), v1 = _mm_set1_epi8((char)b1);
  for (; i + 17 <= to; i += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(d + i));
    __m128i y = _mm_loadu_si128((const __m128i*)(d + i + 1));
    unsigned m = (unsigned)_mm_movemask_epi8(
        _mm_and_si128(_mm_cmpeq_epi8(x, v0), _mm_cmpeq_epi8(y, v1)));
    for (; m; m &= m - 1)
      if (hit(i + __builtin_ctz(m)) < 0) return -1;
  }
#endif
  for (; i + 1 < to; ++i)
    if (d[i] == b0 && d[i + 1] == b1 && hit(i) < 0) return -1;
  bounds[n++] = to;
  return n;
}

// Inflate the raw deflate piece in[0, len) into out[0, cap).
//   last = 0: the piece must end exactly at len between two blocks (a
//             flush point), the last block not final;
//   last = 1: inflate through the final block; *in_used says where it ended.
// `dict` (dict_len > 0) primes the window with the text before the piece.
// *crc is the CRC-32 of the *out_len bytes written.  Returns 0; -1 when out
// is too small; -2 on bad data or a piece that does not end at a flush
// point; -3 when a match reaches before the piece's start (the stream needs
// the window of the text before it).
int64_t gzs_inflate(const uint8_t* in, int64_t len, int32_t last,
                    const uint8_t* dict, int64_t dict_len, uint8_t* out,
                    int64_t cap, int64_t* out_len, int64_t* in_used,
                    uint32_t* crc) {
  int64_t r = zlib_inflate(in, len, last, dict, dict_len, out, cap, out_len,
                           in_used);
  if (r != OK) return r;
  *crc = crc32_of(out, *out_len);
  return OK;
}

uint32_t gzs_crc32_combine(uint32_t crc1, uint32_t crc2, int64_t len2) {
  return (uint32_t)crc32_combine(crc1, crc2, (z_off_t)len2);
}

}  // extern "C"
