// Native LZ4 *block* codec, the format inside BLOSC chunks (port of
// acceleratedvolrenderer_tpu/native/lz4.cpp, the same source).
//
// Written from the published LZ4 block format description (token =
// <litlen:4|matchlen:4>, 255-run length extensions, 16-bit little-endian
// match offsets, last 5 bytes literal, matches end >= 12 bytes before the
// block end).  Semantics mirror utils/blosc.py's pure-Python
// lz4_{compress,decompress}_block; the two interoperate in both
// directions (tests/test_torch_nvdb.py).
//
// Compiled alone with g++ into build/native/libavrt_lz4.so on first use
// (see native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kHashLog = 16;

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// Greedy single-entry-hash-table encoder.  Returns the compressed size,
// or -1 if `cap` is too small (callers pass n + n/255 + 16 which always
// suffices).  Output differs byte-for-byte from the Python encoder only
// where hash collisions skip a match the dict-based encoder finds; both
// are valid streams for any conformant decoder.
int64_t avrt_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  static thread_local int32_t table[1 << kHashLog];
  memset(table, -1, sizeof(table));
  int64_t i = 0, anchor = 0, o = 0;

  auto emit = [&](int64_t lit_start, int64_t lit_end, int64_t offset,
                  int64_t mlen) -> bool {
    int64_t lit = lit_end - lit_start;
    int64_t ml = mlen ? mlen - 4 : 0;
    int64_t need = 1 + lit + lit / 255 + 1 + (mlen ? 2 + ml / 255 + 1 : 0);
    if (o + need > cap) return false;
    uint8_t token = (uint8_t)((lit < 15 ? lit : 15) << 4);
    if (mlen) token |= (uint8_t)(ml < 15 ? ml : 15);
    dst[o++] = token;
    if (lit >= 15) {
      int64_t rest = lit - 15;
      while (rest >= 255) { dst[o++] = 255; rest -= 255; }
      dst[o++] = (uint8_t)rest;
    }
    memcpy(dst + o, src + lit_start, (size_t)lit);
    o += lit;
    if (mlen) {
      dst[o++] = (uint8_t)(offset & 0xFF);
      dst[o++] = (uint8_t)(offset >> 8);
      if (ml >= 15) {
        int64_t rest = ml - 15;
        while (rest >= 255) { dst[o++] = 255; rest -= 255; }
        dst[o++] = (uint8_t)rest;
      }
    }
    return true;
  };

  // spec: last 5 bytes are literals; the last match must start at least
  // 12 bytes before the end of the block
  while (i < n - 12) {
    uint32_t v;
    memcpy(&v, src + i, 4);
    uint32_t h = hash4(v);
    int64_t j = table[h];
    table[h] = (int32_t)i;
    uint32_t w = 0;
    if (j >= 0 && i - j <= 0xFFFF &&
        (memcpy(&w, src + j, 4), w == v)) {
      int64_t mlen = 4;
      int64_t limit = n - 5;
      while (i + mlen < limit && src[j + mlen] == src[i + mlen]) mlen++;
      if (!emit(anchor, i, i - j, mlen)) return -1;
      i += mlen;
      anchor = i;
    } else {
      i++;
    }
  }
  if (!emit(anchor, n, 0, 0)) return -1;
  return o;
}

// Returns the decoded size (== dst_size on success), or -1 on any
// malformed input (same failure set utils/blosc.py raises on).
int64_t avrt_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t dst_size) {
  int64_t si = 0, di = 0;
  while (si < n) {
    uint8_t token = src[si++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (si >= n) return -1;
        b = src[si++];
        lit += b;
      } while (b == 255);
    }
    if (si + lit > n || di + lit > dst_size) return -1;
    memcpy(dst + di, src + si, (size_t)lit);
    si += lit;
    di += lit;
    if (si >= n) break;  // last literals-only sequence
    if (si + 2 > n) return -1;
    int64_t offset = (int64_t)src[si] | ((int64_t)src[si + 1] << 8);
    si += 2;
    if (offset == 0 || offset > di) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (si >= n) return -1;
        b = src[si++];
        mlen += b;
      } while (b == 255);
    }
    if (di + mlen > dst_size) return -1;
    if (offset >= mlen) {
      memcpy(dst + di, dst + di - offset, (size_t)mlen);
      di += mlen;
    } else {
      // overlapping match (RLE-style): byte-accurate copy
      for (int64_t k = 0; k < mlen; k++, di++) dst[di] = dst[di - offset];
    }
  }
  return di == dst_size ? di : -1;
}

}  // extern "C"
