// JPEG 2000 tier 1 (EBCOT block coding, ITU-T T.800 Annexes C and D): the
// MQ decoder and encoder and the three coding passes for code-blocks of
// style 0, one block at a time.  The decoder is the C++ twin of
// utils/j2k_t1.py's decode_blocks, which runs every block in lockstep in
// numpy; the encoder that of its encode_block, in plain Python.  The CPU
// tests hold each pair to each other and both to PIL (OpenJPEG).
//
// Decoded values come out as OpenJPEG's t1.c keeps them: twice the
// magnitude plus half the step of the last decoded bit-plane, signed.
// Encoding codes every pass of every bit-plane and ends the block with
// the MQ flush, as OpenJPEG's lossless single layer does.
//
// Compiled alone with g++ into build/native/libavrt_j2k_t1.so on first use
// (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct QeState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

// T.800 Table C.2
const QeState kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kRl = 17, kUni = 18;
constexpr uint8_t SIG = 1, PI = 2, REF = 4;
// neighbour bits: W, E, N, S, NW, NE, SW, SE
constexpr uint8_t W_ = 1, E_ = 2, N_ = 4, S_ = 8, NW_ = 16, NE_ = 32,
                  SW_ = 64, SE_ = 128;

uint8_t zc_lut[4][256];
uint8_t sc_lut[256];

void build_luts() {
  for (int nb = 0; nb < 256; ++nb) {
    int h = !!(nb & W_) + !!(nb & E_);
    int v = !!(nb & N_) + !!(nb & S_);
    int d = !!(nb & NW_) + !!(nb & NE_) + !!(nb & SW_) + !!(nb & SE_);
    for (int o = 0; o < 4; ++o) {
      int c;
      if (o == 3) {
        int hv = h + v;
        if (d >= 3) c = 8;
        else if (d == 2) c = hv >= 1 ? 7 : 6;
        else if (d == 1) c = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        else c = hv >= 2 ? 2 : hv;
      } else {
        int a = o == 1 ? v : h, b = o == 1 ? h : v;
        if (a == 2) c = 8;
        else if (a == 1) c = b >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (b == 2) c = 4;
        else if (b == 1) c = 3;
        else c = d >= 2 ? 2 : d;
      }
      zc_lut[o][nb] = uint8_t(c);
    }
  }
  for (int i = 0; i < 256; ++i) {
    int con[4];
    for (int k = 0; k < 4; ++k) {
      int s = (i >> k) & 1, n = (i >> (4 + k)) & 1;
      con[k] = !s ? 0 : (n ? -1 : 1);
    }
    int h = con[0] + con[1], v = con[2] + con[3];
    h = h > 1 ? 1 : h < -1 ? -1 : h;
    v = v > 1 ? 1 : v < -1 ? -1 : v;
    int x = 0;
    if (h < 0 || (h == 0 && v < 0)) { h = -h; v = -v; x = 1; }
    int ctx = h == 1 ? (v == 1 ? 13 : v == 0 ? 12 : 11) : (v == 1 ? 10 : 9);
    sc_lut[i] = uint8_t(ctx | (x << 7));
  }
}

struct Mq {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t st[19], mps[19];

  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(bp[0]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(bp[0]) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* p) {
    bp = p;
    c = uint32_t(bp[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[0] = 4;
    st[kRl] = 3;
    st[kUni] = 46;
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
  }

  int decode(int cx) {
    const QeState& s = kStates[st[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = uint8_t(d);
        st[cx] = s.nlps;
      }
      a = qe;
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = uint8_t(d);
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

struct Block {
  int h, w, pw;  // pw: padded row length
  std::vector<uint8_t> state, nbz, nbneg;
  std::vector<int32_t> val;
  std::vector<uint8_t> neg;
  Mq mq;
  int orient;

  void significant(int y, int x, int plane) {
    const int i = (y + 1) * pw + x + 1;
    const int sc = sc_lut[(nbz[i] & 15) | (nbneg[i] << 4)];
    const int n = mq.decode(sc & 127) ^ (sc >> 7);
    state[i] |= SIG;
    val[i] = 3 << plane;
    neg[i] = uint8_t(n);
    nbz[i - 1] |= E_;
    nbz[i + 1] |= W_;
    nbz[i - pw] |= S_;
    nbz[i + pw] |= N_;
    nbz[i - pw - 1] |= SE_;
    nbz[i - pw + 1] |= SW_;
    nbz[i + pw - 1] |= NE_;
    nbz[i + pw + 1] |= NW_;
    if (n) {
      nbneg[i - 1] |= E_;
      nbneg[i + 1] |= W_;
      nbneg[i - pw] |= S_;
      nbneg[i + pw] |= N_;
    }
  }

  void spp(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * pw + x + 1;
          if ((state[i] & SIG) || !nbz[i]) continue;
          state[i] |= PI;
          if (mq.decode(zc_lut[orient][nbz[i]])) significant(y, x, plane);
        }
  }

  void mrp(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * pw + x + 1;
          if ((state[i] & (SIG | PI)) != SIG) continue;
          const int cx = (state[i] & REF) ? 16 : nbz[i] ? 15 : 14;
          val[i] += (mq.decode(cx) ? 1 : -1) * (1 << plane);
          state[i] |= REF;
        }
  }

  void cup(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int start = 0;
        const int rows = h - y0 < 4 ? h - y0 : 4;
        if (rows == 4) {
          bool run = true;
          for (int r = 0; r < 4 && run; ++r) {
            const int i = (y0 + r + 1) * pw + x + 1;
            run = !(state[i] & (SIG | PI)) && !nbz[i];
          }
          if (run) {
            if (!mq.decode(kRl)) continue;
            int r = mq.decode(kUni) << 1;
            r |= mq.decode(kUni);
            significant(y0 + r, x, plane);
            start = r + 1;
          }
        }
        for (int r = start; r < rows; ++r) {
          const int y = y0 + r, i = (y + 1) * pw + x + 1;
          if (state[i] & (SIG | PI)) continue;
          if (mq.decode(zc_lut[orient][nbz[i]])) significant(y, x, plane);
        }
      }
    for (auto& s : state) s &= uint8_t(~PI);
  }
};


// The MQ encoder as OpenJPEG's mqc.c runs it (T.800 C.2): out[0] is a
// dummy 0 byte before the block's first, so that the first BYTEOUT may
// look at the byte before it.
struct MqEnc {
  std::vector<uint8_t> out;
  size_t bp;
  uint32_t a, c;
  int ct;
  uint8_t st[19], mps[19];

  void init() {
    out.assign(1, 0);
    bp = 0;
    a = 0x8000;
    c = 0;
    ct = 12;
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[0] = 4;
    st[kRl] = 3;
    st[kUni] = 46;
  }

  void put(uint8_t v) {
    ++bp;
    if (bp == out.size()) out.push_back(v);
    else out[bp] = v;
  }

  void byteout() {
    if (out[bp] == 0xFF) {
      put(uint8_t(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(uint8_t(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++out[bp];
      if (out[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        put(uint8_t(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        put(uint8_t(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }

  void renorme() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }

  void encode(int cx, int d) {
    const QeState& s = kStates[st[cx]];
    const uint32_t qe = s.qe;
    a -= qe;
    if (d == mps[cx]) {
      if ((a & 0x8000) == 0) {
        if (a < qe) a = qe;
        else c += qe;
        st[cx] = s.nmps;
        renorme();
      } else {
        c += qe;
      }
    } else {
      if (a < qe) c += qe;
      else a = qe;
      if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
      st[cx] = s.nlps;
      renorme();
    }
  }

  // FLUSH (Figure C.10); the block's length in bytes, a last 0xFF dropped
  size_t flush() {
    const uint32_t t = c + a;
    c |= 0xFFFF;
    if (c >= t) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (out[bp] != 0xFF) ++bp;
    return bp - 1;
  }
};

struct BlockEnc {
  int h, w, pw;
  std::vector<uint8_t> state, nbz, nbneg, neg;
  std::vector<uint32_t> mag;
  MqEnc mq;
  int orient;

  int bit(int i, int plane) const { return (mag[i] >> plane) & 1; }

  void significant(int y, int x) {
    const int i = (y + 1) * pw + x + 1;
    const int sc = sc_lut[(nbz[i] & 15) | (nbneg[i] << 4)];
    mq.encode(sc & 127, neg[i] ^ (sc >> 7));
    state[i] |= SIG;
    nbz[i - 1] |= E_;
    nbz[i + 1] |= W_;
    nbz[i - pw] |= S_;
    nbz[i + pw] |= N_;
    nbz[i - pw - 1] |= SE_;
    nbz[i - pw + 1] |= SW_;
    nbz[i + pw - 1] |= NE_;
    nbz[i + pw + 1] |= NW_;
    if (neg[i]) {
      nbneg[i - 1] |= E_;
      nbneg[i + 1] |= W_;
      nbneg[i - pw] |= S_;
      nbneg[i + pw] |= N_;
    }
  }

  void spp(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * pw + x + 1;
          if ((state[i] & SIG) || !nbz[i]) continue;
          state[i] |= PI;
          const int b = bit(i, plane);
          mq.encode(zc_lut[orient][nbz[i]], b);
          if (b) significant(y, x);
        }
  }

  void mrp(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * pw + x + 1;
          if ((state[i] & (SIG | PI)) != SIG) continue;
          const int cx = (state[i] & REF) ? 16 : nbz[i] ? 15 : 14;
          mq.encode(cx, bit(i, plane));
          state[i] |= REF;
        }
  }

  void cup(int plane) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int start = 0;
        const int rows = h - y0 < 4 ? h - y0 : 4;
        if (rows == 4) {
          bool run = true;
          for (int r = 0; r < 4 && run; ++r) {
            const int i = (y0 + r + 1) * pw + x + 1;
            run = !(state[i] & (SIG | PI)) && !nbz[i];
          }
          if (run) {
            int r = 0;
            while (r < 4 && !bit((y0 + r + 1) * pw + x + 1, plane)) ++r;
            if (r == 4) {
              mq.encode(kRl, 0);
              continue;
            }
            mq.encode(kRl, 1);
            mq.encode(kUni, r >> 1);
            mq.encode(kUni, r & 1);
            significant(y0 + r, x);
            start = r + 1;
          }
        }
        for (int r = start; r < rows; ++r) {
          const int y = y0 + r, i = (y + 1) * pw + x + 1;
          if (state[i] & (SIG | PI)) continue;
          const int b = bit(i, plane);
          mq.encode(zc_lut[orient][nbz[i]], b);
          if (b) significant(y, x);
        }
      }
    for (auto& s : state) s &= uint8_t(~PI);
  }
};

}  // namespace

extern "C" {

// Decode n code-blocks.  Block k's bytes start at buf + offs[k] and are
// followed by 0xFF 0xFF; it has npass[k] coding passes (already limited
// to 3 * nbps - 2), nbps[k] coded bit-planes, orientation orient[k]
// (0 LL, 1 HL, 2 LH, 3 HH) and size hs[k] x ws[k]; its values go to
// out + outoffs[k], row-major.
void avrt_j2k_decode_blocks(const uint8_t* buf, const int64_t* offs,
                            const int32_t* npass, const int32_t* nbps,
                            const int32_t* orient, const int32_t* hs,
                            const int32_t* ws, const int64_t* outoffs,
                            int64_t n, int32_t* out) {
  static const bool luts = (build_luts(), true);
  (void)luts;
  Block b;
  for (int64_t k = 0; k < n; ++k) {
    b.h = hs[k];
    b.w = ws[k];
    b.pw = b.w + 2;
    const size_t sz = size_t(b.h + 2) * b.pw;
    b.state.assign(sz, 0);
    b.nbz.assign(sz, 0);
    b.nbneg.assign(sz, 0);
    b.val.assign(sz, 0);
    b.neg.assign(sz, 0);
    b.orient = orient[k];
    b.mq.init(buf + offs[k]);
    const int top = nbps[k] - 1;
    for (int p = 0; p < npass[k]; ++p) {
      const int kind = p == 0 ? 2 : (p - 1) % 3;
      const int plane = top - (p == 0 ? 0 : 1 + (p - 1) / 3);
      if (kind == 0) b.spp(plane);
      else if (kind == 1) b.mrp(plane);
      else b.cup(plane);
    }
    int32_t* o = out + outoffs[k];
    for (int y = 0; y < b.h; ++y)
      for (int x = 0; x < b.w; ++x) {
        const int i = (y + 1) * b.pw + x + 1;
        o[y * b.w + x] = b.neg[i] ? -b.val[i] : b.val[i];
      }
  }
}

// Encode n code-blocks.  Block k's coefficients (signed, row-major,
// hs[k] x ws[k]) start at coef + offs[k]; orient[k] as for decoding.  Its
// number of coded bit-planes goes to nbps[k] (0 for a block of zeros,
// which codes nothing), its length to lens[k] and its bytes to out +
// out_offs[k], which has room for caps[k].  Returns -1 - k when block k
// does not fit, else 0.
int64_t avrt_j2k_encode_blocks(const int32_t* coef, const int64_t* offs,
                               const int32_t* hs, const int32_t* ws,
                               const int32_t* orient, int64_t n,
                               uint8_t* out, const int64_t* out_offs,
                               const int64_t* caps, int32_t* nbps,
                               int64_t* lens) {
  static const bool luts = (build_luts(), true);
  (void)luts;
  BlockEnc b;
  for (int64_t k = 0; k < n; ++k) {
    b.h = hs[k];
    b.w = ws[k];
    b.pw = b.w + 2;
    const size_t sz = size_t(b.h + 2) * b.pw;
    b.state.assign(sz, 0);
    b.nbz.assign(sz, 0);
    b.nbneg.assign(sz, 0);
    b.neg.assign(sz, 0);
    b.mag.assign(sz, 0);
    b.orient = orient[k];
    uint32_t top = 0;
    const int32_t* src = coef + offs[k];
    for (int y = 0; y < b.h; ++y)
      for (int x = 0; x < b.w; ++x) {
        const int32_t v = src[y * b.w + x];
        const int i = (y + 1) * b.pw + x + 1;
        b.mag[i] = uint32_t(v < 0 ? -int64_t(v) : v);
        b.neg[i] = v < 0;
        top |= b.mag[i];
      }
    int planes = 0;
    while (top >> planes) ++planes;
    nbps[k] = planes;
    lens[k] = 0;
    if (!planes) continue;
    b.mq.init();
    for (int p = 0; p < 3 * planes - 2; ++p) {
      const int kind = p == 0 ? 2 : (p - 1) % 3;
      const int plane = planes - 1 - (p == 0 ? 0 : 1 + (p - 1) / 3);
      if (kind == 0) b.spp(plane);
      else if (kind == 1) b.mrp(plane);
      else b.cup(plane);
    }
    const size_t len = b.mq.flush();
    if (int64_t(len) > caps[k]) return -1 - k;
    std::memcpy(out + out_offs[k], b.mq.out.data() + 1, len);
    lens[k] = int64_t(len);
  }
  return 0;
}

}  // extern "C"
