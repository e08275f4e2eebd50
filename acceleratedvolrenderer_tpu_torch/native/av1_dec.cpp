// AV1 intra-frame decoder for AVIF still images (utils/avif.py), following
// the AV1 bitstream specification (sections 5.11 and 7): the symbol
// decoder with CDF adaptation, the partition tree, every intra
// prediction mode (DC, directional with the edge filter and upsampling,
// SMOOTH*, PAETH, filter intra, CfL), the screen content tools (palette
// prediction and intra block copy, with its motion vector stack, the
// inter transform sets and the transform tree), the coefficient syntax,
// the inverse transforms (DCT 4-64, ADST and FLIPADST 4-16, identity,
// Walsh-Hadamard), quantizer matrices and block-level delta q, the
// deblocking filter, CDEF, loop restoration (Wiener, self-guided) and
// film grain synthesis (as dav1d applies it), for 4:2:0, 4:2:2, 4:4:4
// and 4:0:0.  utils/avif.py parses the OBUs and the frame header and
// refuses the tools this decoder does not implement (segmentation,
// block-level delta lf, superres, more than 8 bits).
//
// Entry point: avrt_av1_decode(data, size, params, col_starts,
// row_starts, tiles, ntiles, y, u, v, stats, err, errlen) -> 0 or -1 with
// a message in err.  params: see the P_* indices below; stats: see S_*.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

// ---------------------------------------------------------------- constants
enum {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
  BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
  BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
  BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_SIZES
};
const int BW[BLOCK_SIZES] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32,
                             64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
const int BH[BLOCK_SIZES] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64,
                             32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

enum {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
  TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
  TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL
};
const int TXW[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                               32, 32, 64, 4, 16, 8, 32, 16, 64};
const int TXH[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                               16, 64, 32, 16, 4, 32, 8, 64, 16};
const int SPLIT_TX[TX_SIZES_ALL] = {
    TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
    TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
const int ROW_SHIFT[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                     1, 1, 1, 1, 1, 2, 2, 2, 2};

enum {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
  D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
  PAETH_PRED, UV_CFL_PRED
};
const int MODE_TO_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                               0, 0, 0, 0};
const int INTRA_MODE_CTX[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int FILTER_INTRA_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                 DC_PRED};

enum {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
  FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
  V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
const int SET1_INV[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT,
                         DCT_ADST};
const int SET2_INV[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int MODE_TO_TXFM[14] = {
    DCT_DCT,   ADST_DCT,  DCT_ADST,  DCT_DCT,   ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST,  ADST_DCT,  ADST_ADST, ADST_DCT,  DCT_ADST,  ADST_ADST, DCT_DCT};

// inter sets: 1 all 16 types, 2 the 12 without 1-D ADSTs, 3 DCT and IDTX
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2, TX_SET_INTER_3 = 3 };
const int INTER_SET1_INV[16] = {
    IDTX,         V_DCT,         H_DCT,         V_ADST,
    H_ADST,       V_FLIPADST,    H_FLIPADST,    DCT_DCT,
    ADST_DCT,     DCT_ADST,      FLIPADST_DCT,  DCT_FLIPADST,
    ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int INTER_SET2_INV[12] = {
    IDTX,     V_DCT,        H_DCT,        DCT_DCT,
    ADST_DCT, DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
    ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int INTER_SET3_INV[2] = {IDTX, DCT_DCT};
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

// params
enum {
  P_W, P_H, P_SSX, P_SSY, P_MONO, P_USE128, P_FILTER_INTRA, P_EDGE_FILTER,
  P_DISABLE_CDF_UPDATE, P_BASE_Q, P_DQ, P_LOSSLESS = P_DQ + 5, P_LF,
  P_LF_SHARPNESS = P_LF + 4, P_LF_DELTA_ENABLED, P_LF_INTRA_DELTA,
  P_LR_TYPE, P_LR_SIZE = P_LR_TYPE + 3, P_TX_MODE = P_LR_SIZE + 3,
  P_REDUCED_TX_SET, P_TILE_COLS, P_TILE_ROWS,
  P_CDEF, P_CDEF_DAMPING, P_CDEF_BITS, P_CDEF_Y_PRI, P_CDEF_Y_SEC = P_CDEF_Y_PRI + 8,
  P_CDEF_UV_PRI = P_CDEF_Y_SEC + 8, P_CDEF_UV_SEC = P_CDEF_UV_PRI + 8,
  P_QM_LEVEL = P_CDEF_UV_SEC + 8, P_DELTA_Q_PRESENT = P_QM_LEVEL + 3,
  P_DELTA_Q_RES, P_SCREEN, P_INTRABC, P_MC_IDENTITY,
  // film_grain_params (native/__init__.py's _grain_params)
  P_FG_APPLY, P_FG_SEED, P_FG_NUM_Y, P_FG_Y, P_FG_FROM_LUMA = P_FG_Y + 28,
  P_FG_NUM_CB, P_FG_CB, P_FG_NUM_CR = P_FG_CB + 20, P_FG_CR,
  P_FG_SCALING_SHIFT = P_FG_CR + 20, P_FG_LAG, P_FG_AR_Y,
  P_FG_AR_CB = P_FG_AR_Y + 24, P_FG_AR_CR = P_FG_AR_CB + 25,
  P_FG_AR_SHIFT = P_FG_AR_CR + 25, P_FG_GRAIN_SCALE_SHIFT, P_FG_CB_MULT,
  P_FG_CB_LUMA_MULT, P_FG_CB_OFFSET, P_FG_CR_MULT, P_FG_CR_LUMA_MULT,
  P_FG_CR_OFFSET, P_FG_OVERLAP, P_FG_CLIP, P_COUNT
};
// stats: blocks whose delta_qindex was not 0, 64x64 blocks with a
// cdef_idx, blocks with a palette (in any plane, in chroma), intra block
// copy blocks
enum { S_DELTA_Q_BLOCKS, S_CDEF_BLOCKS, S_PALETTE_BLOCKS, S_INTRABC_BLOCKS,
       S_PALETTE_UV_BLOCKS, S_COUNT };

int block_of(int w, int h) {
  for (int i = 0; i < BLOCK_SIZES; i++)
    if (BW[i] == w && BH[i] == h) return i;
  return -1;
}
int tx_of(int w, int h) {
  for (int i = 0; i < TX_SIZES_ALL; i++)
    if (TXW[i] == w && TXH[i] == h) return i;
  return -1;
}
int log2i(int v) {
  int n = 0;
  while ((1 << (n + 1)) <= v) n++;
  return n;
}
int tx_sqr(int t) { int m = std::min(TXW[t], TXH[t]); return tx_of(m, m); }
int tx_sqr_up(int t) { int m = std::max(TXW[t], TXH[t]); return tx_of(m, m); }
int max_tx_rect(int b) { return tx_of(std::min(BW[b], 64), std::min(BH[b], 64)); }
int max_tx_depth(int b) {
  int t = max_tx_rect(b), d = 0;
  while (t != TX_4X4) { t = SPLIT_TX[t]; d++; }
  return d;
}
int adjusted_tx(int t) { return tx_of(std::min(TXW[t], 32), std::min(TXH[t], 32)); }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int round2(int64_t x, int n) {
  if (n == 0) return (int)x;
  return (int)((x + ((int64_t)1 << (n - 1))) >> n);
}
inline int round2signed(int x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}
inline uint8_t clip1(int v) { return (uint8_t)clip3(0, 255, v); }
bool is_directional(int m) { return m >= V_PRED && m <= D67_PRED; }

// ---------------------------------------------------------------- CDFs
struct Cdfs {
  uint16_t kf_y_mode[5][5][14];
  uint16_t uv_nocfl[13][14];
  uint16_t uv_cfl[13][15];
  uint16_t angle_delta[8][8];
  uint16_t partition[20][11];
  uint16_t skip[3][3];
  uint16_t tx_size[4][3][4];
  uint16_t set1[2][13][8];
  uint16_t set2[3][13][6];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t use_fi[22][3];
  uint16_t fi_mode[6];
  uint16_t restore_sw[4];
  uint16_t restore_w[3];
  uint16_t restore_s[3];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6];
  uint16_t eob32[2][2][7];
  uint16_t eob64[2][2][8];
  uint16_t eob128[2][2][9];
  uint16_t eob256[2][2][10];
  uint16_t eob512[2][2][11];
  uint16_t eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
  uint16_t delta_q[5];
  uint16_t palette_y_mode[7][3][3];
  uint16_t palette_uv_mode[2][3];
  uint16_t palette_y_size[7][8];
  uint16_t palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9];
  uint16_t palette_uv_color[7][5][9];
  uint16_t intrabc[3];
  uint16_t txfm_split[21][3];
  uint16_t inter_set1[4][17];
  uint16_t inter_set2[4][13];
  uint16_t inter_set3[4][3];
  // the motion vector context of intra block copy (MV_INTRABC_CONTEXT)
  uint16_t mv_joint[5];
  uint16_t mv_class[2][12];
  uint16_t mv_sign[2][3];
  uint16_t mv_class0_bit[2][3];
  uint16_t mv_bit[2][10][3];

  void init(int base_q) {
    int q = base_q <= 20 ? 0 : base_q <= 60 ? 1 : base_q <= 120 ? 2 : 3;
#define CP(dst, src) std::memcpy(dst, src, sizeof(dst))
    CP(kf_y_mode, AV1_KF_Y_MODE);
    CP(uv_nocfl, AV1_UV_MODE_NOCFL);
    CP(uv_cfl, AV1_UV_MODE_CFL);
    CP(angle_delta, AV1_ANGLE_DELTA);
    CP(partition, AV1_PARTITION);
    CP(skip, AV1_SKIP);
    CP(tx_size, AV1_TX_SIZE);
    CP(set1, AV1_INTRA_TX_SET1);
    CP(set2, AV1_INTRA_TX_SET2);
    CP(cfl_sign, AV1_CFL_SIGN);
    CP(cfl_alpha, AV1_CFL_ALPHA);
    CP(use_fi, AV1_USE_FILTER_INTRA);
    CP(fi_mode, AV1_FILTER_INTRA_MODE);
    CP(restore_sw, AV1_RESTORE_SWITCHABLE);
    CP(restore_w, AV1_RESTORE_WIENER);
    CP(restore_s, AV1_RESTORE_SGRPROJ);
    CP(txb_skip, AV1_TXB_SKIP[q]);
    CP(eob_extra, AV1_EOB_EXTRA[q]);
    CP(dc_sign, AV1_DC_SIGN[q]);
    CP(eob16, AV1_EOB_PT_16[q]);
    CP(eob32, AV1_EOB_PT_32[q]);
    CP(eob64, AV1_EOB_PT_64[q]);
    CP(eob128, AV1_EOB_PT_128[q]);
    CP(eob256, AV1_EOB_PT_256[q]);
    CP(eob512, AV1_EOB_PT_512[q]);
    CP(eob1024, AV1_EOB_PT_1024[q]);
    CP(base_eob, AV1_COEFF_BASE_EOB[q]);
    CP(base, AV1_COEFF_BASE[q]);
    CP(br, AV1_COEFF_BR[q]);
    CP(delta_q, AV1_DELTA_Q);
    CP(palette_y_mode, AV1_PALETTE_Y_MODE);
    CP(palette_uv_mode, AV1_PALETTE_UV_MODE);
    CP(palette_y_size, AV1_PALETTE_Y_SIZE);
    CP(palette_uv_size, AV1_PALETTE_UV_SIZE);
    CP(palette_y_color, AV1_PALETTE_Y_COLOR);
    CP(palette_uv_color, AV1_PALETTE_UV_COLOR);
    CP(intrabc, AV1_INTRABC);
    CP(txfm_split, AV1_TXFM_SPLIT);
    CP(inter_set1, AV1_INTER_TX_SET1);
    CP(inter_set2, AV1_INTER_TX_SET2);
    CP(inter_set3, AV1_INTER_TX_SET3);
    CP(mv_joint, AV1_MV_JOINT);
    CP(mv_class, AV1_MV_CLASS);
    CP(mv_sign, AV1_MV_SIGN);
    CP(mv_class0_bit, AV1_MV_CLASS0_BIT);
    CP(mv_bit, AV1_MV_BIT);
#undef CP
  }
};

// ---------------------------------------------------------------- symbols
struct SymbolDecoder {
  const uint8_t *buf = nullptr;
  int64_t bitpos = 0, bitend = 0;
  int value = 0, range = 0, maxbits = 0;
  bool adapt = true;

  int bit() {
    if (bitpos >= bitend) { bitpos++; return 0; }
    int b = (buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
    bitpos++;
    return b;
  }
  int bits(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }
  void init(const uint8_t *data, int64_t size, bool adapt_) {
    buf = data;
    bitpos = 0;
    bitend = size * 8;
    adapt = adapt_;
    int numbits = (int)std::min<int64_t>(size * 8, 15);
    int b = bits(numbits);
    int padded = b << (15 - numbits);
    value = ((1 << 15) - 1) ^ padded;
    range = 1 << 15;
    maxbits = (int)(8 * size - 15);
  }
  // icdf: n - 1 inverted probabilities, 0, the counter
  int read(uint16_t *icdf, int n, bool update = true) {
    int cur = range, prev, symbol = -1;
    do {
      symbol++;
      prev = cur;
      cur = (((range >> 8) * (icdf[symbol] >> 6)) >> 1) + 4 * (n - symbol - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int b = 15 - log2i(range);
    range <<= b;
    int numbits = std::min(b, std::max(0, maxbits));
    int nd = bits(numbits);
    int padded = nd << (b - numbits);
    value = padded ^ (((value + 1) << b) - 1);
    maxbits -= b;
    if (update && adapt) {
      int rate = 3 + (icdf[n] > 15) + (icdf[n] > 31) + std::min(log2i(n), 2);
      int tmp = 32768;
      for (int i = 0; i < n - 1; i++) {
        if (i == symbol) tmp = 0;
        if (tmp < icdf[i])
          icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
        else
          icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
      }
      icdf[n] += (icdf[n] < 32);
    }
    return symbol;
  }
  int boolean() {
    uint16_t c[3] = {16384, 0, 0};
    return read(c, 2, false);
  }
  int literal(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | boolean();
    return v;
  }
  // NS(n): a value below n in as few literal bits as it needs
  int ns(int n) {
    int w = log2i(n) + 1, m = (1 << w) - n;
    int v = literal(w - 1);
    return v < m ? v : (v << 1) - m + literal(1);
  }
};

// ---------------------------------------------------------------- planes
struct Plane {
  int w = 0, h = 0, stride = 0, rows = 0;
  std::vector<uint8_t> px;
  void alloc(int w_, int h_, int aw, int ah) {
    w = w_;
    h = h_;
    stride = aw;
    rows = ah;
    px.assign((size_t)aw * ah, 0);
  }
  uint8_t &at(int y, int x) { return px[(size_t)y * stride + x]; }
};

// ---------------------------------------------------------------- transforms
int cos128(int angle) {
  int a = angle & 255;
  if (a <= 64) return AV1_COS128[a];
  if (a <= 128) return -AV1_COS128[128 - a];
  if (a <= 192) return -AV1_COS128[a - 128];
  return AV1_COS128[256 - a];
}
inline int sin128(int angle) { return cos128(angle - 64); }
int brev(int n, int x) {
  int r = 0;
  for (int i = 0; i < n; i++) if (x & (1 << i)) r |= 1 << (n - 1 - i);
  return r;
}

// B(a, b, angle, 1) in the specification: rotate then exchange the outputs.
inline void Bf(int32_t *T, int a, int b, int angle, int flip) {
  int64_t x = T[a], y = T[b];
  int64_t c = cos128(angle), s = sin128(angle);
  int32_t u = round2(x * c - y * s, 12), v = round2(x * s + y * c, 12);
  if (flip) { T[a] = v; T[b] = u; } else { T[a] = u; T[b] = v; }
}
inline void Hf(int32_t *T, int a, int b, int flip) {
  if (flip) std::swap(a, b);
  int32_t x = T[a], y = T[b];
  T[a] = x + y;
  T[b] = x - y;
}

void inverse_dct(int32_t *T, int n) {
  int n0 = 1 << n;
  int32_t copy[64];
  std::memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++) T[i] = copy[brev(n, i)];
  if (n == 6)
    for (int i = 0; i < 16; i++) Bf(T, 32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) Bf(T, 16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
  if (n == 6)
    for (int i = 0; i < 16; i++) Hf(T, 32 + i * 2, 33 + i * 2, i & 1);
  if (n >= 4)
    for (int i = 0; i < 4; i++) Bf(T, 8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) Hf(T, 16 + 2 * i, 17 + 2 * i, i & 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++)
        Bf(T, 62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
  if (n >= 3)
    for (int i = 0; i < 2; i++) Bf(T, 4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4)
    for (int i = 0; i < 4; i++) Hf(T, 8 + 2 * i, 9 + 2 * i, i & 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        Bf(T, 30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
  if (n == 6)
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 2; j++) Hf(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1);
  for (int i = 0; i < 2; i++) Bf(T, 2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
  if (n >= 3)
    for (int i = 0; i < 2; i++) Hf(T, 4 + 2 * i, 5 + 2 * i, i);
  if (n >= 4)
    for (int i = 0; i < 2; i++) Bf(T, 14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) Hf(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1);
  if (n == 6)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++)
        Bf(T, 61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
  for (int i = 0; i < 2; i++) Hf(T, i, 3 - i, 0);
  if (n >= 3) Bf(T, 6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) Hf(T, 8 + 4 * i + j, 11 + 4 * i - j, i);
  if (n >= 5)
    for (int i = 0; i < 4; i++) Bf(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) Hf(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1);
  if (n >= 3)
    for (int i = 0; i < 4; i++) Hf(T, i, 7 - i, 0);
  if (n >= 4)
    for (int i = 0; i < 2; i++) Bf(T, 13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) Hf(T, 16 + i * 8 + j, 23 + i * 8 - j, i);
  if (n == 6)
    for (int i = 0; i < 8; i++) Bf(T, 59 - i, 36 + i, i < 4 ? 48 : 112, 1);
  if (n >= 4)
    for (int i = 0; i < 8; i++) Hf(T, i, 15 - i, 0);
  if (n >= 5)
    for (int i = 0; i < 4; i++) Bf(T, 27 - i, 20 + i, 32, 1);
  if (n == 6) {
    for (int i = 0; i < 8; i++) Hf(T, 32 + i, 47 - i, 0);
    for (int i = 0; i < 8; i++) Hf(T, 48 + i, 63 - i, 1);
  }
  if (n >= 5)
    for (int i = 0; i < 16; i++) Hf(T, i, 31 - i, 0);
  if (n == 6)
    for (int i = 0; i < 8; i++) Bf(T, 55 - i, 40 + i, 32, 1);
  if (n == 6)
    for (int i = 0; i < 32; i++) Hf(T, i, 63 - i, 0);
}

void inverse_adst4(int32_t *T) {
  const int64_t S1 = 1321, S2 = 2482, S3 = 3344, S4 = 3803;
  int64_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
  int64_t s0 = S1 * x0, s1 = S2 * x0, s2 = S3 * x1, s3 = S4 * x2;
  int64_t s4 = S1 * x2, s5 = S2 * x3, s6 = S4 * x3;
  int64_t b7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = S3 * b7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t o0 = s0 + s3, o1 = s1 + s3, o2 = s2, o3 = s0 + s1 - s3;
  T[0] = round2(o0, 12);
  T[1] = round2(o1, 12);
  T[2] = round2(o2, 12);
  T[3] = round2(o3, 12);
}

void adst_in_perm(int32_t *T, int n) {
  int n0 = 1 << n;
  int32_t copy[16];
  std::memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++) T[i] = copy[(i & 1) ? (i - 1) : (n0 - i - 1)];
}
void adst_out_perm(int32_t *T, int n) {
  static const int P8[8] = {0, 4, 6, 2, 3, 7, 5, 1};
  static const int P16[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  int n0 = 1 << n;
  const int *p = n == 3 ? P8 : P16;
  int32_t copy[16];
  std::memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++) T[i] = (i & 1) ? -copy[p[i]] : copy[p[i]];
}
void inverse_adst8(int32_t *T) {
  adst_in_perm(T, 3);
  for (int i = 0; i < 4; i++) Bf(T, 2 * i, 1 + 2 * i, 60 - 16 * i, 1);
  for (int i = 0; i < 4; i++) Hf(T, i, 4 + i, 0);
  for (int i = 0; i < 2; i++) Bf(T, 4 + 3 * i, 5 + i, 48 - 32 * i, 1);
  for (int i = 0; i < 2; i++) {
    Hf(T, i, 2 + i, 0);
    Hf(T, 4 + i, 6 + i, 0);
  }
  for (int i = 0; i < 2; i++) Bf(T, 2 + 4 * i, 3 + 4 * i, 32, 1);
  adst_out_perm(T, 3);
}
void inverse_adst16(int32_t *T) {
  adst_in_perm(T, 4);
  for (int i = 0; i < 8; i++) Bf(T, 2 * i, 1 + 2 * i, 62 - 8 * i, 1);
  for (int i = 0; i < 8; i++) Hf(T, i, 8 + i, 0);
  for (int i = 0; i < 2; i++) {
    Bf(T, 8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
    Bf(T, 13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
  }
  for (int i = 0; i < 4; i++) {
    Hf(T, i, 4 + i, 0);
    Hf(T, 8 + i, 12 + i, 0);
  }
  for (int i = 0; i < 2; i++) {
    Bf(T, 4 + 8 * i, 5 + 8 * i, 48, 1);
    Bf(T, 7 + 8 * i, 6 + 8 * i, 16, 1);
  }
  for (int i = 0; i < 2; i++) {
    Hf(T, i, 2 + i, 0);
    Hf(T, 4 + i, 6 + i, 0);
    Hf(T, 8 + i, 10 + i, 0);
    Hf(T, 12 + i, 14 + i, 0);
  }
  for (int i = 0; i < 4; i++) Bf(T, 2 + 4 * i, 3 + 4 * i, 32, 1);
  adst_out_perm(T, 4);
}
void inverse_identity(int32_t *T, int n) {
  int n0 = 1 << n;
  for (int i = 0; i < n0; i++) {
    if (n == 2) T[i] = round2((int64_t)T[i] * 5793, 12);
    else if (n == 3) T[i] = T[i] * 2;
    else if (n == 4) T[i] = round2((int64_t)T[i] * 11586, 12);
    else T[i] = T[i] * 4;
  }
}
void inverse_wht(int32_t *T, int shift) {
  int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift,
          b = T[3] >> shift;
  a += c;
  d -= b;
  int32_t e = (a - d) >> 1;
  b = e - b;
  c = e - c;
  a -= b;
  d += c;
  T[0] = a;
  T[1] = b;
  T[2] = c;
  T[3] = d;
}

// kind: 0 DCT, 1 ADST, 2 identity
void inverse_1d(int32_t *T, int n, int kind) {
  if (kind == 0) inverse_dct(T, n);
  else if (kind == 1) {
    if (n == 2) inverse_adst4(T);
    else if (n == 3) inverse_adst8(T);
    else inverse_adst16(T);
  } else inverse_identity(T, n);
}
int row_kind(int t) {      // the horizontal (row) transform
  switch (t) {
    case DCT_DCT: case ADST_DCT: case FLIPADST_DCT: case H_DCT: return 0;
    case DCT_ADST: case ADST_ADST: case DCT_FLIPADST: case FLIPADST_FLIPADST:
    case ADST_FLIPADST: case FLIPADST_ADST: case H_ADST: case H_FLIPADST:
      return 1;
    default: return 2;
  }
}
int col_kind(int t) {      // the vertical (column) transform
  switch (t) {
    case DCT_DCT: case DCT_ADST: case DCT_FLIPADST: case V_DCT: return 0;
    case ADST_DCT: case ADST_ADST: case FLIPADST_DCT: case FLIPADST_FLIPADST:
    case ADST_FLIPADST: case FLIPADST_ADST: case V_ADST: case V_FLIPADST:
      return 1;
    default: return 2;
  }
}
int tx_class(int t) {
  if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
  if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}

// ---------------------------------------------------------------- scans
const int16_t *default_scan(int t) {
  switch (adjusted_tx(t)) {
    case TX_4X4: return AV1_SCAN_4X4;
    case TX_8X8: return AV1_SCAN_8X8;
    case TX_16X16: return AV1_SCAN_16X16;
    case TX_32X32: return AV1_SCAN_32X32;
    case TX_4X8: return AV1_SCAN_4X8;
    case TX_8X4: return AV1_SCAN_8X4;
    case TX_8X16: return AV1_SCAN_8X16;
    case TX_16X8: return AV1_SCAN_16X8;
    case TX_16X32: return AV1_SCAN_16X32;
    case TX_32X16: return AV1_SCAN_32X16;
    case TX_4X16: return AV1_SCAN_4X16;
    case TX_16X4: return AV1_SCAN_16X4;
    case TX_8X32: return AV1_SCAN_8X32;
    case TX_32X8: return AV1_SCAN_32X8;
  }
  return AV1_SCAN_4X4;
}

// ---------------------------------------------------------------- decoder
struct Decoder {
  int p[P_COUNT];
  int W, H, ssx, ssy, planes, mi_cols, mi_rows, use128, sb4;
  int base_q, lossless, tx_mode, reduced_tx_set;
  std::vector<int> col_starts, row_starts;
  Plane frame[3];
  // per 4x4 luma position
  std::vector<uint8_t> mi_size, y_mode, uv_mode, skips;
  std::vector<uint8_t> lf_tx[3];     // per 4x4 of each plane
  int lf_stride[3];
  // tile state
  Cdfs cdf;
  SymbolDecoder sd;
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t block_decoded[3][34][34];   // index +1
  // block state
  int mi_row, mi_col, mi_sz, has_chroma, avail_u, avail_l, avail_u_chroma,
      avail_l_chroma, skip, ymode, uvmode, angle_y, angle_uv, use_fi, fi_mode,
      cfl_u, cfl_v, tx_size, max_luma_w, max_luma_h;
  int tx_type_cur, plane_tx_type;
  int32_t quant[1024];
  // screen content tools: per 4x4 luma position, whether the block is
  // an intra block copy (an inter block), its DV (row, column in eighth
  // samples), its InterTxSizes, the luma transform types, whether it
  // has been decoded, and the palette sizes and colours (Y, U) the
  // palette cache of later blocks reads
  int screen, allow_intrabc;
  std::vector<uint8_t> is_inter, inter_tx, tx_types, written;
  std::vector<int32_t> mvs;
  std::vector<uint8_t> pal_size[2], pal_colors[2];
  // block: intra block copy and its DV, the palettes and colour maps
  int use_intrabc, mv[2], pal_y, pal_uv;
  uint8_t pal_colors_y[8], pal_colors_u[8], pal_colors_v[8];
  uint8_t color_map_y[64][64], color_map_uv[64][64];
  // block-level delta q: the tile's CurrentQIndex, and whether this
  // superblock may still read a delta
  int cur_q, read_deltas;
  int stats[S_COUNT];
  // quantizer matrices: each plane's level (15: flat) and the offset of
  // each coded size's weights in AV1_QUANTIZER_MATRIX
  int qm_level[3], qm_offset[TX_SIZES_ALL];
  // CDEF: cdef_idx of each 64x64 (-1: not read), the deblocked planes
  std::vector<int8_t> cdef_idx;
  int cdef_stride;
  std::vector<uint8_t> deblocked[3];
  // restoration
  int lr_type[3], lr_size[3];
  std::vector<uint8_t> lr_unit_type[3];
  std::vector<int8_t> lr_wiener[3];   // per unit: 2 passes x 3
  std::vector<int8_t> lr_sgr_set[3];
  std::vector<int16_t> lr_sgr_xqd[3]; // per unit: 2
  int lr_units_cols[3], lr_units_rows[3];
  int ref_wiener[3][2][3], ref_sgr[3][2];

  int mi_idx(int r, int c) const { return r * mi_cols + c; }
  bool is_inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start &&
           r < mi_row_end;
  }
  int plane_res_size(int b, int plane) const {
    if (plane == 0) return b;
    int w = std::max(4, BW[b] >> ssx), h = std::max(4, BH[b] >> ssy);
    return block_of(w, h);
  }
  int get_tx_size(int plane, int t) const {
    if (plane == 0) return t;
    int uv = max_tx_rect(plane_res_size(mi_sz, plane));
    if (TXW[uv] == 64 || TXH[uv] == 64) {
      if (TXW[uv] == 16) return TX_16X32;
      if (TXH[uv] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  // ------------------------------------------------------------ setup
  void setup(const int32_t *params, const int32_t *cs, const int32_t *rs) {
    std::memcpy(p, params, sizeof(p));
    W = p[P_W];
    H = p[P_H];
    ssx = p[P_SSX];
    ssy = p[P_SSY];
    planes = p[P_MONO] ? 1 : 3;
    mi_cols = 2 * ((W + 7) >> 3);
    mi_rows = 2 * ((H + 7) >> 3);
    use128 = p[P_USE128];
    sb4 = use128 ? 32 : 16;
    base_q = p[P_BASE_Q];
    lossless = p[P_LOSSLESS];
    tx_mode = p[P_TX_MODE];
    reduced_tx_set = p[P_REDUCED_TX_SET];
    col_starts.assign(cs, cs + p[P_TILE_COLS] + 1);
    row_starts.assign(rs, rs + p[P_TILE_ROWS] + 1);
    int sbw = ((mi_cols + sb4 - 1) / sb4) * sb4 * 4 + 160;
    int sbh = ((mi_rows + sb4 - 1) / sb4) * sb4 * 4 + 160;
    for (int pl = 0; pl < planes; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      frame[pl].alloc((W + sx) >> sx, (H + sy) >> sy, sbw >> sx, sbh >> sy);
      lf_stride[pl] = (sbw >> sx) / 4;
      lf_tx[pl].assign((size_t)lf_stride[pl] * ((sbh >> sy) / 4), 0);
      above_level[pl].assign(lf_stride[pl] + 64, 0);
      above_dc[pl].assign(lf_stride[pl] + 64, 0);
      left_level[pl].assign((sbh >> sy) / 4 + 64, 0);
      left_dc[pl].assign((sbh >> sy) / 4 + 64, 0);
    }
    size_t n = (size_t)mi_rows * mi_cols;
    cdef_stride = (mi_cols + 15) >> 4;
    cdef_idx.assign((size_t)cdef_stride * ((mi_rows + 15) >> 4), -1);
    for (int pl = 0; pl < 3; pl++)
      qm_level[pl] = lossless ? 15 : p[P_QM_LEVEL + pl];
    for (int t = 0, off = 0; t < TX_SIZES_ALL; t++) {
      qm_offset[t] = off;
      if (adjusted_tx(t) == t) off += TXW[t] * TXH[t];
    }
    std::memset(stats, 0, sizeof(stats));
    screen = p[P_SCREEN];
    allow_intrabc = p[P_INTRABC];
    is_inter.assign(n, 0);
    inter_tx.assign(n, 0);
    tx_types.assign(n, 0);
    written.assign(n, 0);
    mvs.assign(2 * n, 0);
    for (int k = 0; k < 2; k++) {
      pal_size[k].assign(n, 0);
      pal_colors[k].assign(8 * n, 0);
    }
    mi_size.assign(n, 0);
    y_mode.assign(n, 0);
    uv_mode.assign(n, 0);
    skips.assign(n, 0);
    for (int pl = 0; pl < 3; pl++) {
      lr_type[pl] = pl < planes ? p[P_LR_TYPE + pl] : RESTORE_NONE;
      lr_size[pl] = p[P_LR_SIZE + pl];
      if (lr_type[pl] == RESTORE_NONE) continue;
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int uw = round2(W, sx), uh = round2(H, sy);
      lr_units_cols[pl] = std::max((uw + (lr_size[pl] >> 1)) / lr_size[pl], 1);
      lr_units_rows[pl] = std::max((uh + (lr_size[pl] >> 1)) / lr_size[pl], 1);
      size_t nu = (size_t)lr_units_cols[pl] * lr_units_rows[pl];
      lr_unit_type[pl].assign(nu, RESTORE_NONE);
      lr_wiener[pl].assign(nu * 6, 0);
      lr_sgr_set[pl].assign(nu, 0);
      lr_sgr_xqd[pl].assign(nu * 2, 0);
    }
  }

  // ------------------------------------------------------------ tiles
  void decode_tile(const uint8_t *data, int64_t size, int tile) {
    int tc = p[P_TILE_COLS];
    int trow = tile / tc, tcol = tile % tc;
    mi_row_start = row_starts[trow];
    mi_row_end = row_starts[trow + 1];
    mi_col_start = col_starts[tcol];
    mi_col_end = col_starts[tcol + 1];
    cdf.init(base_q);
    sd.init(data, size, !p[P_DISABLE_CDF_UPDATE]);
    cur_q = base_q;
    for (int pl = 0; pl < planes; pl++) {
      std::fill(above_level[pl].begin(), above_level[pl].end(), 0);
      std::fill(above_dc[pl].begin(), above_dc[pl].end(), 0);
      ref_sgr[pl][0] = -32;
      ref_sgr[pl][1] = 31;
      for (int pass = 0; pass < 2; pass++) {
        ref_wiener[pl][pass][0] = 3;
        ref_wiener[pl][pass][1] = -7;
        ref_wiener[pl][pass][2] = 15;
      }
    }
    int sb_size = use128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int pl = 0; pl < planes; pl++) {
        std::fill(left_level[pl].begin(), left_level[pl].end(), 0);
        std::fill(left_dc[pl].begin(), left_dc[pl].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = p[P_DELTA_Q_PRESENT];
        for (int y = r; y < r + sb4 && y < mi_rows; y += 16)
          for (int x = c; x < c + sb4 && x < mi_cols; x += 16)
            cdef_idx[(size_t)(y >> 4) * cdef_stride + (x >> 4)] = -1;
        clear_block_decoded(r, c);
        read_lr(r, c, sb_size);
        decode_partition(r, c, sb_size);
      }
    }
  }

  void clear_block_decoded(int r, int c) {
    for (int pl = 0; pl < planes; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[pl][y + 1][x + 1] = v;
        }
      block_decoded[pl][(sb4 >> sy) + 1][0] = 0;
    }
  }

  // ------------------------------------------------------------ partition
  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int avU = is_inside(r - 1, c), avL = is_inside(r, c - 1);
    int num4 = BW[bsize] >> 2, half = num4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = 0;
    } else {
      int bsl = log2i(num4);   // 8x8: 1
      int above = avU && (log2i(BW[mi_size[mi_idx(r - 1, c)]] >> 2) < bsl);
      int left = avL && (log2i(BH[mi_size[mi_idx(r, c - 1)]] >> 2) < bsl);
      int ctx = left * 2 + above;
      uint16_t *cd = cdf.partition[(bsl - 1) * 4 + ctx];
      int nsym = bsl == 1 ? 4 : (bsl == 5 ? 8 : 10);
      if (has_rows && has_cols) {
        partition = sd.read(cd, nsym);
      } else {
        // split_or_horz / split_or_vert: a bool whose probability of 1
        // (PARTITION_SPLIT) gathers the partitions that split that way
        auto prob = [&](int e) { return (e > 0 ? cd[e - 1] : 32768) - cd[e]; };
        bool big = bsize != BLOCK_128X128;
        int sum;
        if (has_cols)        // no rows: SPLIT against HORZ
          sum = prob(2) + prob(3) + prob(4) + prob(6) + prob(7) + (big ? prob(9) : 0);
        else if (has_rows)   // no columns: SPLIT against VERT
          sum = prob(1) + prob(3) + prob(4) + prob(5) + prob(6) + (big ? prob(8) : 0);
        else
          sum = -1;
        if (sum < 0) {
          partition = 3;
        } else {
          uint16_t tmp[3] = {(uint16_t)sum, 0, 0};
          partition = sd.read(tmp, 2, false) ? 3 : (has_cols ? 1 : 2);
        }
      }
    }
    int w = BW[bsize], h = BH[bsize];
    int sub, split = block_of(w / 2, h / 2);
    switch (partition) {
      case 0: sub = bsize; break;
      case 1: case 4: case 5: sub = block_of(w, h / 2); break;
      case 2: case 6: case 7: sub = block_of(w / 2, h); break;
      case 3: sub = split; break;
      case 8: sub = block_of(w, h / 4); break;
      default: sub = block_of(w / 4, h); break;
    }
    switch (partition) {
      case 0: decode_block(r, c, sub); break;
      case 1:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case 2:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case 3:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case 4:   // HORZ_A
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case 5:   // HORZ_B
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case 6:   // VERT_A
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case 7:   // VERT_B
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case 8:   // HORZ_4
        for (int i = 0; i < 4; i++) {
          int rr = r + i * quarter;
          if (i > 0 && rr >= mi_rows) break;
          decode_block(rr, c, sub);
        }
        break;
      default:  // VERT_4
        for (int i = 0; i < 4; i++) {
          int cc = c + i * quarter;
          if (i > 0 && cc >= mi_cols) break;
          decode_block(r, cc, sub);
        }
        break;
    }
  }

  // ------------------------------------------------------------ block
  void decode_block(int r, int c, int bsize) {
    mi_row = r;
    mi_col = c;
    mi_sz = bsize;
    int bw4 = BW[bsize] >> 2, bh4 = BH[bsize] >> 2;
    if (bh4 == 1 && ssy && (mi_row & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && ssx && (mi_col & 1) == 0) has_chroma = 0;
    else has_chroma = planes > 1;
    avail_u = is_inside(r - 1, c);
    avail_l = is_inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
      if (ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    intra_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    for (int y = 0; y < bh4; y++) {
      if (r + y >= mi_rows) break;
      for (int x = 0; x < bw4; x++) {
        if (c + x >= mi_cols) break;
        int i = mi_idx(r + y, c + x);
        y_mode[i] = (uint8_t)ymode;
        if (has_chroma) uv_mode[i] = (uint8_t)uvmode;
        skips[i] = (uint8_t)skip;
        mi_size[i] = (uint8_t)bsize;
        is_inter[i] = (uint8_t)use_intrabc;
        mvs[2 * i] = mv[0];
        mvs[2 * i + 1] = mv[1];
        written[i] = 1;
        pal_size[0][i] = (uint8_t)pal_y;
        pal_size[1][i] = (uint8_t)pal_uv;
        std::memcpy(&pal_colors[0][8 * (size_t)i], pal_colors_y, 8);
        std::memcpy(&pal_colors[1][8 * (size_t)i], pal_colors_u, 8);
      }
    }
    stats[S_PALETTE_BLOCKS] += pal_y || pal_uv;
    stats[S_INTRABC_BLOCKS] += use_intrabc;
    stats[S_PALETTE_UV_BLOCKS] += pal_uv > 0;
    if (use_intrabc) predict_intrabc();
    residual();
  }

  void intra_frame_mode_info() {
    int ctx = 0;
    if (avail_u) ctx += skips[mi_idx(mi_row - 1, mi_col)];
    if (avail_l) ctx += skips[mi_idx(mi_row, mi_col - 1)];
    skip = sd.read(cdf.skip[ctx], 2);
    read_cdef();
    read_delta_qindex();
    read_deltas = 0;
    use_intrabc = allow_intrabc ? sd.read(cdf.intrabc, 2) : 0;
    mv[0] = mv[1] = 0;
    pal_y = pal_uv = 0;
    std::memset(pal_colors_y, 0, 8);
    std::memset(pal_colors_u, 0, 8);
    std::memset(pal_colors_v, 0, 8);
    if (use_intrabc) {    // 5.11.7: an inter block whose reference is this frame
      ymode = uvmode = DC_PRED;
      angle_y = angle_uv = cfl_u = cfl_v = use_fi = 0;
      intrabc_dv();
      return;
    }
    int above = avail_u ? y_mode[mi_idx(mi_row - 1, mi_col)] : (int)DC_PRED;
    int left = avail_l ? y_mode[mi_idx(mi_row, mi_col - 1)] : (int)DC_PRED;
    ymode = sd.read(cdf.kf_y_mode[INTRA_MODE_CTX[above]][INTRA_MODE_CTX[left]], 13);
    angle_y = 0;
    if (mi_sz >= BLOCK_8X8 && is_directional(ymode))
      angle_y = sd.read(cdf.angle_delta[ymode - V_PRED], 7) - 3;
    uvmode = DC_PRED;
    angle_uv = 0;
    cfl_u = cfl_v = 0;
    if (has_chroma) {
      bool cfl_allowed;
      if (lossless) cfl_allowed = plane_res_size(mi_sz, 1) == BLOCK_4X4;
      else cfl_allowed = std::max(BW[mi_sz], BH[mi_sz]) <= 32;
      if (cfl_allowed) uvmode = sd.read(cdf.uv_cfl[ymode], 14);
      else uvmode = sd.read(cdf.uv_nocfl[ymode], 13);
      if (uvmode == UV_CFL_PRED) {
        int signs = sd.read(cdf.cfl_sign, 8);
        int su = (signs + 1) / 3, sv = (signs + 1) % 3;
        if (su) {
          int a = sd.read(cdf.cfl_alpha[(su - 1) * 3 + sv], 16) + 1;
          cfl_u = su == 1 ? -a : a;
        }
        if (sv) {
          int a = sd.read(cdf.cfl_alpha[(sv - 1) * 3 + su], 16) + 1;
          cfl_v = sv == 1 ? -a : a;
        }
      }
      if (mi_sz >= BLOCK_8X8 && is_directional(uvmode))
        angle_uv = sd.read(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
    }
    if (mi_sz >= BLOCK_8X8 && BW[mi_sz] <= 64 && BH[mi_sz] <= 64 && screen)
      palette_mode_info();
    use_fi = 0;
    if (p[P_FILTER_INTRA] && ymode == DC_PRED && pal_y == 0 &&
        std::max(BW[mi_sz], BH[mi_sz]) <= 32) {
      use_fi = sd.read(cdf.use_fi[mi_sz], 2);
      if (use_fi) fi_mode = sd.read(cdf.fi_mode, 5);
    }
  }

  // 5.11.56: one cdef_idx per 64x64, read at its first non-skip block
  void read_cdef() {
    if (skip || !p[P_CDEF]) return;
    int8_t &idx = cdef_idx[(size_t)(mi_row >> 4) * cdef_stride + (mi_col >> 4)];
    if (idx != -1) return;
    idx = (int8_t)sd.literal(p[P_CDEF_BITS]);
    int w4 = BW[mi_sz] >> 2, h4 = BH[mi_sz] >> 2;
    for (int y = mi_row; y < mi_row + h4 && y < mi_rows; y += 16)
      for (int x = mi_col; x < mi_col + w4 && x < mi_cols; x += 16)
        cdef_idx[(size_t)(y >> 4) * cdef_stride + (x >> 4)] = idx;
  }

  // 5.11.34: delta_qindex at the first block of each superblock, unless
  // that block is the whole superblock and skipped
  void read_delta_qindex() {
    if (!read_deltas) return;
    if (mi_sz == (use128 ? BLOCK_128X128 : BLOCK_64X64) && skip) return;
    int a = sd.read(cdf.delta_q, 4);
    if (a == 3) {
      int rem = sd.literal(3) + 1;
      a = sd.literal(rem) + (1 << rem) + 1;
    }
    if (a) {
      int d = sd.literal(1) ? -a : a;
      cur_q = clip3(1, 255, cur_q + d * (1 << p[P_DELTA_Q_RES]));
      stats[S_DELTA_Q_BLOCKS]++;
    }
  }

  // ------------------------------------------------------------ palette
  // 5.11.46: the palette sizes and colours of a block of 8x8 to 64x64
  void palette_mode_info() {
    int bsize_ctx = log2i(BW[mi_sz] >> 2) + log2i(BH[mi_sz] >> 2) - 2;
    if (ymode == DC_PRED) {
      int ctx = 0;
      if (avail_u && pal_size[0][mi_idx(mi_row - 1, mi_col)]) ctx++;
      if (avail_l && pal_size[0][mi_idx(mi_row, mi_col - 1)]) ctx++;
      if (sd.read(cdf.palette_y_mode[bsize_ctx][ctx], 2)) {
        pal_y = sd.read(cdf.palette_y_size[bsize_ctx], 7) + 2;
        read_palette_colors(0, pal_y, pal_colors_y);
      }
    }
    if (has_chroma && uvmode == DC_PRED &&
        sd.read(cdf.palette_uv_mode[pal_y > 0], 2)) {
      pal_uv = sd.read(cdf.palette_uv_size[bsize_ctx], 7) + 2;
      read_palette_colors(1, pal_uv, pal_colors_u);
      if (sd.literal(1)) {       // delta_encode_palette_colors_v
        int bits = 8 - 4 + sd.literal(2);
        pal_colors_v[0] = (uint8_t)sd.literal(8);
        for (int i = 1; i < pal_uv; i++) {
          int d = sd.literal(bits);
          if (d && sd.literal(1)) d = -d;
          int v = pal_colors_v[i - 1] + d;
          if (v < 0) v += 256;
          if (v >= 256) v -= 256;
          pal_colors_v[i] = clip1(v);
        }
      } else {
        for (int i = 0; i < pal_uv; i++) pal_colors_v[i] = (uint8_t)sd.literal(8);
      }
    }
  }

  // Y (plane 0) or U colours: from the cache, then a literal, then
  // ascending deltas (at least 1 for Y), sorted
  void read_palette_colors(int plane, int n, uint8_t *colors) {
    uint8_t cache[16];
    int cache_n = palette_cache(plane, cache), idx = 0;
    for (int i = 0; i < cache_n && idx < n; i++)
      if (sd.literal(1)) colors[idx++] = cache[i];
    if (idx < n) colors[idx++] = (uint8_t)sd.literal(8);
    int bits = 0;
    if (idx < n) bits = 8 - 3 + sd.literal(2);
    for (; idx < n; idx++) {
      int d = sd.literal(bits) + (plane == 0);
      colors[idx] = clip1(colors[idx - 1] + d);
      int range = 256 - colors[idx] - (plane == 0);
      int ceil_log2 = range < 2 ? 0 : log2i(range - 1) + 1;
      bits = std::min(bits, ceil_log2);
    }
    std::sort(colors, colors + n);
  }

  // get_palette_cache: the above (not across a 64-row edge) and left
  // blocks' colours merged in order without repeats
  int palette_cache(int plane, uint8_t *cache) {
    int above_n = 0, left_n = 0;
    const uint8_t *above = nullptr, *left = nullptr;
    if (((mi_row * 4) % 64) && avail_u) {
      int i = mi_idx(mi_row - 1, mi_col);
      above_n = pal_size[plane][i];
      above = &pal_colors[plane][8 * (size_t)i];
    }
    if (avail_l) {
      int i = mi_idx(mi_row, mi_col - 1);
      left_n = pal_size[plane][i];
      left = &pal_colors[plane][8 * (size_t)i];
    }
    int ai = 0, li = 0, n = 0;
    auto add = [&](int v) {
      if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    };
    while (ai < above_n && li < left_n) {
      int a = above[ai], l = left[li];
      if (l < a) {
        add(l);
        li++;
      } else {
        add(a);
        ai++;
        if (l == a) li++;
      }
    }
    for (; ai < above_n; ai++) add(above[ai]);
    for (; li < left_n; li++) add(left[li]);
    return n;
  }

  // 5.11.49: the colour index maps, in wavefront order
  void palette_tokens() {
    int bw = BW[mi_sz], bh = BH[mi_sz];
    int onw = std::min(bw, (mi_cols - mi_col) * 4);
    int onh = std::min(bh, (mi_rows - mi_row) * 4);
    if (pal_y) color_map(color_map_y, pal_y, bw, bh, onw, onh, cdf.palette_y_color);
    if (pal_uv) {
      bw >>= ssx;
      bh >>= ssy;
      onw >>= ssx;
      onh >>= ssy;
      if (bw < 4) { bw += 2; onw += 2; }
      if (bh < 4) { bh += 2; onh += 2; }
      color_map(color_map_uv, pal_uv, bw, bh, onw, onh, cdf.palette_uv_color);
    }
  }

  void color_map(uint8_t m[64][64], int n, int bw, int bh, int onw, int onh,
                 uint16_t cdfs[7][5][9]) {
    m[0][0] = (uint8_t)sd.ns(n);
    for (int i = 1; i < onh + onw - 1; i++)
      for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
        int order[8];
        int ctx = color_context(m, i - j, j, n, order);
        m[i - j][j] = (uint8_t)order[sd.read(cdfs[n - 2][ctx], n)];
      }
    for (int i = 0; i < onh; i++)
      for (int j = onw; j < bw; j++) m[i][j] = m[i][onw - 1];
    for (int i = onh; i < bh; i++)
      for (int j = 0; j < bw; j++) m[i][j] = m[onh - 1][j];
  }

  // get_palette_color_context: the neighbours' colours ranked by score,
  // and the context of their hash
  static int color_context(uint8_t m[64][64], int r, int c, int n, int *order) {
    static const int HASH_CTX[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
    int scores[8] = {0};
    for (int i = 0; i < 8; i++) order[i] = i;
    if (c > 0) scores[m[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[m[r - 1][c - 1]] += 1;
    if (r > 0) scores[m[r - 1][c]] += 2;
    for (int i = 0; i < 3; i++) {
      int best = scores[i], bi = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > best) { best = scores[j]; bi = j; }
      if (bi != i) {
        int bo = order[bi];
        for (int k = bi; k > i; k--) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = best;
        order[i] = bo;
      }
    }
    int ctx = HASH_CTX[scores[0] + scores[1] * 2 + scores[2] * 2];
    if (ctx < 0) throw std::runtime_error("palette colour context");
    return ctx;
  }

  void predict_palette(int plane, int startx, int starty, int x, int y, int txsz) {
    const uint8_t *pal = plane == 0 ? pal_colors_y : (plane == 1 ? pal_colors_u : pal_colors_v);
    uint8_t (*m)[64] = plane == 0 ? color_map_y : color_map_uv;
    for (int i = 0; i < TXH[txsz]; i++)
      for (int j = 0; j < TXW[txsz]; j++)
        frame[plane].at(starty + i, startx + j) = pal[m[y * 4 + i][x * 4 + j]];
  }

  // ------------------------------------------------------------ intra block copy
  // 7.10.2 for use_intrabc (RefFrame INTRA_FRAME, one list, no temporal
  // candidates): the stack of the spatial neighbours' DVs, then
  // assign_mv's choice and read_mv, then dav1d's clip of the DV to the
  // decoded part of the tile
  int stack_n, stack_mv[8][2], stack_w[8];

  void add_candidate(int r, int c, int weight) {
    int i = mi_idx(r, c);
    if (!is_inter[i]) return;
    int cand[2];
    for (int k = 0; k < 2; k++) {      // lower_mv_precision, force_integer_mv
      int v = mvs[2 * i + k], a = (std::abs(v) + 3) >> 3;
      cand[k] = v > 0 ? a << 3 : -(a << 3);
    }
    for (int k = 0; k < stack_n; k++)
      if (stack_mv[k][0] == cand[0] && stack_mv[k][1] == cand[1]) {
        stack_w[k] += weight;
        return;
      }
    if (stack_n < 8) {
      stack_mv[stack_n][0] = cand[0];
      stack_mv[stack_n][1] = cand[1];
      stack_w[stack_n++] = weight;
    }
  }

  void scan_row(int drow) {
    int bw4 = BW[mi_sz] >> 2;
    int end4 = std::min(std::min(bw4, mi_cols - mi_col), 16);
    int dcol = 0;
    if (std::abs(drow) > 1) {
      drow += mi_row & 1;
      dcol = 1 - (mi_col & 1);
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + drow, c = mi_col + dcol + i;
      if (!is_inside(r, c)) break;
      int len = std::min(bw4, BW[mi_size[mi_idx(r, c)]] >> 2);
      if (std::abs(drow) > 1) len = std::max(2, len);
      if (bw4 >= 16) len = std::max(4, len);
      add_candidate(r, c, len * 2);
      i += len;
    }
  }

  void scan_col(int dcol) {
    int bh4 = BH[mi_sz] >> 2;
    int end4 = std::min(std::min(bh4, mi_rows - mi_row), 16);
    int drow = 0;
    if (std::abs(dcol) > 1) {
      drow = 1 - (mi_row & 1);
      dcol += mi_col & 1;
    }
    for (int i = 0; i < end4;) {
      int r = mi_row + drow + i, c = mi_col + dcol;
      if (!is_inside(r, c)) break;
      int len = std::min(bh4, BH[mi_size[mi_idx(r, c)]] >> 2);
      if (std::abs(dcol) > 1) len = std::max(2, len);
      if (bh4 >= 16) len = std::max(4, len);
      add_candidate(r, c, len * 2);
      i += len;
    }
  }

  void scan_point(int drow, int dcol) {
    int r = mi_row + drow, c = mi_col + dcol;
    if (is_inside(r, c) && written[mi_idx(r, c)]) add_candidate(r, c, 4);
  }

  void sort_stack(int start, int end) {
    while (end > start) {
      int new_end = start;
      for (int i = start + 1; i < end; i++)
        if (stack_w[i - 1] < stack_w[i]) {
          std::swap(stack_w[i - 1], stack_w[i]);
          std::swap(stack_mv[i - 1][0], stack_mv[i][0]);
          std::swap(stack_mv[i - 1][1], stack_mv[i][1]);
          new_end = i;
        }
      end = new_end;
    }
  }

  int read_mv_component(int comp) {
    int sign = sd.read(cdf.mv_sign[comp], 2);
    int cls = sd.read(cdf.mv_class[comp], 11);
    int mag;
    if (cls == 0) {   // integer DVs: no fractional or high-precision bits
      mag = ((sd.read(cdf.mv_class0_bit[comp], 2) << 3) | 7) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++) d |= sd.read(cdf.mv_bit[comp][i], 2) << i;
      mag = (2 << (cls + 2)) + ((d << 3) | 7) + 1;
    }
    return sign ? -mag : mag;
  }

  void intrabc_dv() {
    int bw4 = BW[mi_sz] >> 2, bh4 = BH[mi_sz] >> 2;
    stack_n = 0;
    scan_row(-1);
    scan_col(-1);
    if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
    int nearest = stack_n;
    // the specification adds REF_CAT_LEVEL to the nearest candidates'
    // weights; the two groups are sorted apart, so it changes no order
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sort_stack(0, nearest);
    sort_stack(nearest, stack_n);
    for (int i = 0; i < stack_n; i++) {   // clamp_mv_row / clamp_mv_col
      int br = 128 + bh4 * 32, bc = 128 + bw4 * 32;
      stack_mv[i][0] = clip3(-mi_row * 32 - br, (mi_rows - bh4 - mi_row) * 32 + br, stack_mv[i][0]);
      stack_mv[i][1] = clip3(-mi_col * 32 - bc, (mi_cols - bw4 - mi_col) * 32 + bc, stack_mv[i][1]);
    }
    for (int i = stack_n; i < 2; i++) stack_mv[i][0] = stack_mv[i][1] = 0;
    int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
    if (!pred[0] && !pred[1]) { pred[0] = stack_mv[1][0]; pred[1] = stack_mv[1][1]; }
    if (!pred[0] && !pred[1]) {
      int sb = use128 ? 32 : 16;
      if (mi_row - sb < mi_row_start) {
        pred[0] = 0;
        pred[1] = -(sb * 4 + 256) * 8;    // INTRABC_DELAY_PIXELS
      } else {
        pred[0] = -(sb * 4 * 8);
        pred[1] = 0;
      }
    }
    int joint = sd.read(cdf.mv_joint, 4);
    mv[0] = pred[0] + ((joint == 2 || joint == 3) ? read_mv_component(0) : 0);
    mv[1] = pred[1] + ((joint == 1 || joint == 3) ? read_mv_component(1) : 0);
    // dav1d's clip: inside the tile, out of the current superblock
    int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
    if (has_chroma) {
      if (bw4 < 2 && ssx) border_left += 4;
      if (bh4 < 2 && ssy) border_top += 4;
    }
    int left = mi_col * 4 + (mv[1] >> 3), top = mi_row * 4 + (mv[0] >> 3);
    int right = left + bw4 * 4, bottom = top + bh4 * 4;
    int border_right = ((mi_col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
    if (left < border_left) {
      right += border_left - left;
      left = border_left;
    } else if (right > border_right) {
      left -= right - border_right;
      right = border_right;
    }
    if (top < border_top) {
      bottom += border_top - top;
      top = border_top;
    }
    int sbl = 6 + use128;
    int sbx = (mi_col >> (sbl - 2)) << sbl, sby = (mi_row >> (sbl - 2)) << sbl;
    if (bottom > sby && right > sbx) {
      if (top - border_top >= bottom - sby) {
        top -= bottom - sby;
        bottom = sby;
      } else if (left - border_left >= right - sbx) {
        left -= right - sbx;
        right = sbx;
      }
    }
    if (bottom > sby + (1 << sbl)) {
      top -= bottom - (sby + (1 << sbl));
      bottom = sby + (1 << sbl);
    }
    if (bottom > sby && right > sbx)
      throw std::runtime_error("intra block copy DV inside the current superblock");
    mv[1] = (left - mi_col * 4) * 8;
    mv[0] = (top - mi_row * 4) * 8;
  }

  // 7.11.3 for intra block copy: each plane's block (one prediction: in
  // an intra frame every block's RefFrame[0] is INTRA_FRAME) copied from
  // the frame before filtering with the BILINEAR filter, InterRound0 3
  // and InterRound1 11, positions clamped to the MiCols x MiRows area
  void predict_intrabc() {
    uint8_t pred[128][128];
    for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int psz = plane_res_size(mi_sz, pl);
      int w = BW[psz], h = BH[psz];
      int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
      int dx = (2 * mv[1]) >> sx, dy = (2 * mv[0]) >> sy;   // sixteenths
      int xi = x0 + (dx >> 4), yi = y0 + (dy >> 4), fx = dx & 15, fy = dy & 15;
      int lastx = ((mi_cols * 4) >> sx) - 1, lasty = ((mi_rows * 4) >> sy) - 1;
      Plane &fp = frame[pl];
      auto ref = [&](int yy, int xx) {
        return (int)fp.at(clip3(0, lasty, yy), clip3(0, lastx, xx));
      };
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int inter[2];
          for (int k = 0; k < 2; k++) {
            int s = (128 - 8 * fx) * ref(yi + i + k, xi + j) + 8 * fx * ref(yi + i + k, xi + j + 1);
            inter[k] = round2(s, 3);
          }
          pred[i][j] = clip1(round2((128 - 8 * fy) * inter[0] + 8 * fy * inter[1], 11));
        }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) fp.at(y0 + i, x0 + j) = pred[i][j];
    }
  }

  // ------------------------------------------------------------ transform size
  // 5.11.15: intra blocks and skipped intra block copies read tx_depth;
  // the others read the transform tree (read_var_tx_size)
  void read_block_tx_size() {
    int bw4 = BW[mi_sz] >> 2, bh4 = BH[mi_sz] >> 2;
    if (tx_mode == 2 && mi_sz > BLOCK_4X4 && use_intrabc && !skip && !lossless) {
      int maxr = max_tx_rect(mi_sz);
      for (int r = mi_row; r < mi_row + bh4; r += TXH[maxr] >> 2)
        for (int c = mi_col; c < mi_col + bw4; c += TXW[maxr] >> 2)
          read_var_tx_size(r, c, maxr, 0);
      return;
    }
    read_tx_size(!skip || !use_intrabc);
    set_inter_tx(mi_row, mi_col, bw4, bh4, tx_size);
  }

  void set_inter_tx(int r, int c, int w4, int h4, int t) {
    for (int i = r; i < std::min(r + h4, mi_rows); i++)
      for (int j = c; j < std::min(c + w4, mi_cols); j++) inter_tx[mi_idx(i, j)] = (uint8_t)t;
  }

  void read_var_tx_size(int r, int c, int t, int depth) {
    if (r >= mi_rows || c >= mi_cols) return;
    int split = 0;
    if (t != TX_4X4 && depth != 2) {   // MAX_VARTX_DEPTH
      int above = above_tx_width(r, c) < TXW[t], left = left_tx_height(r, c) < TXH[t];
      int size = std::min(64, std::max(BW[mi_sz], BH[mi_sz]));
      int maxsq = tx_of(size, size);
      int ctx = (tx_sqr_up(t) != maxsq) * 3 + (TX_64X64 - maxsq) * 6 + above + left;
      split = sd.read(cdf.txfm_split[ctx], 2);
    }
    if (split) {
      int sub = SPLIT_TX[t];
      for (int i = 0; i < TXH[t] >> 2; i += TXH[sub] >> 2)
        for (int j = 0; j < TXW[t] >> 2; j += TXW[sub] >> 2)
          read_var_tx_size(r + i, c + j, sub, depth + 1);
    } else {
      set_inter_tx(r, c, TXW[t] >> 2, TXH[t] >> 2, t);
      tx_size = t;
    }
  }

  int above_tx_width(int r, int c) {
    if (r == mi_row) {
      if (!avail_u) return 64;
      int i = mi_idx(r - 1, c);
      if (skips[i] && is_inter[i]) return BW[mi_size[i]];
    }
    return TXW[inter_tx[mi_idx(r - 1, c)]];
  }
  int left_tx_height(int r, int c) {
    if (c == mi_col) {
      if (!avail_l) return 64;
      int i = mi_idx(r, c - 1);
      if (skips[i] && is_inter[i]) return BH[mi_size[i]];
    }
    return TXH[inter_tx[mi_idx(r, c - 1)]];
  }

  void read_tx_size(bool allow_select) {
    if (lossless) { tx_size = TX_4X4; return; }
    int maxr = max_tx_rect(mi_sz);
    int depth_max = max_tx_depth(mi_sz);
    tx_size = maxr;
    if (mi_sz > BLOCK_4X4 && allow_select && tx_mode == 2) {
      // an inter neighbour counts with its block size
      int above_w = 0, left_h = 0;
      if (avail_u) {
        int i = mi_idx(mi_row - 1, mi_col);
        above_w = is_inter[i] ? BW[mi_size[i]] : above_tx_width(mi_row, mi_col);
      }
      if (avail_l) {
        int i = mi_idx(mi_row, mi_col - 1);
        left_h = is_inter[i] ? BH[mi_size[i]] : left_tx_height(mi_row, mi_col);
      }
      int ctx = (avail_u && above_w >= TXW[maxr]) + (avail_l && left_h >= TXH[maxr]);
      int cat = depth_max - 1;   // 0..3
      int nsym = depth_max > 1 ? 3 : 2;
      int depth = sd.read(cdf.tx_size[cat][ctx], nsym);
      for (int i = 0; i < depth; i++) tx_size = SPLIT_TX[tx_size];
    }
  }

  void reset_block_context(int bw4, int bh4) {
    for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++)
        above_level[pl][i] = above_dc[pl][i] = 0;
      for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++)
        left_level[pl][i] = left_dc[pl][i] = 0;
    }
  }

  // ------------------------------------------------------------ residual
  void residual() {
    int sbmask = use128 ? 31 : 15;
    int wchunks = std::max(1, BW[mi_sz] >> 6), hchunks = std::max(1, BH[mi_sz] >> 6);
    for (int cy = 0; cy < hchunks; cy++)
      for (int cx = 0; cx < wchunks; cx++) {
        for (int pl = 0; pl < 1 + has_chroma * 2; pl++) {
          if (use_intrabc && !lossless && pl == 0) {
            inter_luma(cx, cy, sbmask);
            continue;
          }
          int txsz = lossless ? TX_4X4 : get_tx_size(pl, tx_size);
          int stepx = TXW[txsz] >> 2, stepy = TXH[txsz] >> 2;
          int psz = plane_res_size(mi_sz, pl);
          int n4w = BW[psz] >> 2, n4h = BH[psz] >> 2;
          int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
          int basex = (mi_col >> sx) * 4, basey = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> sy); y += stepy)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x += stepx)
              transform_block(pl, basex, basey, txsz, x + ((cx << 4) >> sx),
                              y + ((cy << 4) >> sy), sbmask);
        }
      }
  }

  // the luma transform tree of an inter block in one 64x64 chunk: each
  // largest transform split down to the InterTxSizes it was read as
  void inter_luma(int cx, int cy, int sbmask) {
    int maxr = max_tx_rect(mi_sz);
    int x1 = std::min(BW[mi_sz], cx * 64 + 64), y1 = std::min(BH[mi_sz], cy * 64 + 64);
    for (int y = cy * 64; y < y1; y += TXH[maxr])
      for (int x = cx * 64; x < x1; x += TXW[maxr])
        tx_tree(mi_col * 4 + x, mi_row * 4 + y, maxr, sbmask);
  }
  void tx_tree(int px, int py, int t, int sbmask) {
    if (px >= mi_cols * 4 || py >= mi_rows * 4) return;
    if (inter_tx[mi_idx(py >> 2, px >> 2)] == t) {
      transform_block(0, px, py, t, 0, 0, sbmask);
      return;
    }
    if (t == TX_4X4) throw std::runtime_error("transform tree");
    int sub = SPLIT_TX[t];
    for (int i = 0; i < TXH[t]; i += TXH[sub])
      for (int j = 0; j < TXW[t]; j += TXW[sub]) tx_tree(px + j, py + i, sub, sbmask);
  }

  void transform_block(int plane, int basex, int basey, int txsz, int x, int y,
                       int sbmask) {
    int startx = basex + 4 * x, starty = basey + 4 * y;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int row = (starty << sy) >> 2, col = (startx << sx) >> 2;
    int sbrow = row & sbmask, sbcol = col & sbmask;
    int stepx = TXW[txsz] >> 2, stepy = TXH[txsz] >> 2;
    int maxx = mi_cols * 4 - 1, maxy = mi_rows * 4 - 1;
    if (startx > (maxx >> sx) || starty > (maxy >> sy)) return;
    bool is_cfl = plane > 0 && uvmode == UV_CFL_PRED;
    int mode = plane == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
    int log2w = log2i(TXW[txsz]), log2h = log2i(TXH[txsz]);
    int bdr = (sbrow >> sy), bdc = (sbcol >> sx);
    if (!use_intrabc) {
      if (plane == 0 ? pal_y : pal_uv) {
        predict_palette(plane, startx, starty, x, y, txsz);
      } else {
        int have_ar = block_decoded[plane][bdr - 1 + 1][bdc + stepx + 1];
        int have_bl = block_decoded[plane][bdr + stepy + 1][bdc - 1 + 1];
        predict_intra(plane, startx, starty,
                      (plane == 0 ? avail_l : avail_l_chroma) || x > 0,
                      (plane == 0 ? avail_u : avail_u_chroma) || y > 0, have_ar,
                      have_bl, mode, log2w, log2h);
        if (is_cfl) predict_cfl(plane, startx, starty, txsz);
      }
      if (plane == 0) {
        max_luma_w = startx + stepx * 4;
        max_luma_h = starty + stepy * 4;
      }
    }
    if (!skip) {
      int eob = coeffs(plane, startx, starty, txsz);
      if (eob > 0) reconstruct(plane, startx, starty, txsz);
    }
    for (int i = 0; i < stepy; i++)
      for (int j = 0; j < stepx; j++) {
        int rr = bdr + i + 1, cc = bdc + j + 1;
        if (rr < 34 && cc < 34) block_decoded[plane][rr][cc] = 1;
        size_t li = (size_t)((starty >> 2) + i) * lf_stride[plane] + (startx >> 2) + j;
        if (li < lf_tx[plane].size()) lf_tx[plane][li] = (uint8_t)txsz;
      }
  }

  // ------------------------------------------------------------ prediction
  int filter_type(int plane) {
    int above_sm = 0, left_sm = 0;
    auto smooth = [&](int r, int c) {
      int m = plane == 0 ? y_mode[mi_idx(r, c)] : uv_mode[mi_idx(r, c)];
      return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    };
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (ssx && !(mi_col & 1)) c++;
        if (ssy && (mi_row & 1)) r--;
      }
      above_sm = smooth(r, c);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (ssx && (mi_col & 1)) c--;
        if (ssy && !(mi_row & 1)) r++;
      }
      left_sm = smooth(r, c);
    }
    return above_sm || left_sm;
  }

  static int edge_strength(int w, int h, int ftype, int delta) {
    int d = std::abs(delta), wh = w + h, s = 0;
    if (ftype == 0) {
      if (wh <= 8) { if (d >= 56) s = 1; }
      else if (wh <= 12) { if (d >= 40) s = 1; }
      else if (wh <= 16) { if (d >= 40) s = 1; }
      else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (wh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  static int use_upsample(int w, int h, int ftype, int delta) {
    int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return ftype ? (wh <= 8) : (wh <= 16);
  }
  // buf points at index 0 of an edge with valid indices -2..
  static void edge_filter(int *buf, int sz, int strength) {
    static const int K[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    if (!strength) return;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += K[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }
  static void edge_upsample(int *buf, int numpx) {
    int dup[80];
    dup[0] = buf[-1];
    for (int i = -1; i < numpx; i++) dup[i + 2] = buf[i];
    dup[numpx + 2] = buf[numpx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numpx; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above,
                     int have_ar, int have_bl, int mode, int log2w, int log2h) {
    Plane &fp = frame[plane];
    int w = 1 << log2w, h = 1 << log2h;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int maxx = ((mi_cols * 4) >> sx) - 1, maxy = ((mi_rows * 4) >> sy) - 1;
    int above_buf[320], left_buf[320];
    int *above = above_buf + 16, *left = left_buf + 16;
    int n = w + h;
    if (!have_above && have_left) {
      for (int i = 0; i < n; i++) above[i] = fp.at(y, x - 1);
    } else if (!have_above && !have_left) {
      for (int i = 0; i < n; i++) above[i] = 127;
    } else {
      int lim = std::min(maxx, x + (have_ar ? 2 * w : w) - 1);
      for (int i = 0; i < n; i++) above[i] = fp.at(y - 1, std::min(lim, x + i));
    }
    if (!have_left && have_above) {
      for (int i = 0; i < n; i++) left[i] = fp.at(y - 1, x);
    } else if (!have_left && !have_above) {
      for (int i = 0; i < n; i++) left[i] = 129;
    } else {
      int lim = std::min(maxy, y + (have_bl ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) left[i] = fp.at(std::min(lim, y + i), x - 1);
    }
    if (have_above && have_left) above[-1] = fp.at(y - 1, x - 1);
    else if (have_above) above[-1] = fp.at(y - 1, x);
    else if (have_left) above[-1] = fp.at(y, x - 1);
    else above[-1] = 128;
    left[-1] = above[-1];
    uint8_t pred[64][64];
    if (plane == 0 && use_fi) {
      filter_intra_pred(pred, above, left, w, h);
    } else if (is_directional(mode)) {
      int delta = plane == 0 ? angle_y : angle_uv;
      int pangle = MODE_TO_ANGLE[mode] + delta * 3;
      int up_above = 0, up_left = 0;
      if (p[P_EDGE_FILTER]) {
        if (pangle != 90 && pangle != 180) {
          if (pangle > 90 && pangle < 180 && (w + h) >= 24) {
            int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
            left[-1] = above[-1] = v;
          }
          int ft = filter_type(plane);
          if (have_above) {
            int st = edge_strength(w, h, ft, pangle - 90);
            int np = std::min(w, maxx - x + 1) + (pangle < 90 ? h : 0) + 1;
            edge_filter(above, np, st);
          }
          if (have_left) {
            int st = edge_strength(w, h, ft, pangle - 180);
            int np = std::min(h, maxy - y + 1) + (pangle > 180 ? w : 0) + 1;
            edge_filter(left, np, st);
          }
        }
        int ft = filter_type(plane);
        up_above = use_upsample(w, h, ft, pangle - 90);
        if (up_above) edge_upsample(above, w + (pangle < 90 ? h : 0));
        up_left = use_upsample(w, h, ft, pangle - 180);
        if (up_left) edge_upsample(left, h + (pangle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (pangle < 90) dx = AV1_DR_INTRA_DERIVATIVE[pangle];
      else if (pangle > 90 && pangle < 180) dx = AV1_DR_INTRA_DERIVATIVE[180 - pangle];
      if (pangle > 90 && pangle < 180) dy = AV1_DR_INTRA_DERIVATIVE[pangle - 90];
      else if (pangle > 180) dy = AV1_DR_INTRA_DERIVATIVE[270 - pangle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pangle == 90) {
            v = above[j];
          } else if (pangle == 180) {
            v = left[i];
          } else if (pangle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - up_above)) + (j << up_above);
            int shift = ((idx << up_above) >> 1) & 0x1F;
            int maxbase = (w + h - 1) << up_above;
            if (base < maxbase)
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            else
              v = above[maxbase];
          } else if (pangle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - up_left);
              int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
              v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
            }
          } else {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - up_left)) + (i << up_left);
            int shift = ((idx << up_left) >> 1) & 0x1F;
            int maxbase = (w + h - 1) << up_left;
            if (base < maxbase)
              v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
            else
              v = left[maxbase];
          }
          pred[i][j] = (uint8_t)v;
        }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t *wx = AV1_SM_WEIGHTS + (w - 2), *wy = AV1_SM_WEIGHTS + (h - 2);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (mode == SMOOTH_PRED) {
            int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                    wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
            v = round2(s, 9);
          } else if (mode == SMOOTH_V_PRED) {
            v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
          } else {
            v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
          }
          pred[i][j] = (uint8_t)v;
        }
    } else if (mode == DC_PRED) {
      int v;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        for (int k = 0; k < h; k++) sum += left[k];
        sum += (w + h) >> 1;
        v = sum / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        v = clip1((sum + (h >> 1)) >> log2h);
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        v = clip1((sum + (w >> 1)) >> log2w);
      } else {
        v = 128;
      }
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) pred[i][j] = (uint8_t)v;
    } else {   // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = above[j] + left[i] - above[-1];
          int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
              ptl = std::abs(base - above[-1]);
          int v;
          if (pl <= pt && pl <= ptl) v = left[i];
          else if (pt <= ptl) v = above[j];
          else v = above[-1];
          pred[i][j] = (uint8_t)v;
        }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) fp.at(y + i, x + j) = pred[i][j];
  }

  void filter_intra_pred(uint8_t pred[64][64], const int *above, const int *left,
                         int w, int h) {
    int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; i2++)
      for (int j4 = 0; j4 < w4; j4++) {
        int pv[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
            else pv[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
            else pv[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += AV1_FILTER_INTRA_TAPS[fi_mode][i][j] * pv[j];
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip1(round2signed(pr, 4));
        }
      }
  }

  void predict_cfl(int plane, int startx, int starty, int txsz) {
    int w = TXW[txsz], h = TXH[txsz];
    int sx = ssx, sy = ssy;
    int alpha = plane == 1 ? cfl_u : cfl_v;
    static int L[64][64];
    int avg = 0;
    for (int i = 0; i < h; i++) {
      int lumay = std::min(starty + i, (max_luma_h >> sy) - 1) << sy;
      for (int j = 0; j < w; j++) {
        int lumax = std::min(startx + j, (max_luma_w >> sx) - 1) << sx;
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += frame[0].at(lumay + dy, lumax + dx);
        int v = t << (3 - sx - sy);
        L[i][j] = v;
        avg += v;
      }
    }
    avg = round2(avg, log2i(w) + log2i(h));
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int dc = frame[plane].at(starty + i, startx + j);
        int scaled = round2signed(alpha * (L[i][j] - avg), 6);
        frame[plane].at(starty + i, startx + j) = clip1(dc + scaled);
      }
  }

  // ------------------------------------------------------------ coefficients
  int get_tx_set(int txsz) {
    int sq = tx_sqr(txsz), squp = tx_sqr_up(txsz);
    if (squp > TX_32X32) return TX_SET_DCTONLY;
    if (use_intrabc) {
      if (reduced_tx_set || squp == TX_32X32) return TX_SET_INTER_3;
      return sq == TX_16X16 ? 2 : 1;
    }
    if (squp == TX_32X32) return TX_SET_DCTONLY;
    if (reduced_tx_set) return TX_SET_INTRA_2;
    if (sq == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  static bool in_inter_set(int set, int t) {
    if (set == 1) return true;
    if (set == 2) return t != V_ADST && t != H_ADST && t != V_FLIPADST && t != H_FLIPADST;
    if (set == TX_SET_INTER_3) return t == IDTX || t == DCT_DCT;
    return t == DCT_DCT;
  }

  // an inter block's chroma takes the type of its co-located luma 4x4
  int compute_tx_type(int plane, int txsz, int startx, int starty) {
    if (lossless || tx_sqr_up(txsz) > TX_32X32) return DCT_DCT;
    if (plane == 0) return tx_type_cur;
    int set = get_tx_set(txsz);
    if (use_intrabc) {
      int x4 = std::max(mi_col, (startx >> 2) << ssx);
      int y4 = std::max(mi_row, (starty >> 2) << ssy);
      int t = tx_types[mi_idx(y4, x4)];
      return in_inter_set(set, t) ? t : DCT_DCT;
    }
    int t = MODE_TO_TXFM[uvmode];
    if (set == TX_SET_DCTONLY) return t == DCT_DCT ? t : DCT_DCT;
    if (set == TX_SET_INTRA_2 && (t == V_DCT || t == H_DCT)) return DCT_DCT;
    return t;
  }

  int coeffs(int plane, int startx, int starty, int txsz) {
    int x4 = startx >> 2, y4 = starty >> 2;
    int w4 = TXW[txsz] >> 2, h4 = TXH[txsz] >> 2;
    int txszctx = (tx_sqr(txsz) + tx_sqr_up(txsz) + 1) >> 1;
    int ptype = plane > 0;
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int maxx4 = mi_cols >> sx, maxy4 = mi_rows >> sy;
    int w = TXW[txsz], h = TXH[txsz];
    int adj = adjusted_tx(txsz);
    int bwl = log2i(TXW[adj]), tw = TXW[adj], th = TXH[adj];
    std::memset(quant, 0, sizeof(int32_t) * tw * th);
    // all_zero context
    int ctx;
    int bsz = plane_res_size(mi_sz, plane);
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < maxx4) top = std::max(top, (int)above_level[plane][x4 + k]);
      for (int k = 0; k < h4; k++)
        if (y4 + k < maxy4) left = std::max(left, (int)left_level[plane][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if (BW[bsz] == w && BH[bsz] == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int a = 0, l = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < maxx4) a |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < maxy4) l |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
      ctx = (a != 0) + (l != 0) + 7;
      if (BW[bsz] * BH[bsz] > w * h) ctx += 3;
    }
    int all_zero = sd.read(cdf.txb_skip[txszctx][ctx], 2);
    int eob = 0, cul = 0, dccat = 0;
    if (plane == 0) {
      tx_type_cur = DCT_DCT;
      if (!all_zero) read_tx_type(txsz);
      for (int i = y4; i < std::min(y4 + h4, mi_rows); i++)
        for (int j = x4; j < std::min(x4 + w4, mi_cols); j++)
          tx_types[mi_idx(i, j)] = (uint8_t)tx_type_cur;
    }
    if (!all_zero) {
      int ttype = compute_tx_type(plane, txsz, startx, starty);
      plane_tx_type = ttype;
      int tclass = tx_class(ttype);
      const int16_t *scan;
      static int16_t mrow[1024], mcol[1024];
      if (txsz == TX_16X64) scan = AV1_SCAN_16X32;
      else if (txsz == TX_64X16) scan = AV1_SCAN_32X16;
      else if (tx_sqr_up(txsz) == TX_64X64) scan = AV1_SCAN_32X32;
      else if (ttype == IDTX) scan = default_scan(txsz);
      else if (tclass == TX_CLASS_VERT) {
        for (int i = 0; i < tw * th; i++) mrow[i] = (int16_t)i;
        scan = mrow;
      } else if (tclass == TX_CLASS_HORIZ) {
        for (int i = 0; i < tw * th; i++) mcol[i] = (int16_t)((i % th) * tw + i / th);
        scan = mcol;
      } else scan = default_scan(txsz);
      int eobms = std::min(log2i(w), 5) + std::min(log2i(h), 5) - 4;
      int ectx = tclass == TX_CLASS_2D ? 0 : 1;
      int eobpt;
      switch (eobms) {
        case 0: eobpt = sd.read(cdf.eob16[ptype][ectx], 5) + 1; break;
        case 1: eobpt = sd.read(cdf.eob32[ptype][ectx], 6) + 1; break;
        case 2: eobpt = sd.read(cdf.eob64[ptype][ectx], 7) + 1; break;
        case 3: eobpt = sd.read(cdf.eob128[ptype][ectx], 8) + 1; break;
        case 4: eobpt = sd.read(cdf.eob256[ptype][ectx], 9) + 1; break;
        case 5: eobpt = sd.read(cdf.eob512[ptype][0], 10) + 1; break;
        default: eobpt = sd.read(cdf.eob1024[ptype][0], 11) + 1; break;
      }
      eob = eobpt < 2 ? eobpt : ((1 << (eobpt - 2)) + 1);
      int eshift = eobpt - 3;
      if (eshift >= 0) {
        int extra = sd.read(cdf.eob_extra[txszctx][ptype][eobpt - 3], 2);
        if (extra) eob += 1 << eshift;
        for (int i = 1; i < std::max(0, eobpt - 2); i++) {
          eshift = std::max(0, eobpt - 2) - 1 - i;
          if (sd.boolean()) eob += 1 << eshift;
        }
      }
      static const int SIG_REF[3][5][2] = {
          {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
          {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
          {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
      static const int MAG_REF[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                                           {{0, 1}, {1, 0}, {0, 2}},
                                           {{0, 1}, {1, 0}, {2, 0}}};
      int offsel = w == h ? 0 : (w > h ? 1 : 2);   // by the coded shape
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        int row = pos >> bwl, col = pos - (row << bwl);
        if (c == eob - 1) {
          int bctx;
          if (c == 0) bctx = 0;
          else if (c <= (th << bwl) / 8) bctx = 1;
          else if (c <= (th << bwl) / 4) bctx = 2;
          else bctx = 3;
          level = sd.read(cdf.base_eob[txszctx][ptype][bctx], 3) + 1;
        } else {
          int mag = 0;
          for (int k = 0; k < 5; k++) {
            int rr = row + SIG_REF[tclass][k][0], cc = col + SIG_REF[tclass][k][1];
            if (rr >= 0 && cc >= 0 && rr < th && cc < tw)
              mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
          }
          int bctx = std::min((mag + 1) >> 1, 4);
          if (tclass == TX_CLASS_2D) {
            if (row == 0 && col == 0) bctx = 0;
            else bctx += AV1_COEFF_BASE_CTX_OFFSET[offsel][std::min(row, 4)][std::min(col, 4)];
          } else {
            int idx = tclass == TX_CLASS_VERT ? row : col;
            static const int POS_OFF[3] = {26, 31, 36};
            bctx += POS_OFF[std::min(idx, 2)];
          }
          level = sd.read(cdf.base[txszctx][ptype][bctx], 4);
        }
        if (level > 2) {
          int mag = 0;
          for (int k = 0; k < 3; k++) {
            int rr = row + MAG_REF[tclass][k][0], cc = col + MAG_REF[tclass][k][1];
            if (rr >= 0 && cc >= 0 && rr < th && cc < tw)
              mag += std::min(quant[rr * tw + cc], 15);
          }
          mag = std::min((mag + 1) >> 1, 6);
          int bctx;
          if (pos == 0) bctx = mag;
          else if (tclass == TX_CLASS_2D) bctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
          else if (tclass == TX_CLASS_HORIZ) bctx = col == 0 ? mag + 7 : mag + 14;
          else bctx = row == 0 ? mag + 7 : mag + 14;
          for (int idx = 0; idx < 4; idx++) {
            int br = sd.read(cdf.br[std::min(txszctx, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dcs = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < maxx4) {
                int s = above_dc[plane][x4 + k];
                if (s == 1) dcs--; else if (s == 2) dcs++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < maxy4) {
                int s = left_dc[plane][y4 + k];
                if (s == 1) dcs--; else if (s == 2) dcs++;
              }
            int dctx = dcs < 0 ? 1 : (dcs > 0 ? 2 : 0);
            sign = sd.read(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sd.boolean();
          }
        }
        if (quant[pos] > 14) {
          int length = 0, bit;
          do {
            length++;
            bit = sd.boolean();
            if (length > 32) throw std::runtime_error("golomb length");
          } while (!bit);
          int x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | sd.boolean();
          quant[pos] = x + 14;
        }
        if (pos == 0 && quant[pos] > 0) dccat = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = std::min(63, cul);
    }
    for (int i = 0; i < w4; i++) {
      above_level[plane][x4 + i] = (uint8_t)cul;
      above_dc[plane][x4 + i] = (uint8_t)dccat;
    }
    for (int i = 0; i < h4; i++) {
      left_level[plane][y4 + i] = (uint8_t)cul;
      left_dc[plane][y4 + i] = (uint8_t)dccat;
    }
    return eob;
  }

  void read_tx_type(int txsz) {
    int set = get_tx_set(txsz);
    tx_type_cur = DCT_DCT;
    if (set > 0 && base_q > 0 && use_intrabc) {
      int sq = tx_sqr(txsz);
      if (set == 1) tx_type_cur = INTER_SET1_INV[sd.read(cdf.inter_set1[sq], 16)];
      else if (set == 2) tx_type_cur = INTER_SET2_INV[sd.read(cdf.inter_set2[sq], 12)];
      else tx_type_cur = INTER_SET3_INV[sd.read(cdf.inter_set3[sq], 2)];
    } else if (set > 0 && base_q > 0) {
      int dir = use_fi ? FILTER_INTRA_DIR[fi_mode] : ymode;
      int sq = tx_sqr(txsz);
      if (set == TX_SET_INTRA_1)
        tx_type_cur = SET1_INV[sd.read(cdf.set1[sq][dir], 7)];
      else
        tx_type_cur = SET2_INV[sd.read(cdf.set2[sq][dir], 5)];
    }
  }

  // ------------------------------------------------------------ reconstruct
  void reconstruct(int plane, int startx, int starty, int txsz) {
    int dqdenom = 1;
    if (txsz == TX_32X32 || txsz == TX_16X32 || txsz == TX_32X16 ||
        txsz == TX_16X64 || txsz == TX_64X16) dqdenom = 2;
    if (txsz == TX_64X64 || txsz == TX_32X64 || txsz == TX_64X32) dqdenom = 4;
    int log2w = log2i(TXW[txsz]), log2h = log2i(TXH[txsz]);
    int w = 1 << log2w, h = 1 << log2h;
    int tw = std::min(32, w), th = std::min(32, h);
    const int *dq = p + P_DQ;
    int qdc, qac;
    auto dcq = [&](int d) { return (int)AV1_DC_QLOOKUP[clip3(0, 255, cur_q + d)]; };
    auto acq = [&](int d) { return (int)AV1_AC_QLOOKUP[clip3(0, 255, cur_q + d)]; };
    if (plane == 0) { qdc = dcq(dq[0]); qac = acq(0); }
    else if (plane == 1) { qdc = dcq(dq[1]); qac = acq(dq[2]); }
    else { qdc = dcq(dq[3]); qac = acq(dq[4]); }
    int ttype = plane_tx_type;
    // 7.12.3: the matrix weighs 2-D transforms' steps (AOM_QM_BITS 5)
    const uint8_t *qm = nullptr;
    if (qm_level[plane] < 15 && ttype < IDTX)
      qm = AV1_QUANTIZER_MATRIX[qm_level[plane]][plane > 0] +
           qm_offset[adjusted_tx(txsz)];
    static int32_t res[64][64];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) res[i][j] = 0;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int v = quant[i * tw + j];
        if (!v) continue;
        int q = (i == 0 && j == 0) ? qdc : qac;
        if (qm) q = round2((int64_t)q * qm[j * th + i], 5);
        uint32_t m = (uint32_t)std::abs(v);
        int64_t d = ((int64_t)m * q) & 0xFFFFFF;
        d /= dqdenom;
        if (v < 0) d = -d;
        res[i][j] = clip3(-32768, 32767, (int)d);
      }
    int rk = row_kind(ttype), ck = col_kind(ttype);
    int rowshift = lossless ? 0 : ROW_SHIFT[txsz];
    int colshift = lossless ? 0 : 4;
    int32_t T[64];
    int rows = lossless ? h : std::min(h, 32);
    for (int i = 0; i < rows; i++) {
      bool nz = false;
      for (int j = 0; j < w; j++) {
        T[j] = res[i][j];
        nz |= T[j] != 0;
      }
      if (!nz && !lossless) continue;
      if (std::abs(log2w - log2h) == 1)
        for (int j = 0; j < w; j++) T[j] = round2((int64_t)T[j] * 2896, 12);
      if (lossless) inverse_wht(T, 2);
      else inverse_1d(T, log2w, rk);
      for (int j = 0; j < w; j++) {
        int v = round2((int64_t)T[j], rowshift);
        if (!lossless) v = clip3(-32768, 32767, v);
        res[i][j] = v;
      }
    }
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) T[i] = res[i][j];
      if (lossless) inverse_wht(T, 0);
      else inverse_1d(T, log2h, ck);
      for (int i = 0; i < h; i++) res[i][j] = round2((int64_t)T[i], colshift);
    }
    // FLIPADST: the residual is added upside down or mirrored
    bool flip_ud = ttype == FLIPADST_DCT || ttype == FLIPADST_ADST ||
                   ttype == V_FLIPADST || ttype == FLIPADST_FLIPADST;
    bool flip_lr = ttype == DCT_FLIPADST || ttype == ADST_FLIPADST ||
                   ttype == H_FLIPADST || ttype == FLIPADST_FLIPADST;
    Plane &fp = frame[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        uint8_t &px = fp.at(starty + (flip_ud ? h - 1 - i : i),
                            startx + (flip_lr ? w - 1 - j : j));
        px = clip1(px + res[i][j]);
      }
  }

  // ------------------------------------------------------------ restoration syntax
  int decode_subexp_bool(int numsyms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (numsyms <= mk + 3 * a) return sd.ns(numsyms - mk) + mk;
      if (sd.literal(1)) {
        i++;
        mk += a;
      } else {
        return sd.literal(b2) + mk;
      }
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }
  int decode_signed_subexp(int low, int high, int k, int r) {
    int mx = high - low;
    r -= low;
    int v = decode_subexp_bool(mx, k);
    int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
  }

  void read_lr(int r, int c, int bsize) {
    int w = BW[bsize] >> 2, h = BH[bsize] >> 2;
    for (int pl = 0; pl < planes; pl++) {
      if (lr_type[pl] == RESTORE_NONE) continue;
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int us = lr_size[pl];
      int urows = lr_units_rows[pl], ucols = lr_units_cols[pl];
      int r0 = (r * (4 >> sy) + us - 1) / us;
      int r1 = std::min(urows, ((r + h) * (4 >> sy) + us - 1) / us);
      int c0 = (c * (4 >> sx) + us - 1) / us;
      int c1 = std::min(ucols, ((c + w) * (4 >> sx) + us - 1) / us);
      for (int ur = r0; ur < r1; ur++)
        for (int uc = c0; uc < c1; uc++) read_lr_unit(pl, ur, uc);
    }
  }

  void read_lr_unit(int pl, int ur, int uc) {
    size_t u = (size_t)ur * lr_units_cols[pl] + uc;
    int rtype;
    if (lr_type[pl] == RESTORE_WIENER)
      rtype = sd.read(cdf.restore_w, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (lr_type[pl] == RESTORE_SGRPROJ)
      rtype = sd.read(cdf.restore_s, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else
      rtype = sd.read(cdf.restore_sw, 3);   // NONE, WIENER, SGRPROJ
    lr_unit_type[pl][u] = (uint8_t)rtype;
    static const int WMIN[3] = {-5, -23, -17}, WMAX[3] = {10, 8, 46}, WK[3] = {1, 2, 3};
    if (rtype == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        int first = 0;
        if (pl) { first = 1; lr_wiener[pl][u * 6 + pass * 3] = 0; }
        for (int j = first; j < 3; j++) {
          int v = decode_signed_subexp(WMIN[j], WMAX[j] + 1, WK[j], ref_wiener[pl][pass][j]);
          lr_wiener[pl][u * 6 + pass * 3 + j] = (int8_t)v;
          ref_wiener[pl][pass][j] = v;
        }
      }
    } else if (rtype == RESTORE_SGRPROJ) {
      int set = sd.literal(4);
      lr_sgr_set[pl][u] = (int8_t)set;
      static const int XMIN[2] = {-96, -32}, XMAX[2] = {31, 95};
      for (int i = 0; i < 2; i++) {
        int radius = AV1_SGR_PARAMS[set][i];   // r0, r1
        int v;
        if (radius) {
          v = decode_signed_subexp(XMIN[i], XMAX[i] + 1, 4, ref_sgr[pl][i]);
        } else {
          v = 0;
          if (i == 1) v = clip3(XMIN[i], XMAX[i], (1 << 7) - ref_sgr[pl][0]);
        }
        lr_sgr_xqd[pl][u * 2 + i] = (int16_t)v;
        ref_sgr[pl][i] = v;
      }
    }
  }

  // ------------------------------------------------------------ deblocking
  void loop_filter() {
    const int *lf = p + P_LF;
    if (!lf[0] && !lf[1]) return;
    for (int pl = 0; pl < planes; pl++) {
      if (pl == 1 && !lf[2]) continue;
      if (pl == 2 && !lf[3]) continue;
      for (int pass = 0; pass < 2; pass++) {
        int rstep = pl == 0 ? 1 : (1 << ssy), cstep = pl == 0 ? 1 : (1 << ssx);
        for (int row = 0; row < mi_rows; row += rstep)
          for (int col = 0; col < mi_cols; col += cstep) edge_lf(pl, pass, row, col);
      }
    }
  }

  int filter_level(int plane, int pass) {
    const int *lf = p + P_LF;
    int i = plane == 0 ? pass : plane + 1;
    int lvl = clip3(0, 63, lf[i]);
    if (p[P_LF_DELTA_ENABLED]) {
      int nshift = lvl >> 5;
      lvl = clip3(0, 63, lvl + (p[P_LF_INTRA_DELTA] * (1 << nshift)));
    }
    return lvl;
  }

  void edge_lf(int plane, int pass, int row, int col) {
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int dx = pass == 0, dy = pass == 1;
    int x = col * 4, y = row * 4;
    if (x >= W || y >= H || (pass == 0 && x == 0) || (pass == 1 && y == 0))
      return;   // off screen
    // every block of an intra frame is intra, with one filter level per
    // plane and direction: only the transform sizes on either side count
    int xp = x >> sx, yp = y >> sy;
    int txsz = lf_tx[plane][(size_t)(yp >> 2) * lf_stride[plane] + (xp >> 2)];
    int ptx = lf_tx[plane][(size_t)((yp >> 2) - dy) * lf_stride[plane] + (xp >> 2) - dx];
    bool is_tx_edge = pass == 0 ? (xp % TXW[txsz] == 0) : (yp % TXH[txsz] == 0);
    if (!is_tx_edge) return;
    int base = pass == 0 ? std::min(TXW[ptx], TXW[txsz]) : std::min(TXH[ptx], TXH[txsz]);
    int fsize = plane == 0 ? std::min(16, base) : std::min(8, base);
    int lvl = filter_level(plane, pass);
    if (lvl == 0) return;
    int sharp = p[P_LF_SHARPNESS];
    int shift = sharp > 4 ? 2 : (sharp > 0 ? 1 : 0);
    int limit = sharp > 0 ? clip3(1, 9 - sharp, lvl >> shift) : std::max(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit;
    int thresh = lvl >> 4;
    for (int i = 0; i < 4; i++)
      sample_filter(plane, xp + dy * i, yp + dx * i, limit, blimit, thresh, dx, dy, fsize);
  }

  void sample_filter(int plane, int x, int y, int limit, int blimit, int thresh,
                     int dx, int dy, int fsize) {
    Plane &fp = frame[plane];
    if (y >= fp.rows || x >= fp.stride) return;
    auto S = [&](int k) -> uint8_t & { return fp.at(y + dy * k, x + dx * k); };
    int q0 = S(0), q1 = S(1), q2 = S(2), q3 = S(3);
    int p0 = S(-1), p1 = S(-2), p2 = S(-3), p3 = S(-4);
    int hev = (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
    int flen = fsize == 4 ? 4 : (plane ? 6 : (fsize == 8 ? 8 : 16));
    bool mask;
    int edge = std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
    if (flen == 4) {
      mask = std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit || edge;
    } else if (flen == 6) {
      mask = std::abs(p2 - p1) > limit || std::abs(p1 - p0) > limit ||
             std::abs(q1 - q0) > limit || std::abs(q2 - q1) > limit || edge;
    } else {
      mask = std::abs(p3 - p2) > limit || std::abs(p2 - p1) > limit ||
             std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
             std::abs(q2 - q1) > limit || std::abs(q3 - q2) > limit || edge;
    }
    if (mask) return;
    int flat = 0, flat2 = 0;
    if (fsize >= 8) {
      if (flen == 6)
        flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 &&
               std::abs(p2 - p0) <= 1 && std::abs(q2 - q0) <= 1;
      else
        flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 &&
               std::abs(p2 - p0) <= 1 && std::abs(q2 - q0) <= 1 &&
               std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
    }
    if (fsize >= 16) {
      int q4 = S(4), q5 = S(5), q6 = S(6), p4 = S(-5), p5 = S(-6), p6 = S(-7);
      flat2 = std::abs(p6 - p0) <= 1 && std::abs(q6 - q0) <= 1 &&
              std::abs(p5 - p0) <= 1 && std::abs(q5 - q0) <= 1 &&
              std::abs(p4 - p0) <= 1 && std::abs(q4 - q0) <= 1;
    }
    if (fsize == 4 || !flat) {
      auto c4 = [](int v) { return clip3(-128, 127, v); };
      int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
      int f = hev ? c4(ps1 - qs1) : 0;
      f = c4(f + 3 * (qs0 - ps0));
      int f1 = c4(f + 4) >> 3, f2 = c4(f + 3) >> 3;
      S(0) = (uint8_t)(c4(qs0 - f1) + 128);
      S(-1) = (uint8_t)(c4(ps0 + f2) + 128);
      if (!hev) {
        f = round2(f1, 1);
        S(1) = (uint8_t)(c4(qs1 - f) + 128);
        S(-2) = (uint8_t)(c4(ps1 + f) + 128);
      }
    } else {
      int log2size = (fsize == 8 || !flat2) ? 3 : 4;
      int n = log2size == 4 ? 6 : (plane == 0 ? 3 : 2);
      int n2 = (log2size == 3 && plane == 0) ? 0 : 1;
      int v[16], F[16];
      for (int k = -(n + 1); k <= n; k++) v[k + 8] = S(k);
      for (int i = -n; i < n; i++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
          int pp = clip3(-(n + 1), n, i + j);
          int tap = std::abs(j) <= n2 ? 2 : 1;
          t += v[pp + 8] * tap;
        }
        F[i + 8] = round2(t, log2size);
      }
      for (int i = -n; i < n; i++) S(i) = (uint8_t)F[i + 8];
    }
  }

  // ------------------------------------------------------------ CDEF
  // 7.15: each 8x8 of the deblocked frame (kept in `deblocked`, which
  // loop restoration reads above and below its stripes) filtered along
  // its luma direction into the frame
  void cdef() {
    bool any = p[P_CDEF_BITS] != 0;
    for (int i = 0; i < 8; i++)
      any |= p[P_CDEF_Y_PRI + i] || p[P_CDEF_Y_SEC + i] ||
             p[P_CDEF_UV_PRI + i] || p[P_CDEF_UV_SEC + i];
    if (!p[P_CDEF] || !any) return;
    for (int pl = 0; pl < planes; pl++) deblocked[pl] = frame[pl].px;
    for (int8_t idx : cdef_idx) stats[S_CDEF_BLOCKS] += idx != -1;
    for (int r = 0; r < mi_rows; r += 2)
      for (int c = 0; c < mi_cols; c += 2) {
        int idx = cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)];
        if (idx == -1) continue;
        if (skips[mi_idx(r, c)] && skips[mi_idx(r + 1, c)] &&
            skips[mi_idx(r, c + 1)] && skips[mi_idx(r + 1, c + 1)])
          continue;
        cdef_block(r, c, idx);
      }
  }

  void cdef_block(int r, int c, int idx) {
    int var, ydir = cdef_direction(r, c, &var);
    int pri = p[P_CDEF_Y_PRI + idx], sec = p[P_CDEF_Y_SEC + idx];
    int dir = pri ? ydir : 0;
    int vs = (var >> 6) ? std::min(log2i(var >> 6), 12) : 0;
    pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
    int damping = p[P_CDEF_DAMPING];
    cdef_filter(0, r, c, pri, sec, damping, dir);
    if (planes == 1) return;
    pri = p[P_CDEF_UV_PRI + idx];
    sec = p[P_CDEF_UV_SEC + idx];
    dir = pri ? AV1_CDEF_UV_DIR[ssx][ssy][ydir] : 0;
    cdef_filter(1, r, c, pri, sec, damping - 1, dir);
    cdef_filter(2, r, c, pri, sec, damping - 1, dir);
  }

  int cdef_direction(int r, int c, int *var) {
    int cost[8] = {0}, partial[8][15] = {{0}};
    int x0 = c * 4, y0 = r * 4;
    const std::vector<uint8_t> &src = deblocked[0];
    int stride = frame[0].stride;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = src[(size_t)(y0 + i) * stride + x0 + j] - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    const int32_t *div = AV1_CDEF_DIV_TABLE;
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div[8];
    cost[6] *= div[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] +
                  partial[0][14 - i] * partial[0][14 - i]) * div[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] +
                  partial[4][14 - i] * partial[4][14 - i]) * div[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div[8];
    cost[4] += partial[4][7] * partial[4][7] * div[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= div[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] +
                    partial[i][10 - j] * partial[i][10 - j]) * div[2 * j + 2];
    }
    int best = 0, ydir = 0;
    for (int j = 0; j < 8; j++)
      if (cost[j] > best) {
        best = cost[j];
        ydir = j;
      }
    *var = (best - cost[(ydir + 4) & 7]) >> 10;
    return ydir;
  }

  static int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int adj = std::max(0, damping - log2i(threshold));
    int v = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -v : v;
  }

  void cdef_filter(int plane, int r, int c, int pri, int sec, int damping, int dir) {
    static const int PRI_TAPS[2][2] = {{4, 2}, {3, 3}}, SEC_TAPS[2][2] = {{2, 1}, {2, 1}};
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
    int w = 8 >> sx, h = 8 >> sy;
    const std::vector<uint8_t> &src = deblocked[plane];
    Plane &fp = frame[plane];
    // available: inside the frame's 4x4 grid (MiRows x MiCols)
    int ymax = (mi_rows * 4) >> sy, xmax = (mi_cols * 4) >> sx;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int x = src[(size_t)(y0 + i) * fp.stride + x0 + j];
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2)
            for (int t = 0; t < 3; t++) {   // the primary tap, then two secondary
              int d = t == 0 ? dir : (dir + (t == 1 ? -2 : 2)) & 7;
              int yy = y0 + i + sign * AV1_CDEF_DIRECTIONS[d][k][0];
              int xx = x0 + j + sign * AV1_CDEF_DIRECTIONS[d][k][1];
              if (yy < 0 || xx < 0 || yy >= ymax || xx >= xmax) continue;
              int pv = src[(size_t)yy * fp.stride + xx];
              if (t == 0)
                sum += PRI_TAPS[pri & 1][k] * constrain(pv - x, pri, damping);
              else
                sum += SEC_TAPS[pri & 1][k] * constrain(pv - x, sec, damping);
              mx = std::max(pv, mx);
              mn = std::min(pv, mn);
            }
        fp.at(y0 + i, x0 + j) = (uint8_t)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  // ------------------------------------------------------------ loop restoration
  std::vector<uint8_t> lr_src[3];   // the planes loop restoration filters

  // 7.17.6's get_source_sample: rows above and below the stripe come from
  // the deblocked frame (before CDEF)
  int src_sample(int plane, int x, int y, int stripe0, int stripe1, int pex, int pey) {
    x = std::max(0, std::min(pex, x));
    y = std::max(0, std::min(pey, y));
    const std::vector<uint8_t> &outside = deblocked[plane].empty() ? lr_src[plane] : deblocked[plane];
    if (y < stripe0) {
      y = std::max(stripe0 - 2, y);
      return outside[(size_t)y * frame[plane].stride + x];
    }
    if (y > stripe1) {
      y = std::min(stripe1 + 2, y);
      return outside[(size_t)y * frame[plane].stride + x];
    }
    return lr_src[plane][(size_t)y * frame[plane].stride + x];
  }

  void loop_restoration() {
    bool any = false;
    for (int pl = 0; pl < planes; pl++) any |= lr_type[pl] != RESTORE_NONE;
    if (!any) return;
    for (int pl = 0; pl < planes; pl++)
      if (lr_type[pl] != RESTORE_NONE) lr_src[pl] = frame[pl].px;
    for (int y = 0; y < H; y += 4)
      for (int x = 0; x < W; x += 4)
        for (int pl = 0; pl < planes; pl++)
          if (lr_type[pl] != RESTORE_NONE) lr_block(pl, y >> 2, x >> 2);
  }

  void lr_block(int plane, int row, int col) {
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int lumay = row * 4;
    int stripe = (lumay + 8) / 64;
    int s0 = (-8 + stripe * 64) >> sy;
    int s1 = s0 + (64 >> sy) - 1;
    int us = lr_size[plane];
    int urows = lr_units_rows[plane], ucols = lr_units_cols[plane];
    int ur = std::min(urows - 1, ((row * 4 + 8) >> sy) / us);
    int uc = std::min(ucols - 1, ((col * 4) >> sx) / us);
    int pex = round2(W, sx) - 1, pey = round2(H, sy) - 1;
    int x = (col * 4) >> sx, y = (row * 4) >> sy;
    int w = std::min(4 >> sx, pex - x + 1), h = std::min(4 >> sy, pey - y + 1);
    size_t u = (size_t)ur * ucols + uc;
    int rtype = lr_unit_type[plane][u];
    if (rtype == RESTORE_WIENER) wiener(plane, u, x, y, w, h, s0, s1, pex, pey);
    else if (rtype == RESTORE_SGRPROJ) sgr(plane, u, x, y, w, h, s0, s1, pex, pey);
  }

  void wiener(int plane, size_t u, int x, int y, int w, int h, int s0, int s1,
              int pex, int pey) {
    int vf[7], hf[7];
    for (int pass = 0; pass < 2; pass++) {
      int *f = pass == 0 ? vf : hf;
      f[3] = 128;
      for (int i = 0; i < 3; i++) {
        int c = lr_wiener[plane][u * 6 + pass * 3 + i];
        f[i] = c;
        f[6 - i] = c;
        f[3] -= 2 * c;
      }
    }
    const int r0 = 3, r1 = 11;
    int offset = 1 << (8 + 7 - r0 - 1);
    int limit = (1 << (8 + 1 + 7 - r0)) - 1;
    int inter[10][4];
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++)
          s += hf[t] * src_sample(plane, x + c + t - 3, y + r - 3, s0, s1, pex, pey);
        int v = round2(s, r0);
        inter[r][c] = clip3(-offset, limit - offset, v);
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += vf[t] * inter[r + t][c];
        frame[plane].at(y + r, x + c) = clip1(round2(s, r1));
      }
  }

  void box_filter(int plane, int x, int y, int w, int h, int set, int pass,
                  int s0, int s1, int pex, int pey, int F[4][4]) {
    int r = AV1_SGR_PARAMS[set][pass];
    int s = AV1_SGR_PARAMS[set][2 + pass];   // the scale of the pass
    int n = (2 * r + 1) * (2 * r + 1);
    int A[6][6], B[6][6];
    int one_over_n = ((1 << 12) + (n / 2)) / n;
    for (int i = -1; i < h + 1; i++)
      for (int j = -1; j < w + 1; j++) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = src_sample(plane, x + j + dx, y + i + dy, s0, s1, pex, pey);
            a += c * c;
            b += c;
          }
        int pv = std::max(0, a * n - b * b);
        int z = round2((int64_t)pv * s, 20);
        int a2;
        if (z >= 255) a2 = 256;
        else if (z == 0) a2 = 1;
        else a2 = ((z << 8) + (z / 2)) / (z + 1);
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
        A[i + 1][j + 1] = a2;
        B[i + 1][j + 1] = round2(b2, 12);
      }
    for (int i = 0; i < h; i++) {
      int shift = 5;
      if (pass == 0 && (i & 1)) shift = 4;
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int wt;
            if (pass == 0) wt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else wt = (dx == 0 || dy == 0) ? 4 : 3;
            a += wt * A[i + dy + 1][j + dx + 1];
            b += wt * B[i + dy + 1][j + dx + 1];
          }
        int v = a * lr_src[plane][(size_t)(y + i) * frame[plane].stride + x + j] + b;
        F[i][j] = round2(v, 8 + shift - 4);
      }
    }
  }

  void sgr(int plane, size_t u, int x, int y, int w, int h, int s0, int s1,
           int pex, int pey) {
    int set = lr_sgr_set[plane][u];
    int F0[4][4], F1[4][4];
    int r0 = AV1_SGR_PARAMS[set][0], r1 = AV1_SGR_PARAMS[set][1];
    if (r0) box_filter(plane, x, y, w, h, set, 0, s0, s1, pex, pey, F0);
    if (r1) box_filter(plane, x, y, w, h, set, 1, s0, s1, pex, pey, F1);
    int w0 = lr_sgr_xqd[plane][u * 2], w1 = lr_sgr_xqd[plane][u * 2 + 1];
    int w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int uu = lr_src[plane][(size_t)(y + i) * frame[plane].stride + x + j] << 4;
        int v = w1 * uu;
        v += r0 ? w0 * F0[i][j] : w0 * uu;
        v += r1 ? w2 * F1[i][j] : w2 * uu;
        frame[plane].at(y + i, x + j) = clip1(round2(v, 4 + 7));
      }
  }

  // ------------------------------------------------------------ film grain
  // 7.18.3 as dav1d 1.5.1 applies it to the output frame (fg_apply and
  // filmgrain_tmpl.c): the luma and chroma grain templates from the
  // 16-bit LFSR and the Gaussian sequence with their auto-regressive
  // filter, the scaling lookups, and 32x32 blocks per 32-row stripe with
  // each stripe's seeds, the blocks' random offsets, the overlap blending
  // and the clipping.  Chroma first: it reads the luma without grain.
  typedef int16_t Grain[74][82];
  std::vector<int16_t> grain_store;

  static int fg_random(int bits, unsigned &state) {
    unsigned r = state;
    unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    state = (r >> 1) | (bit << 15);
    return (int)((state >> (16 - bits)) & ((1u << bits) - 1));
  }
  static int fg_round2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

  void fg_template(Grain buf, const Grain luma, int plane, int w, int h, int subx, int suby) {
    unsigned seed = (unsigned)p[P_FG_SEED];
    if (plane) seed ^= plane == 2 ? 0x49d8 : 0xb524;
    int shift = 4 + p[P_FG_GRAIN_SCALE_SHIFT];
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        buf[y][x] = (int16_t)fg_round2(AV1_GAUSSIAN_SEQUENCE[fg_random(11, seed)], shift);
    int lag = p[P_FG_LAG];
    const int *coef = p + (plane == 0 ? P_FG_AR_Y : plane == 1 ? P_FG_AR_CB : P_FG_AR_CR);
    for (int y = 3; y < h; y++)
      for (int x = 3; x < w - 3; x++) {
        int sum = 0, k = 0;
        for (int dy = -lag; dy <= 0; dy++)
          for (int dx = -lag; dx <= lag; dx++) {
            if (!dx && !dy) {
              if (plane && p[P_FG_NUM_Y]) {   // the co-located luma grain
                int lx = ((x - 3) << subx) + 3, ly = ((y - 3) << suby) + 3, l = 0;
                for (int i = 0; i <= suby; i++)
                  for (int j = 0; j <= subx; j++) l += luma[ly + i][lx + j];
                sum += fg_round2(l, subx + suby) * coef[k];
              }
              dy = 1;      // the current sample ends the window
              break;
            }
            sum += coef[k++] * buf[y + dy][x + dx];
          }
        buf[y][x] = (int16_t)clip3(-128, 127, buf[y][x] + fg_round2(sum, p[P_FG_AR_SHIFT]));
      }
  }

  static void fg_scaling(const int *pts, int n, uint8_t *lut) {
    if (n == 0) {
      std::memset(lut, 0, 256);
      return;
    }
    std::memset(lut, pts[1], pts[0]);
    for (int i = 0; i < n - 1; i++) {
      int bx = pts[2 * i], by = pts[2 * i + 1], dx = pts[2 * i + 2] - bx;
      int delta = (pts[2 * i + 3] - by) * ((0x10000 + (dx >> 1)) / dx);
      for (int x = 0, d = 0x8000; x < dx; x++, d += delta) lut[bx + x] = (uint8_t)(by + (d >> 16));
    }
    int last = pts[2 * (n - 1)];
    std::memset(lut + last, pts[2 * (n - 1) + 1], 256 - last);
  }

  // one plane: 32x32 (luma) blocks, stripe by stripe
  void fg_plane(int plane, const Grain grain, const uint8_t *scaling) {
    int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    int pw = (W + sx) >> sx, overlap = p[P_FG_OVERLAP], shift = p[P_FG_SCALING_SHIFT];
    int lo = 0, hi = 255;
    if (p[P_FG_CLIP]) {
      lo = 16;
      hi = plane && !p[P_MC_IDENTITY] ? 240 : 235;
    }
    static const int WT[2][2][2] = {{{27, 17}, {17, 27}}, {{23, 22}, {0, 0}}};
    Plane &fp = frame[plane];
    Plane &luma = frame[0];
    const int *mult = p + (plane == 1 ? P_FG_CB_MULT : P_FG_CR_MULT);
    auto sample = [&](const int off[2][2], int bx, int by, int x, int y) {
      int r = off[bx][by];
      int ox = 3 + (2 >> sx) * (3 + (r >> 4)), oy = 3 + (2 >> sy) * (3 + (r & 15));
      return (int)grain[oy + y + (32 >> sy) * by][ox + x + (32 >> sx) * bx];
    };
    auto blend = [&](int old, int cur, const int *w) {
      return clip3(-128, 127, fg_round2(old * w[0] + cur * w[1], 5));
    };
    for (int row = 0; row * 32 < H; row++) {
      int bh = (std::min(32, H - row * 32) + sy) >> sy;
      int y0 = (row * 32) >> sy;
      int rows = 1 + (overlap && row > 0);
      unsigned seed[2];
      for (int i = 0; i < rows; i++) {
        seed[i] = (unsigned)p[P_FG_SEED];
        seed[i] ^= (unsigned)((((row - i) * 37 + 178) & 0xFF) << 8);
        seed[i] ^= (unsigned)(((row - i) * 173 + 105) & 0xFF);
      }
      int off[2][2] = {{0, 0}, {0, 0}};
      for (int bx = 0; bx < pw; bx += 32 >> sx) {
        int bw = std::min(32 >> sx, pw - bx);
        if (overlap && bx)
          for (int i = 0; i < rows; i++) off[1][i] = off[0][i];
        for (int i = 0; i < rows; i++) off[0][i] = fg_random(8, seed[i]);
        int ystart = overlap && row ? std::min(2 >> sy, bh) : 0;
        int xstart = overlap && bx ? std::min(2 >> sx, bw) : 0;
        auto add = [&](int x, int y, int g) {
          uint8_t &px = fp.at(y0 + y, bx + x);
          int src = px, val = src;
          if (plane) {
            int lx = (bx + x) << sx, ly = (y0 + y) << sy;
            int avg = luma.at(ly, lx);
            if (sx) avg = (avg + luma.at(ly, std::min(lx + 1, W - 1)) + 1) >> 1;
            val = avg;
            if (!p[P_FG_FROM_LUMA])
              val = clip1(((avg * mult[1] + src * mult[0]) >> 6) + mult[2]);
          }
          px = (uint8_t)clip3(lo, hi, src + fg_round2(scaling[val] * g, shift));
        };
        for (int y = ystart; y < bh; y++) {
          for (int x = xstart; x < bw; x++) add(x, y, sample(off, 0, 0, x, y));
          for (int x = 0; x < xstart; x++)
            add(x, y, blend(sample(off, 1, 0, x, y), sample(off, 0, 0, x, y), WT[sx][x]));
        }
        for (int y = 0; y < ystart; y++) {
          for (int x = xstart; x < bw; x++)
            add(x, y, blend(sample(off, 0, 1, x, y), sample(off, 0, 0, x, y), WT[sy][y]));
          for (int x = 0; x < xstart; x++) {
            int top = blend(sample(off, 1, 1, x, y), sample(off, 0, 1, x, y), WT[sx][x]);
            int cur = blend(sample(off, 1, 0, x, y), sample(off, 0, 0, x, y), WT[sx][x]);
            add(x, y, blend(top, cur, WT[sy][y]));
          }
        }
      }
    }
  }

  void film_grain() {
    if (!p[P_FG_APPLY]) return;
    int num_y = p[P_FG_NUM_Y], from_luma = p[P_FG_FROM_LUMA];
    int num_uv[2] = {p[P_FG_NUM_CB], p[P_FG_NUM_CR]};
    if (num_y > 14 || num_uv[0] > 10 || num_uv[1] > 10)
      throw std::runtime_error("film grain: too many scaling points");
    grain_store.assign(3 * sizeof(Grain) / sizeof(int16_t), 0);
    Grain *grain = reinterpret_cast<Grain *>(grain_store.data());
    fg_template(grain[0], grain[0], 0, 82, 73, 0, 0);
    uint8_t scaling[3][256];
    fg_scaling(p + P_FG_Y, num_y, scaling[0]);
    for (int pl = 1; pl < planes; pl++) {
      if (!num_uv[pl - 1] && !from_luma) continue;
      fg_template(grain[pl], grain[0], pl, ssx ? 44 : 82, ssy ? 38 : 73, ssx, ssy);
      fg_scaling(p + (pl == 1 ? P_FG_CB : P_FG_CR), num_uv[pl - 1], scaling[pl]);
      fg_plane(pl, grain[pl], from_luma ? scaling[0] : scaling[pl]);
    }
    if (num_y) fg_plane(0, grain[0], scaling[0]);
  }
};

}  // namespace

extern "C" int avrt_av1_decode(const uint8_t *data, int64_t size,
                               const int32_t *params, const int32_t *col_starts,
                               const int32_t *row_starts, const int64_t *tiles,
                               int ntiles, uint8_t *y, uint8_t *u, uint8_t *v,
                               int32_t *stats, char *err, int errlen) {
  try {
    auto *d = new Decoder();
    std::unique_ptr<Decoder> hold(d);
    d->setup(params, col_starts, row_starts);
    for (int t = 0; t < ntiles; t++) {
      int64_t num = tiles[3 * t], off = tiles[3 * t + 1], sz = tiles[3 * t + 2];
      if (off < 0 || sz <= 0 || off + sz > size)
        throw std::runtime_error("tile outside the data");
      d->decode_tile(data + off, sz, (int)num);
    }
    d->loop_filter();
    d->cdef();
    d->loop_restoration();
    d->film_grain();
    std::memcpy(stats, d->stats, sizeof(d->stats));
    uint8_t *out[3] = {y, u, v};
    for (int pl = 0; pl < d->planes; pl++) {
      Plane &fp = d->frame[pl];
      for (int r = 0; r < fp.h; r++)
        std::memcpy(out[pl] + (size_t)r * fp.w, &fp.px[(size_t)r * fp.stride], fp.w);
    }
    return 0;
  } catch (const std::exception &e) {
    std::snprintf(err, errlen, "%s", e.what());
    return -1;
  }
}

extern "C" void avrt_av1_transform(int kind, int n, int32_t *T) {
  if (kind == 3) inverse_wht(T, n);
  else inverse_1d(T, n, kind);
}
