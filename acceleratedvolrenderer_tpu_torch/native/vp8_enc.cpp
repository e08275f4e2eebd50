// The lossy VP8 key frame of a WebP as libwebp 1.6.0 encodes it under
// PIL's defaults (WebPConfigPreset(DEFAULT, 80), method 4: four segments,
// sns_strength 50, filter_strength 60, sharpness 0, one token partition,
// RD_OPT_BASIC without trellis, the token buffer, no skip flag): the
// analysis pass that sorts macroblocks into segments, then the macroblock
// loop (mode decision, quantization, reconstruction, token recording) and
// the bitstream (frame header, first partition, token partition), in
// integers as libwebp's src/enc does.
//
// utils/webp_write.py drives it in two calls, with the RGB -> YUV 4:2:0
// conversion done in numpy before them and the per-segment quantizers
// and filter levels (libwebp computes them in double) in Python between
// them:
//   avrt_vp8_analyze: each macroblock's susceptibility alpha from its DCT
//     histograms (analysis_enc.c), k-means into four segments, and each
//     segment's alpha and beta;
//   avrt_vp8_encode: with the segments' quantizers, filter levels and
//     final map, the coded frame (the VP8 chunk's payload).
// The tables of utils/vp8.py (coefficient probabilities and their update
// probabilities, intra-4 mode probabilities, quantizer steps, zigzag,
// bands, the extra-bit probabilities) come in from Python in one int32
// array, laid out as webp_write.py's _tables packs them.
//
// Compiled alone with g++ into build/native/libavrt_vp8_enc.so on first
// use (see native/__init__.py).  There is no fallback: without it writing
// .webp raises.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int BPS = 32;  // the work areas' row stride, as libwebp's
constexpr int Y_OFF = 0, U_OFF = 16, V_OFF = 16 + 8;
constexpr int I16DC16 = 0, I16TM16 = 16, I16VE16 = 16 * BPS,
              I16HE16 = 16 * BPS + 16;
constexpr int C8DC8 = 2 * 16 * BPS, C8TM8 = C8DC8 + 16,
              C8VE8 = 2 * 16 * BPS + 8 * BPS, C8HE8 = C8VE8 + 16;
constexpr int I4DC4 = 3 * 16 * BPS, I4TM4 = I4DC4 + 4, I4VE4 = I4DC4 + 8,
              I4HE4 = I4DC4 + 12, I4RD4 = I4DC4 + 16, I4VR4 = I4DC4 + 20,
              I4LD4 = I4DC4 + 24, I4VL4 = I4DC4 + 28,
              I4HD4 = 3 * 16 * BPS + 4 * BPS, I4HU4 = I4HD4 + 4,
              I4TMP = I4HD4 + 8;
constexpr int PRED_SIZE = 32 * BPS + 16 * BPS + 8 * BPS;
constexpr int YUV_SIZE = BPS * 16;

const int kI16Offsets[4] = {I16DC16, I16TM16, I16VE16, I16HE16};
const int kUVOffsets[4] = {C8DC8, C8TM8, C8VE8, C8HE8};
const int kI4Offsets[10] = {I4DC4, I4TM4, I4VE4, I4HE4, I4RD4,
                            I4VR4, I4LD4, I4VL4, I4HD4, I4HU4};
const int kScan[16] = {
    0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
    0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
    0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
    0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
const int kScanUV[8] = {0 + 0 * BPS,  4 + 0 * BPS,  0 + 4 * BPS,
                        4 + 4 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                        8 + 4 * BPS,  12 + 4 * BPS};
// the intra-4 boundary's offset of each sub-block's top-left sample
const int kTopLeftI4[16] = {17, 21, 25, 29, 13, 17, 21, 25,
                            9,  13, 17, 21, 5,  9,  13, 17};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };
constexpr int NUM_SEG = 4, NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3,
              NUM_PROBAS = 11;
constexpr int MAX_LEVEL = 2047, MAX_VARIABLE_LEVEL = 67;
constexpr int QFIX = 17;
constexpr int MAX_ALPHA = 255, ALPHA_SCALE = 2 * MAX_ALPHA;
constexpr int MAX_COEFF_THRESH = 31;
constexpr int FLATNESS_LIMIT_I16 = 0, FLATNESS_LIMIT_I4 = 3,
              FLATNESS_LIMIT_UV = 2, FLATNESS_PENALTY = 140;
constexpr int RD_DISTO_MULT = 256;
constexpr int64_t MAX_COST = 0x7fffffffffffffLL;
constexpr int MIN_COUNT = 96;  // macroblocks between probability refreshes

// libwebp's VP8EntropyCost: the cost, in 1/256 bit, of a 0 coded at
// probability p / 256
const uint16_t kEntropyCost[256] = {
    1792, 1792, 1792, 1536, 1536, 1408, 1366, 1280, 1280, 1216, 1178, 1152,
    1110, 1076, 1061, 1024, 1024, 992,  968,  951,  939,  911,  896,  878,
    871,  854,  838,  820,  811,  794,  786,  768,  768,  752,  740,  732,
    720,  709,  704,  690,  683,  672,  666,  655,  647,  640,  631,  622,
    615,  607,  598,  592,  586,  576,  572,  564,  559,  555,  547,  541,
    534,  528,  522,  512,  512,  504,  500,  494,  488,  483,  477,  473,
    467,  461,  458,  452,  448,  443,  438,  434,  427,  424,  419,  415,
    410,  406,  403,  399,  394,  390,  384,  384,  377,  374,  370,  366,
    362,  359,  355,  351,  347,  342,  342,  336,  333,  330,  326,  323,
    320,  316,  312,  308,  305,  302,  299,  296,  293,  288,  287,  283,
    280,  277,  274,  272,  268,  266,  262,  256,  256,  256,  251,  248,
    245,  242,  240,  237,  234,  232,  228,  226,  223,  221,  218,  216,
    214,  211,  208,  205,  203,  201,  198,  196,  192,  191,  188,  187,
    183,  181,  179,  176,  175,  171,  171,  168,  165,  163,  160,  159,
    156,  154,  152,  150,  148,  146,  144,  142,  139,  138,  135,  133,
    131,  128,  128,  125,  123,  121,  119,  117,  115,  113,  111,  110,
    107,  105,  103,  102,  100,  98,   96,   94,   92,   91,   89,   86,
    86,   83,   82,   80,   77,   76,   74,   73,   71,   69,   67,   66,
    64,   63,   61,   59,   57,   55,   54,   52,   51,   49,   47,   46,
    44,   43,   41,   40,   38,   36,   35,   33,   32,   30,   29,   27,
    25,   24,   22,   21,   19,   18,   16,   15,   13,   12,   10,   9,
    7,    6,    4,    3};
// the fixed costs of the intra-16 modes (the i16 flag included) and the
// chroma modes, libwebp's VP8FixedCostsI16 / VP8FixedCostsUV
const uint16_t kFixedCostsI16[4] = {663, 919, 872, 919};
const uint16_t kFixedCostsUV[4] = {302, 984, 439, 642};
// weights of the spectral distortion (kWeightY)
const uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7,
                               20, 17, 10, 4, 9,  7,  4,  2};
// quantizer rounding biases [luma-ac, luma-dc (y2), chroma][dc, ac]
const uint8_t kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};
// sharpening of the high-frequency luma coefficients
const uint8_t kFreqSharpening[16] = {0,  30, 60, 90, 30, 60, 90, 90,
                                     60, 90, 90, 90, 90, 90, 90, 90};
// for each level 1..67, the probabilities (bit i = proba i + 2) that
// code it past the zero test, and their bits
const uint16_t kLevelCodes[MAX_VARIABLE_LEVEL][2] = {
    {0x001, 0x000}, {0x007, 0x001}, {0x00f, 0x005}, {0x00f, 0x00d},
    {0x033, 0x003}, {0x033, 0x003}, {0x033, 0x023}, {0x033, 0x023},
    {0x033, 0x023}, {0x033, 0x023}, {0x0d3, 0x013}, {0x0d3, 0x013},
    {0x0d3, 0x013}, {0x0d3, 0x013}, {0x0d3, 0x013}, {0x0d3, 0x013},
    {0x0d3, 0x013}, {0x0d3, 0x013}, {0x0d3, 0x093}, {0x0d3, 0x093},
    {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093},
    {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093},
    {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093}, {0x0d3, 0x093},
    {0x0d3, 0x093}, {0x0d3, 0x093}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x053},
    {0x153, 0x053}, {0x153, 0x053}, {0x153, 0x153}};

inline int BitCost(int bit, int proba) {
  return bit ? kEntropyCost[255 - proba] : kEntropyCost[proba];
}

inline int clip(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ---------------------------------------------------------------------------
// Tables: utils/vp8.py's, unpacked from webp_write.py's int32 array, and
// the costs derived from them.

struct Tables {
  uint8_t coeffs0[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint8_t update[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint8_t bmodes[10][10][9];
  int dc[128], ac[128], ac2[128];
  int zigzag[16], bands[17];
  uint8_t cat[4][11];
  uint16_t level_fixed[2048];
  uint16_t fixed_i4[10][10][10];
};

// the cost of coding `mode` under the intra-4 probabilities p, with the
// tree of tree_enc.c's PutI4Mode
int I4ModeCost(int mode, const uint8_t* p) {
  int c = BitCost(mode != B_DC, p[0]);
  if (mode == B_DC) return c;
  c += BitCost(mode != B_TM, p[1]);
  if (mode == B_TM) return c;
  c += BitCost(mode != B_VE, p[2]);
  if (mode == B_VE) return c;
  c += BitCost(mode >= B_LD, p[3]);
  if (mode < B_LD) {
    c += BitCost(mode != B_HE, p[4]);
    if (mode != B_HE) c += BitCost(mode != B_RD, p[5]);
  } else {
    c += BitCost(mode != B_LD, p[6]);
    if (mode != B_LD) {
      c += BitCost(mode != B_VL, p[7]);
      if (mode != B_VL) c += BitCost(mode != B_HD, p[8]);
    }
  }
  return c;
}

void InitTables(Tables* t, const int32_t* src) {
  for (int k = 0; k < 2; ++k) {
    for (int ty = 0; ty < NUM_TYPES; ++ty)
      for (int b = 0; b < NUM_BANDS; ++b)
        for (int c = 0; c < NUM_CTX; ++c)
          for (int p = 0; p < NUM_PROBAS; ++p)
            (k ? t->update : t->coeffs0)[ty][b][c][p] = (uint8_t)*src++;
  }
  for (int top = 0; top < 10; ++top)
    for (int left = 0; left < 10; ++left)
      for (int i = 0; i < 9; ++i) t->bmodes[top][left][i] = (uint8_t)*src++;
  for (int i = 0; i < 128; ++i) t->dc[i] = src[i];
  src += 128;
  for (int i = 0; i < 128; ++i) {
    t->ac[i] = src[i];
    const int y2 = src[i] * 155 / 100;
    t->ac2[i] = y2 < 8 ? 8 : y2;
  }
  src += 128;
  for (int i = 0; i < 16; ++i) t->zigzag[i] = src[i];
  src += 16;
  for (int i = 0; i < 17; ++i) t->bands[i] = src[i];
  src += 17;
  const int cat_len[4] = {3, 4, 5, 11};
  for (int c = 0; c < 4; ++c) {
    for (int i = 0; i < cat_len[c]; ++i) t->cat[c][i] = (uint8_t)src[i];
    src += cat_len[c];
  }
  // VP8LevelFixedCosts: the sign and the extra bits of each level
  t->level_fixed[0] = 0;
  for (int v = 1; v < 2048; ++v) {
    int c = 256;
    if (v >= 5 && v <= 6) {
      c += BitCost(v == 6, 159);
    } else if (v >= 7 && v <= 10) {
      c += BitCost(v >= 9, 165) + BitCost(!(v & 1), 145);
    } else if (v > 10) {
      int r = v - 3, k, nb;
      if (r < 16) { r -= 8; k = 0; nb = 3; }
      else if (r < 32) { r -= 16; k = 1; nb = 4; }
      else if (r < 64) { r -= 32; k = 2; nb = 5; }
      else { r -= 64; k = 3; nb = 11; }
      for (int i = 0; i < nb; ++i)
        c += BitCost((r >> (nb - 1 - i)) & 1, t->cat[k][i]);
    }
    t->level_fixed[v] = (uint16_t)c;
  }
  // libwebp's table gives levels 9 and 10 the cost 640 (not their bits')
  t->level_fixed[9] = t->level_fixed[10] = 640;
  for (int top = 0; top < 10; ++top)
    for (int left = 0; left < 10; ++left)
      for (int m = 0; m < 10; ++m)
        t->fixed_i4[top][left][m] =
            (uint16_t)I4ModeCost(m, t->bmodes[top][left]);
}

// ---------------------------------------------------------------------------
// Transforms (dsp/enc.c)

void FTransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0];
    const int d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2];
    const int d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i];
    const int a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i];
    const int a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] =
        (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

void FTransform2(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  FTransform(src, ref, out);
  FTransform(src + 4, ref + 4, out + 16);
}

void FTransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16];
    const int a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16];
    const int a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i];
    const int a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i];
    const int a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a3 - a2) >> 1);
    out[12 + i] = (int16_t)((a0 - a1) >> 1);
  }
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

void ITransformOne(const uint8_t* ref, const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = Mul2(in[4]) - Mul1(in[12]);
    const int d = Mul1(in[4]) + Mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = Mul2(tmp[4]) - Mul1(tmp[12]);
    const int d = Mul1(tmp[4]) + Mul2(tmp[12]);
    dst[0 + i * BPS] = clip8(ref[0 + i * BPS] + ((a + d) >> 3));
    dst[1 + i * BPS] = clip8(ref[1 + i * BPS] + ((b + c) >> 3));
    dst[2 + i * BPS] = clip8(ref[2 + i * BPS] + ((b - c) >> 3));
    dst[3 + i * BPS] = clip8(ref[3 + i * BPS] + ((a - d) >> 3));
    tmp++;
  }
}

void ITransform(const uint8_t* ref, const int16_t* in, uint8_t* dst,
                int do_two) {
  ITransformOne(ref, in, dst);
  if (do_two) ITransformOne(ref + 4, in + 16, dst + 4);
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ---------------------------------------------------------------------------
// Distortion metrics

int SSE(const uint8_t* a, const uint8_t* b, int w, int h) {
  int count = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int d = (int)a[x + y * BPS] - b[x + y * BPS];
      count += d * d;
    }
  return count;
}

// the weighted sum of the absolute Hadamard coefficients of a 4x4 block
int TTransform(const uint8_t* in, const uint16_t* w) {
  int sum = 0;
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2];
    const int a1 = in[1] + in[3];
    const int a2 = in[1] - in[3];
    const int a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i];
    const int a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i];
    const int a3 = tmp[0 + i] - tmp[8 + i];
    sum += w[0] * std::abs(a0 + a1);
    sum += w[4] * std::abs(a3 + a2);
    sum += w[8] * std::abs(a3 - a2);
    sum += w[12] * std::abs(a0 - a1);
  }
  return sum;
}

int Disto4x4(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  return std::abs(TTransform(b, w) - TTransform(a, w)) >> 5;
}

int Disto16x16(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  int D = 0;
  for (int y = 0; y < 16 * BPS; y += 4 * BPS)
    for (int x = 0; x < 16; x += 4) D += Disto4x4(a + x + y, b + x + y, w);
  return D;
}

// ---------------------------------------------------------------------------
// Intra predictions (dsp/enc.c), into the prediction area's layout

void Fill(uint8_t* dst, int value, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, value, size);
}

void VerticalPred(uint8_t* dst, const uint8_t* top, int size) {
  if (top != nullptr) {
    for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, top, size);
  } else {
    Fill(dst, 127, size);
  }
}

void HorizontalPred(uint8_t* dst, const uint8_t* left, int size) {
  if (left != nullptr) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, left[j], size);
  } else {
    Fill(dst, 129, size);
  }
}

void TrueMotion(uint8_t* dst, const uint8_t* left, const uint8_t* top,
                int size) {
  if (left != nullptr) {
    if (top != nullptr) {
      for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x)
          dst[x] = clip8(top[x] + left[y] - left[-1]);
        dst += BPS;
      }
    } else {
      HorizontalPred(dst, left, size);
    }
  } else {
    // without left samples (129), TM is VE; without either, 129
    if (top != nullptr) {
      VerticalPred(dst, top, size);
    } else {
      Fill(dst, 129, size);
    }
  }
}

void DCMode(uint8_t* dst, const uint8_t* left, const uint8_t* top, int size,
            int round, int shift) {
  int DC = 0;
  if (top != nullptr) {
    for (int j = 0; j < size; ++j) DC += top[j];
    if (left != nullptr) {
      for (int j = 0; j < size; ++j) DC += left[j];
    } else {
      DC += DC;
    }
    DC = (DC + round) >> shift;
  } else if (left != nullptr) {
    for (int j = 0; j < size; ++j) DC += left[j];
    DC += DC;
    DC = (DC + round) >> shift;
  } else {
    DC = 0x80;
  }
  Fill(dst, DC, size);
}

void IntraChromaPreds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  DCMode(C8DC8 + dst, left, top, 8, 8, 4);
  VerticalPred(C8VE8 + dst, top, 8);
  HorizontalPred(C8HE8 + dst, left, 8);
  TrueMotion(C8TM8 + dst, left, top, 8);
  dst += 8;
  if (top != nullptr) top += 8;
  if (left != nullptr) left += 16;
  DCMode(C8DC8 + dst, left, top, 8, 8, 4);
  VerticalPred(C8VE8 + dst, top, 8);
  HorizontalPred(C8HE8 + dst, left, 8);
  TrueMotion(C8TM8 + dst, left, top, 8);
}

void Intra16Preds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  DCMode(I16DC16 + dst, left, top, 16, 16, 5);
  VerticalPred(I16VE16 + dst, top, 16);
  HorizontalPred(I16HE16 + dst, left, 16);
  TrueMotion(I16TM16 + dst, left, top, 16);
}

inline uint8_t Avg3(int a, int b, int c) {
  return (uint8_t)((a + 2 * b + c + 2) >> 2);
}
inline uint8_t Avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

// top[-5..-2]: the left column bottom-up, top[-1] the corner, top[0..7]
// the row above and its right
void VE4(uint8_t* dst, const uint8_t* top) {
  const uint8_t vals[4] = {Avg3(top[-1], top[0], top[1]),
                           Avg3(top[0], top[1], top[2]),
                           Avg3(top[1], top[2], top[3]),
                           Avg3(top[2], top[3], top[4])};
  for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
}

void HE4(uint8_t* dst, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  memset(dst + 0 * BPS, Avg3(X, I, J), 4);
  memset(dst + 1 * BPS, Avg3(I, J, K), 4);
  memset(dst + 2 * BPS, Avg3(J, K, L), 4);
  memset(dst + 3 * BPS, Avg3(K, L, L), 4);
}

void DC4(uint8_t* dst, const uint8_t* top) {
  uint32_t dc = 4;
  for (int i = 0; i < 4; ++i) dc += top[i] + top[-5 + i];
  Fill(dst, dc >> 3, 4);
}

void RD4(uint8_t* dst, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  DST(0, 3) = Avg3(J, K, L);
  DST(0, 2) = DST(1, 3) = Avg3(I, J, K);
  DST(0, 1) = DST(1, 2) = DST(2, 3) = Avg3(X, I, J);
  DST(0, 0) = DST(1, 1) = DST(2, 2) = DST(3, 3) = Avg3(A, X, I);
  DST(1, 0) = DST(2, 1) = DST(3, 2) = Avg3(B, A, X);
  DST(2, 0) = DST(3, 1) = Avg3(C, B, A);
  DST(3, 0) = Avg3(D, C, B);
}

void LD4(uint8_t* dst, const uint8_t* top) {
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  DST(0, 0) = Avg3(A, B, C);
  DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
  DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
  DST(3, 3) = Avg3(G, H, H);
}

void VR4(uint8_t* dst, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  DST(0, 0) = DST(1, 2) = Avg2(X, A);
  DST(1, 0) = DST(2, 2) = Avg2(A, B);
  DST(2, 0) = DST(3, 2) = Avg2(B, C);
  DST(3, 0) = Avg2(C, D);
  DST(0, 3) = Avg3(K, J, I);
  DST(0, 2) = Avg3(J, I, X);
  DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
  DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
  DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
  DST(3, 1) = Avg3(B, C, D);
}

void VL4(uint8_t* dst, const uint8_t* top) {
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  DST(0, 0) = Avg2(A, B);
  DST(1, 0) = DST(0, 2) = Avg2(B, C);
  DST(2, 0) = DST(1, 2) = Avg2(C, D);
  DST(3, 0) = DST(2, 2) = Avg2(D, E);
  DST(0, 1) = Avg3(A, B, C);
  DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
  DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
  DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
  DST(3, 2) = Avg3(E, F, G);
  DST(3, 3) = Avg3(F, G, H);
}

void HU4(uint8_t* dst, const uint8_t* top) {
  const int I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  DST(0, 0) = Avg2(I, J);
  DST(2, 0) = DST(0, 1) = Avg2(J, K);
  DST(2, 1) = DST(0, 2) = Avg2(K, L);
  DST(1, 0) = Avg3(I, J, K);
  DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
  DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
}

void HD4(uint8_t* dst, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  const int A = top[0], B = top[1], C = top[2];
  DST(0, 0) = DST(2, 1) = Avg2(I, X);
  DST(0, 1) = DST(2, 2) = Avg2(J, I);
  DST(0, 2) = DST(2, 3) = Avg2(K, J);
  DST(0, 3) = Avg2(L, K);
  DST(3, 0) = Avg3(A, B, C);
  DST(2, 0) = Avg3(X, A, B);
  DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
  DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
  DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
  DST(1, 3) = Avg3(L, K, J);
}

void TM4(uint8_t* dst, const uint8_t* top) {
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) dst[x] = clip8(top[x] + top[-2 - y] - top[-1]);
    dst += BPS;
  }
}
#undef DST

void Intra4Preds(uint8_t* dst, const uint8_t* top) {
  DC4(I4DC4 + dst, top);
  TM4(I4TM4 + dst, top);
  VE4(I4VE4 + dst, top);
  HE4(I4HE4 + dst, top);
  RD4(I4RD4 + dst, top);
  VR4(I4VR4 + dst, top);
  LD4(I4LD4 + dst, top);
  VL4(I4VL4 + dst, top);
  HD4(I4HD4 + dst, top);
  HU4(I4HU4 + dst, top);
}

// ---------------------------------------------------------------------------
// Quantization (quant_enc.c, dsp/enc.c)

struct Matrix {
  uint16_t q[16], iq[16];
  uint32_t bias[16], zthresh[16];
  uint16_t sharpen[16];
};

struct Segment {
  int quant = 0, fstrength = 0;
  Matrix y1, y2, uv;
  int lambda_i4 = 0, lambda_i16 = 0, lambda_uv = 0, lambda_mode = 0;
  int tlambda = 0;
  int min_disto = 0, max_edge = 0;
};

inline int QuantDiv(uint32_t n, uint32_t iq, uint32_t b) {
  return (int)(n * iq + b) >> QFIX;
}

// returns the average quantizer of the matrix
int ExpandMatrix(Matrix* m, int type) {
  for (int i = 0; i < 2; ++i) {
    const int bias = kBiasMatrices[type][i > 0];
    m->iq[i] = (uint16_t)((1 << QFIX) / m->q[i]);
    m->bias[i] = (uint32_t)bias << (QFIX - 8);
    m->zthresh[i] = ((1 << QFIX) - 1 - m->bias[i]) / m->iq[i];
  }
  for (int i = 2; i < 16; ++i) {
    m->q[i] = m->q[1];
    m->iq[i] = m->iq[1];
    m->bias[i] = m->bias[1];
    m->zthresh[i] = m->zthresh[1];
  }
  int sum = 0;
  for (int i = 0; i < 16; ++i) {
    m->sharpen[i] =
        type == 0 ? (uint16_t)((kFreqSharpening[i] * m->q[i]) >> 11) : 0;
    sum += m->q[i];
  }
  return (sum + 8) >> 4;
}

// in[]: coefficients in raster order, replaced by their dequantized
// values; out[]: the levels in zigzag order.  Returns whether any is
// non-zero.
int QuantizeBlock(int16_t in[16], int16_t out[16], const Matrix* mtx,
                  const int* zigzag) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = zigzag[n];
    const int sign = in[j] < 0;
    const uint32_t coeff = (sign ? -in[j] : in[j]) + mtx->sharpen[j];
    if (coeff > mtx->zthresh[j]) {
      const uint32_t Q = mtx->q[j];
      int level = QuantDiv(coeff, mtx->iq[j], mtx->bias[j]);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = (int16_t)(level * (int)Q);
      out[n] = (int16_t)level;
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}

// ---------------------------------------------------------------------------
// The boolean encoder (utils/bit_writer_utils.c)

struct BitWriter {
  int32_t range = 255 - 1;
  int32_t value = 0;
  int run = 0;
  int nb_bits = -8;
  std::vector<uint8_t> buf;

  void Flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;
      if (run > 0) {
        const uint8_t v = (bits & 0x100) ? 0x00 : 0xff;
        for (; run > 0; --run) buf.push_back(v);
      }
      buf.push_back((uint8_t)(bits & 0xff));
    } else {
      run++;  // 0xff waits for a possible carry
    }
  }

  void Renorm() {
    if (range < 127) {
      // shift = 7 - floor(log2(range + 1)); range = ((range + 1) << shift) - 1
      int shift = 0;
      while (((range + 1) << shift) < 128) ++shift;
      range = ((range + 1) << shift) - 1;
      value <<= shift;
      nb_bits += shift;
      if (nb_bits > 0) Flush();
    }
  }

  int PutBit(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    Renorm();
    return bit;
  }

  int PutBitUniform(int bit) {
    const int split = range >> 1;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    Renorm();
    return bit;
  }

  void PutBits(uint32_t v, int nb) {
    for (uint32_t mask = 1u << (nb - 1); mask; mask >>= 1)
      PutBitUniform((v & mask) != 0);
  }

  void PutSignedBits(int v, int nb) {
    if (!PutBitUniform(v != 0)) return;
    if (v < 0) {
      PutBits(((uint32_t)(-v) << 1) | 1, nb + 1);
    } else {
      PutBits((uint32_t)v << 1, nb + 1);
    }
  }

  void Finish() {
    PutBits(0, 9 - nb_bits);
    nb_bits = 0;
    Flush();
  }
};

// ---------------------------------------------------------------------------
// The encoder's state

struct ModeScore {
  int64_t D, SD, H, R, score;
  int16_t y_dc_levels[16];
  int16_t y_ac_levels[16][16];
  int16_t uv_levels[4 + 4][16];
  int mode_i16;
  uint8_t modes_i4[16];
  int mode_uv;
  uint32_t nz;
  int8_t derr[2][3];
};

void InitScore(ModeScore* rd) {
  rd->D = rd->SD = rd->R = rd->H = 0;
  rd->nz = 0;
  rd->score = MAX_COST;
}

void CopyScore(ModeScore* dst, const ModeScore* src) {
  dst->D = src->D;
  dst->SD = src->SD;
  dst->R = src->R;
  dst->H = src->H;
  dst->nz = src->nz;
  dst->score = src->score;
}

void AddScore(ModeScore* dst, const ModeScore* src) {
  dst->D += src->D;
  dst->SD += src->SD;
  dst->R += src->R;
  dst->H += src->H;
  dst->nz |= src->nz;
  dst->score += src->score;
}

inline void SetRDScore(int lambda, ModeScore* rd) {
  rd->score = (rd->R + rd->H) * lambda + RD_DISTO_MULT * (rd->D + rd->SD);
}

struct MBInfo {
  uint8_t type = 1, uv_mode = 0, segment = 0;
  int alpha = 0;
};

struct Residual {
  int first, last, coeff_type;
  const int16_t* coeffs;
};

typedef uint32_t proba_t;  // bit count (low 16 bits) and total (high 16)

struct Proba {
  uint8_t segments[3];
  uint8_t coeffs[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  proba_t stats[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  uint16_t level_cost[NUM_TYPES][NUM_BANDS][NUM_CTX][MAX_VARIABLE_LEVEL + 1];
  int dirty;
};

constexpr uint32_t FIXED_PROBA_BIT = 1u << 14;

struct Encoder {
  const Tables* T;
  int width, height, mb_w, mb_h;
  const uint8_t *ysrc, *usrc, *vsrc;
  int y_stride, uv_stride;
  int num_segments = NUM_SEG;
  int update_map = 1;
  Segment dqm[NUM_SEG];
  int base_quant = 0, dq_uv_dc = 0, dq_uv_ac = 0;
  int filter_level = 0;
  std::vector<MBInfo> mb_info;
  int preds_w;
  std::vector<uint8_t> preds_mem;
  uint8_t* preds;  // preds_mem + preds_w + 1: the modes of each 4x4 block
  std::vector<uint32_t> nz_mem;
  uint32_t* nz;  // nz_mem + 1: each column's packed non-zero flags
  std::vector<uint8_t> y_top, uv_top;
  std::vector<int8_t> top_derr;  // [mb_w][2][2]
  Proba proba;
  std::vector<uint16_t> tokens;
  int max_i4_header_bits = 256 * 16 * 16;
};

// the macroblock iterator (iterator_enc.c)
struct Iterator {
  Encoder* enc;
  int x, y;
  alignas(16) uint8_t yuv_in[YUV_SIZE];
  alignas(16) uint8_t yuv_out_a[YUV_SIZE];
  alignas(16) uint8_t yuv_out_b[YUV_SIZE];
  alignas(16) uint8_t yuv_p[PRED_SIZE];
  uint8_t* yuv_out;
  uint8_t* yuv_out2;
  uint8_t* preds;
  uint32_t* nz;
  MBInfo* mb;
  uint8_t i4_boundary[40];
  uint8_t* i4_top;
  int i4;
  int top_nz[9], left_nz[9];
  // y_left[-1] is the corner; u_left = y_left + 32, v_left = u_left + 16,
  // as libwebp lays them out (the chroma preds read left + 16 for V)
  uint8_t left_mem[80];
  uint8_t* y_left;
  uint8_t* u_left;
  uint8_t* v_left;
  uint8_t* y_top;
  uint8_t* uv_top;
  int8_t left_derr[2][2];
  int8_t* top_derr;
  int count_down;

  explicit Iterator(Encoder* e) : enc(e) {
    memset(left_mem, 0, sizeof(left_mem));
    y_left = left_mem + 1;
    u_left = y_left + 32;
    v_left = u_left + 16;
    yuv_out = yuv_out_a;
    yuv_out2 = yuv_out_b;
    memset(yuv_in, 0, sizeof(yuv_in));
    memset(yuv_out_a, 0, sizeof(yuv_out_a));
    memset(yuv_out_b, 0, sizeof(yuv_out_b));
    memset(yuv_p, 0, sizeof(yuv_p));
    top_derr = nullptr;
    Reset();
  }

  void InitLeft() {
    y_left[-1] = u_left[-1] = v_left[-1] = (y > 0) ? 129 : 127;
    memset(y_left, 129, 16);
    memset(u_left, 129, 8);
    memset(v_left, 129, 8);
    left_nz[8] = 0;
    memset(left_derr, 0, sizeof(left_derr));
  }

  void InitTop() {
    const size_t top_size = enc->mb_w * 16;
    memset(enc->y_top.data(), 127, top_size);
    memset(enc->uv_top.data(), 127, top_size);
    memset(enc->nz, 0, enc->mb_w * sizeof(uint32_t));
    memset(enc->top_derr.data(), 0, enc->top_derr.size());
  }

  void SetRow(int row) {
    x = 0;
    y = row;
    preds = enc->preds + row * 4 * enc->preds_w;
    nz = enc->nz;
    mb = enc->mb_info.data() + row * enc->mb_w;
    y_top = enc->y_top.data();
    uv_top = enc->uv_top.data();
    InitLeft();
  }

  void Reset() {
    SetRow(0);
    count_down = enc->mb_w * enc->mb_h;
    InitTop();
  }

  int Next() {
    if (++x == enc->mb_w) {
      SetRow(++y);
    } else {
      preds += 4;
      mb += 1;
      nz += 1;
      y_top += 16;
      uv_top += 16;
    }
    return 0 < --count_down;
  }

  static void ImportBlock(const uint8_t* src, int src_stride, uint8_t* dst,
                          int w, int h, int size) {
    int i;
    for (i = 0; i < h; ++i) {
      memcpy(dst, src, w);
      if (w < size) memset(dst + w, dst[w - 1], size - w);
      dst += BPS;
      src += src_stride;
    }
    for (i = h; i < size; ++i) {
      memcpy(dst, dst - BPS, size);
      dst += BPS;
    }
  }

  static void ImportLine(const uint8_t* src, int src_stride, uint8_t* dst,
                         int len, int total_len) {
    int i;
    for (i = 0; i < len; ++i, src += src_stride) dst[i] = *src;
    for (; i < total_len; ++i) dst[i] = dst[len - 1];
  }

  // the source macroblock; with tmp_32, also its source boundary (the
  // analysis pass pretends the reconstruction is lossless)
  void Import(uint8_t* tmp_32) {
    const Encoder* e = enc;
    const uint8_t* ys = e->ysrc + (y * e->y_stride + x) * 16;
    const uint8_t* us = e->usrc + (y * e->uv_stride + x) * 8;
    const uint8_t* vs = e->vsrc + (y * e->uv_stride + x) * 8;
    const int w = std::min(e->width - x * 16, 16);
    const int h = std::min(e->height - y * 16, 16);
    const int uv_w = (w + 1) >> 1, uv_h = (h + 1) >> 1;
    ImportBlock(ys, e->y_stride, yuv_in + Y_OFF, w, h, 16);
    ImportBlock(us, e->uv_stride, yuv_in + U_OFF, uv_w, uv_h, 8);
    ImportBlock(vs, e->uv_stride, yuv_in + V_OFF, uv_w, uv_h, 8);
    if (tmp_32 == nullptr) return;
    if (x == 0) {
      InitLeft();
    } else {
      if (y == 0) {
        y_left[-1] = u_left[-1] = v_left[-1] = 127;
      } else {
        y_left[-1] = ys[-1 - e->y_stride];
        u_left[-1] = us[-1 - e->uv_stride];
        v_left[-1] = vs[-1 - e->uv_stride];
      }
      ImportLine(ys - 1, e->y_stride, y_left, h, 16);
      ImportLine(us - 1, e->uv_stride, u_left, uv_h, 8);
      ImportLine(vs - 1, e->uv_stride, v_left, uv_h, 8);
    }
    y_top = tmp_32 + 0;
    uv_top = tmp_32 + 16;
    if (y == 0) {
      memset(tmp_32, 127, 32);
    } else {
      ImportLine(ys - e->y_stride, 1, tmp_32, w, 16);
      ImportLine(us - e->uv_stride, 1, tmp_32 + 16, uv_w, 8);
      ImportLine(vs - e->uv_stride, 1, tmp_32 + 16 + 8, uv_w, 8);
    }
  }

  void NzToBytes() {
    const uint32_t tnz = nz[0], lnz = nz[-1];
    auto BIT = [](uint32_t v, int b) { return (int)((v >> b) & 1); };
    top_nz[0] = BIT(tnz, 12);
    top_nz[1] = BIT(tnz, 13);
    top_nz[2] = BIT(tnz, 14);
    top_nz[3] = BIT(tnz, 15);
    top_nz[4] = BIT(tnz, 18);
    top_nz[5] = BIT(tnz, 19);
    top_nz[6] = BIT(tnz, 22);
    top_nz[7] = BIT(tnz, 23);
    top_nz[8] = BIT(tnz, 24);
    left_nz[0] = BIT(lnz, 3);
    left_nz[1] = BIT(lnz, 7);
    left_nz[2] = BIT(lnz, 11);
    left_nz[3] = BIT(lnz, 15);
    left_nz[4] = BIT(lnz, 17);
    left_nz[5] = BIT(lnz, 19);
    left_nz[6] = BIT(lnz, 21);
    left_nz[7] = BIT(lnz, 23);
    // left_nz[8], the left DC, is kept across the row
  }

  void BytesToNz() {
    uint32_t v = 0;
    v |= (top_nz[0] << 12) | (top_nz[1] << 13);
    v |= (top_nz[2] << 14) | (top_nz[3] << 15);
    v |= (top_nz[4] << 18) | (top_nz[5] << 19);
    v |= (top_nz[6] << 22) | (top_nz[7] << 23);
    v |= (top_nz[8] << 24);
    v |= (left_nz[0] << 3) | (left_nz[1] << 7);
    v |= (left_nz[2] << 11);
    v |= (left_nz[4] << 17) | (left_nz[6] << 21);
    *nz = v;
  }

  void SetIntra16Mode(int mode) {
    uint8_t* p = preds;
    for (int i = 0; i < 4; ++i) {
      memset(p, mode, 4);
      p += enc->preds_w;
    }
    mb->type = 1;
  }

  void SetIntra4Mode(const uint8_t* modes) {
    uint8_t* p = preds;
    for (int i = 4; i > 0; --i) {
      memcpy(p, modes, 4);
      p += enc->preds_w;
      modes += 4;
    }
    mb->type = 0;
  }

  void MakeLuma16Preds() {
    Intra16Preds(yuv_p, x ? y_left : nullptr, y ? y_top : nullptr);
  }

  void MakeChroma8Preds() {
    IntraChromaPreds(yuv_p, x ? u_left : nullptr, y ? uv_top : nullptr);
  }

  void MakeIntra4Preds() { Intra4Preds(yuv_p, i4_top); }

  void StartI4() {
    i4 = 0;
    i4_top = i4_boundary + kTopLeftI4[0];
    for (int i = 0; i < 17; ++i) i4_boundary[i] = y_left[15 - i];
    for (int i = 0; i < 16; ++i) i4_boundary[17 + i] = y_top[i];
    if (x < enc->mb_w - 1) {
      for (int i = 16; i < 16 + 4; ++i) i4_boundary[17 + i] = y_top[i];
    } else {  // the picture's right edge: the last sample four times
      for (int i = 16; i < 16 + 4; ++i)
        i4_boundary[17 + i] = i4_boundary[17 + 15];
    }
    NzToBytes();
  }

  int RotateI4(const uint8_t* out) {
    const uint8_t* blk = out + kScan[i4];
    uint8_t* top = i4_top;
    for (int i = 0; i <= 3; ++i) top[-4 + i] = blk[i + 3 * BPS];
    if ((i4 & 3) != 3) {
      for (int i = 0; i <= 2; ++i) top[i] = blk[3 + (2 - i) * BPS];
    } else {
      for (int i = 0; i <= 3; ++i) top[i] = top[i + 4];
    }
    ++i4;
    if (i4 == 16) return 0;
    i4_top = i4_boundary + kTopLeftI4[i4];
    return 1;
  }

  void SaveBoundary() {
    const uint8_t* ysrc = yuv_out + Y_OFF;
    const uint8_t* uvsrc = yuv_out + U_OFF;
    if (x < enc->mb_w - 1) {
      for (int i = 0; i < 16; ++i) y_left[i] = ysrc[15 + i * BPS];
      for (int i = 0; i < 8; ++i) {
        u_left[i] = uvsrc[7 + i * BPS];
        v_left[i] = uvsrc[15 + i * BPS];
      }
      y_left[-1] = y_top[15];
      u_left[-1] = uv_top[0 + 7];
      v_left[-1] = uv_top[8 + 7];
    }
    if (y < enc->mb_h - 1) {
      memcpy(y_top, ysrc + 15 * BPS, 16);
      memcpy(uv_top, uvsrc + 7 * BPS, 8 + 8);
    }
  }

  void SwapOut() { std::swap(yuv_out, yuv_out2); }
};

// ---------------------------------------------------------------------------
// Analysis (analysis_enc.c)

struct Histogram {
  int max_value, last_non_zero;
};

void CollectHistogram(const uint8_t* ref, const uint8_t* pred, int start,
                      int end, Histogram* histo) {
  static const int kDspScan[16 + 4 + 4] = {
      0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
      0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
      0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
      0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS,
      0 + 0 * BPS,  4 + 0 * BPS,  0 + 4 * BPS,  4 + 4 * BPS,
      8 + 0 * BPS,  12 + 0 * BPS, 8 + 4 * BPS,  12 + 4 * BPS};
  int distribution[MAX_COEFF_THRESH + 1] = {0};
  for (int j = start; j < end; ++j) {
    int16_t out[16];
    FTransform(ref + kDspScan[j], pred + kDspScan[j], out);
    for (int k = 0; k < 16; ++k) {
      const int v = std::abs(out[k]) >> 3;
      ++distribution[v > MAX_COEFF_THRESH ? MAX_COEFF_THRESH : v];
    }
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= MAX_COEFF_THRESH; ++k) {
    const int value = distribution[k];
    if (value > 0) {
      if (value > max_value) max_value = value;
      last_non_zero = k;
    }
  }
  histo->max_value = max_value;
  histo->last_non_zero = last_non_zero;
}

int GetAlpha(const Histogram& h) {
  return (h.max_value > 1) ? ALPHA_SCALE * h.last_non_zero / h.max_value : 0;
}

// the largest alpha of the DC and TM predictions of the luma
// (MBAnalyzeBestIntra16Mode) or of the chroma (MBAnalyzeBestUVMode); the
// modes they pick there are decided again by the main loop
int AnalyzeBestAlpha(Iterator* it, int chroma) {
  int best_alpha = -1;
  if (chroma) {
    it->MakeChroma8Preds();
  } else {
    it->MakeLuma16Preds();
  }
  for (int mode = 0; mode < 2; ++mode) {
    Histogram histo;
    if (chroma) {
      CollectHistogram(it->yuv_in + U_OFF, it->yuv_p + kUVOffsets[mode], 16,
                       16 + 4 + 4, &histo);
    } else {
      CollectHistogram(it->yuv_in + Y_OFF, it->yuv_p + kI16Offsets[mode], 0,
                       16, &histo);
    }
    const int alpha = GetAlpha(histo);
    if (alpha > best_alpha) best_alpha = alpha;
  }
  return best_alpha;
}

// k-means of the macroblocks' alphas into the segments (AssignSegments);
// out: each segment's alpha and beta (SetSegmentAlphas)
void AssignSegments(Encoder* enc, const int alphas[MAX_ALPHA + 1],
                    int seg_alpha[NUM_SEG], int seg_beta[NUM_SEG]) {
  const int nb = enc->num_segments;
  int centers[NUM_SEG];
  int weighted_average = 0;
  int map[MAX_ALPHA + 1];
  int accum[NUM_SEG], dist_accum[NUM_SEG];
  int n, k, a;
  for (n = 0; n <= MAX_ALPHA && alphas[n] == 0; ++n) {
  }
  const int min_a = n;
  for (n = MAX_ALPHA; n > min_a && alphas[n] == 0; --n) {
  }
  const int max_a = n;
  const int range_a = max_a - min_a;
  for (k = 0, n = 1; k < nb; ++k, n += 2)
    centers[k] = min_a + (n * range_a) / (2 * nb);
  for (k = 0; k < 6; ++k) {
    for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
    n = 0;
    for (a = min_a; a <= max_a; ++a) {
      if (alphas[a]) {
        while (n + 1 < nb &&
               std::abs(a - centers[n + 1]) < std::abs(a - centers[n])) {
          n++;
        }
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
    }
    int displaced = 0, total_weight = 0;
    weighted_average = 0;
    for (n = 0; n < nb; ++n) {
      if (accum[n]) {
        const int new_center = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += std::abs(centers[n] - new_center);
        centers[n] = new_center;
        weighted_average += new_center * accum[n];
        total_weight += accum[n];
      }
    }
    weighted_average = (weighted_average + total_weight / 2) / total_weight;
    if (displaced < 5) break;
  }
  for (n = 0; n < enc->mb_w * enc->mb_h; ++n) {
    MBInfo* mb = &enc->mb_info[n];
    mb->segment = (uint8_t)map[mb->alpha];
    mb->alpha = centers[map[mb->alpha]];
  }
  int mn = centers[0], mx = centers[0];
  if (nb > 1) {
    for (n = 0; n < nb; ++n) {
      if (mn > centers[n]) mn = centers[n];
      if (mx < centers[n]) mx = centers[n];
    }
  }
  if (mx == mn) mx = mn + 1;
  for (n = 0; n < nb; ++n) {
    const int alpha = 255 * (centers[n] - weighted_average) / (mx - mn);
    const int beta = 255 * (centers[n] - mn) / (mx - mn);
    seg_alpha[n] = clip(alpha, -127, 127);
    seg_beta[n] = clip(beta, 0, 255);
  }
}

// ---------------------------------------------------------------------------
// Costs (cost_enc.c)

void CalculateLevelCosts(Proba* proba) {
  if (!proba->dirty) return;
  for (int ctype = 0; ctype < NUM_TYPES; ++ctype) {
    for (int band = 0; band < NUM_BANDS; ++band) {
      for (int ctx = 0; ctx < NUM_CTX; ++ctx) {
        const uint8_t* p = proba->coeffs[ctype][band][ctx];
        uint16_t* table = proba->level_cost[ctype][band][ctx];
        const int cost0 = (ctx > 0) ? BitCost(1, p[0]) : 0;
        const int cost_base = BitCost(1, p[1]) + cost0;
        table[0] = (uint16_t)(BitCost(0, p[1]) + cost0);
        for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
          int pattern = kLevelCodes[v - 1][0];
          int bits = kLevelCodes[v - 1][1];
          int cost = 0;
          for (int i = 2; pattern; ++i) {
            if (pattern & 1) cost += BitCost(bits & 1, p[i]);
            bits >>= 1;
            pattern >>= 1;
          }
          table[v] = (uint16_t)(cost_base + cost);
        }
      }
    }
  }
  proba->dirty = 0;
}

inline int LevelCost(const Tables* T, const uint16_t* table, int level) {
  return T->level_fixed[level] +
         table[level > MAX_VARIABLE_LEVEL ? MAX_VARIABLE_LEVEL : level];
}

void SetResidualCoeffs(const int16_t* coeffs, Residual* res) {
  res->last = -1;
  for (int n = 15; n >= 0; --n) {
    if (coeffs[n]) {
      res->last = n;
      break;
    }
  }
  res->coeffs = coeffs;
}

int GetResidualCost(const Encoder* enc, int ctx0, const Residual* res) {
  const Tables* T = enc->T;
  const int type = res->coeff_type;
  int n = res->first;
  const int p0 = enc->proba.coeffs[type][n][ctx0][0];
  const uint16_t* t = enc->proba.level_cost[type][T->bands[n]][ctx0];
  int cost = (ctx0 == 0) ? BitCost(1, p0) : 0;
  if (res->last < 0) return BitCost(0, p0);
  for (; n < res->last; ++n) {
    const int v = std::abs(res->coeffs[n]);
    const int ctx = (v >= 2) ? 2 : v;
    cost += LevelCost(T, t, v);
    t = enc->proba.level_cost[type][T->bands[n + 1]][ctx];
  }
  {
    const int v = std::abs(res->coeffs[n]);
    cost += LevelCost(T, t, v);
    if (n < 15) {
      const int b = T->bands[n + 1];
      const int ctx = (v == 1) ? 1 : 2;
      cost += BitCost(0, enc->proba.coeffs[type][b][ctx][0]);
    }
  }
  return cost;
}

int GetCostLuma4(Iterator* it, const int16_t levels[16]) {
  const int x = it->i4 & 3, y = it->i4 >> 2;
  Residual res = {0, -1, 3, nullptr};
  SetResidualCoeffs(levels, &res);
  return GetResidualCost(it->enc, it->top_nz[x] + it->left_nz[y], &res);
}

int GetCostLuma16(Iterator* it, const ModeScore* rd) {
  int R = 0;
  it->NzToBytes();
  Residual res = {0, -1, 1, nullptr};
  SetResidualCoeffs(rd->y_dc_levels, &res);
  R += GetResidualCost(it->enc, it->top_nz[8] + it->left_nz[8], &res);
  res = {1, -1, 0, nullptr};
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd->y_ac_levels[x + y * 4], &res);
      R += GetResidualCost(it->enc, ctx, &res);
      it->top_nz[x] = it->left_nz[y] = (res.last >= 0);
    }
  }
  return R;
}

int GetCostUV(Iterator* it, const ModeScore* rd) {
  int R = 0;
  it->NzToBytes();
  Residual res = {0, -1, 2, nullptr};
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd->uv_levels[ch * 2 + x + y * 2], &res);
        R += GetResidualCost(it->enc, ctx, &res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] = (res.last >= 0);
      }
    }
  }
  return R;
}

// ---------------------------------------------------------------------------
// Mode decision (quant_enc.c, RD_OPT_BASIC)

inline int Mult8b(int a, int b) { return (a * b + 128) >> 8; }

int IsFlat(const int16_t* levels, int num_blocks, int thresh) {
  int score = 0;
  while (num_blocks-- > 0) {
    for (int i = 1; i < 16; ++i) {
      score += (levels[i] != 0);
      if (score > thresh) return 0;
    }
    levels += 16;
  }
  return 1;
}

int IsFlatSource16(const uint8_t* src) {
  const uint8_t v = src[0];
  for (int i = 0; i < 16; ++i) {
    for (int j = 0; j < 16; ++j)
      if (src[j] != v) return 0;
    src += BPS;
  }
  return 1;
}

int ReconstructIntra16(Iterator* it, ModeScore* rd, uint8_t* yuv_out,
                       int mode) {
  const Encoder* enc = it->enc;
  const uint8_t* ref = it->yuv_p + kI16Offsets[mode];
  const uint8_t* src = it->yuv_in + Y_OFF;
  const Segment* dqm = &enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[16][16], dc_tmp[16];
  for (int n = 0; n < 16; n += 2)
    FTransform2(src + kScan[n], ref + kScan[n], tmp[n]);
  FTransformWHT(tmp[0], dc_tmp);
  nz |= QuantizeBlock(dc_tmp, rd->y_dc_levels, &dqm->y2, enc->T->zigzag) << 24;
  for (int n = 0; n < 16; n += 2) {
    tmp[n][0] = tmp[n + 1][0] = 0;
    nz |= QuantizeBlock(tmp[n], rd->y_ac_levels[n], &dqm->y1, enc->T->zigzag)
          << n;
    nz |= QuantizeBlock(tmp[n + 1], rd->y_ac_levels[n + 1], &dqm->y1,
                        enc->T->zigzag)
          << (n + 1);
  }
  TransformWHT(dc_tmp, tmp[0]);
  for (int n = 0; n < 16; n += 2)
    ITransform(ref + kScan[n], tmp[n], yuv_out + kScan[n], 1);
  return nz;
}

int ReconstructIntra4(Iterator* it, int16_t levels[16], const uint8_t* src,
                      uint8_t* yuv_out, int mode) {
  const Encoder* enc = it->enc;
  const uint8_t* ref = it->yuv_p + kI4Offsets[mode];
  const Segment* dqm = &enc->dqm[it->mb->segment];
  int16_t tmp[16];
  FTransform(src, ref, tmp);
  const int nz = QuantizeBlock(tmp, levels, &dqm->y1, enc->T->zigzag);
  ITransform(ref, tmp, yuv_out, 0);
  return nz;
}

// chroma DC error diffusion (quant_enc.c, libwebp's quality <= 98)
constexpr int C1 = 7, C2 = 8, DSHIFT = 4, DSCALE = 1;

int QuantizeSingle(int16_t* v, const Matrix* mtx) {
  int V = *v;
  const int sign = (V < 0);
  if (sign) V = -V;
  if (V > (int)mtx->zthresh[0]) {
    const int qV = QuantDiv(V, mtx->iq[0], mtx->bias[0]) * mtx->q[0];
    const int err = V - qV;
    *v = (int16_t)(sign ? -qV : qV);
    return (sign ? -err : err) >> DSCALE;
  }
  *v = 0;
  return (sign ? -V : V) >> DSCALE;
}

void CorrectDCValues(const Iterator* it, const Matrix* mtx,
                     int16_t tmp[][16], ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    const int8_t* top = it->top_derr + ch * 2;
    const int8_t* left = it->left_derr[ch];
    int16_t(*c)[16] = &tmp[ch * 4];
    c[0][0] += (C1 * top[0] + C2 * left[0]) >> (DSHIFT - DSCALE);
    const int err0 = QuantizeSingle(&c[0][0], mtx);
    c[1][0] += (C1 * top[1] + C2 * err0) >> (DSHIFT - DSCALE);
    const int err1 = QuantizeSingle(&c[1][0], mtx);
    c[2][0] += (C1 * err0 + C2 * left[1]) >> (DSHIFT - DSCALE);
    const int err2 = QuantizeSingle(&c[2][0], mtx);
    c[3][0] += (C1 * err1 + C2 * err2) >> (DSHIFT - DSCALE);
    const int err3 = QuantizeSingle(&c[3][0], mtx);
    rd->derr[ch][0] = (int8_t)err1;
    rd->derr[ch][1] = (int8_t)err2;
    rd->derr[ch][2] = (int8_t)err3;
  }
}

void StoreDiffusionErrors(Iterator* it, const ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    int8_t* top = it->top_derr + ch * 2;
    int8_t* left = it->left_derr[ch];
    left[0] = rd->derr[ch][0];
    left[1] = (int8_t)((3 * rd->derr[ch][2]) >> 2);
    top[0] = rd->derr[ch][1];
    top[1] = (int8_t)(rd->derr[ch][2] - left[1]);
  }
}

int ReconstructUV(Iterator* it, ModeScore* rd, uint8_t* yuv_out, int mode) {
  const Encoder* enc = it->enc;
  const uint8_t* ref = it->yuv_p + kUVOffsets[mode];
  const uint8_t* src = it->yuv_in + U_OFF;
  const Segment* dqm = &enc->dqm[it->mb->segment];
  int nz = 0;
  int16_t tmp[8][16];
  for (int n = 0; n < 8; n += 2)
    FTransform2(src + kScanUV[n], ref + kScanUV[n], tmp[n]);
  CorrectDCValues(it, &dqm->uv, tmp, rd);
  for (int n = 0; n < 8; n += 2) {
    nz |= QuantizeBlock(tmp[n], rd->uv_levels[n], &dqm->uv, enc->T->zigzag)
          << n;
    nz |= QuantizeBlock(tmp[n + 1], rd->uv_levels[n + 1], &dqm->uv,
                        enc->T->zigzag)
          << (n + 1);
  }
  for (int n = 0; n < 8; n += 2)
    ITransform(ref + kScanUV[n], tmp[n], yuv_out + kScanUV[n], 1);
  return nz << 16;
}

void StoreMaxDelta(Segment* dqm, const int16_t DCs[16]) {
  const int v0 = std::abs(DCs[1]);
  const int v1 = std::abs(DCs[2]);
  const int v2 = std::abs(DCs[4]);
  int max_v = (v1 > v0) ? v1 : v0;
  max_v = (v2 > max_v) ? v2 : max_v;
  if (max_v > dqm->max_edge) dqm->max_edge = max_v;
}

void PickBestIntra16(Iterator* it, ModeScore* rd) {
  Segment* dqm = &it->enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_i16;
  const int tlambda = dqm->tlambda;
  const uint8_t* src = it->yuv_in + Y_OFF;
  ModeScore rd_tmp;
  ModeScore* rd_cur = &rd_tmp;
  ModeScore* rd_best = rd;
  int is_flat = IsFlatSource16(it->yuv_in + Y_OFF);
  rd->mode_i16 = -1;
  for (int mode = 0; mode < 4; ++mode) {
    uint8_t* tmp_dst = it->yuv_out2 + Y_OFF;
    rd_cur->mode_i16 = mode;
    rd_cur->nz = ReconstructIntra16(it, rd_cur, tmp_dst, mode);
    rd_cur->D = SSE(src, tmp_dst, 16, 16);
    rd_cur->SD =
        tlambda ? Mult8b(tlambda, Disto16x16(src, tmp_dst, kWeightY)) : 0;
    rd_cur->H = kFixedCostsI16[mode];
    rd_cur->R = GetCostLuma16(it, rd_cur);
    if (is_flat) {
      is_flat = IsFlat(rd_cur->y_ac_levels[0], 16, FLATNESS_LIMIT_I16);
      if (is_flat) {
        rd_cur->D *= 2;
        rd_cur->SD *= 2;
      }
    }
    SetRDScore(lambda, rd_cur);
    if (mode == 0 || rd_cur->score < rd_best->score) {
      std::swap(rd_cur, rd_best);
      it->SwapOut();
    }
  }
  if (rd_best != rd) memcpy(rd, rd_best, sizeof(*rd));
  SetRDScore(dqm->lambda_mode, rd);
  it->SetIntra16Mode(rd->mode_i16);
  if ((rd->nz & 0x100ffff) == 0x1000000 && rd->D > dqm->min_disto)
    StoreMaxDelta(dqm, rd->y_dc_levels);
}

const uint16_t* GetCostModeI4(Iterator* it, const uint8_t modes[16]) {
  const int preds_w = it->enc->preds_w;
  const int x = it->i4 & 3, y = it->i4 >> 2;
  const int left = (x == 0) ? it->preds[y * preds_w - 1] : modes[it->i4 - 1];
  const int top = (y == 0) ? it->preds[-preds_w + x] : modes[it->i4 - 4];
  return it->enc->T->fixed_i4[top][left];
}

int PickBestIntra4(Iterator* it, ModeScore* rd) {
  const Encoder* enc = it->enc;
  const Segment* dqm = &enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_i4;
  const int tlambda = dqm->tlambda;
  const uint8_t* src0 = it->yuv_in + Y_OFF;
  uint8_t* best_blocks = it->yuv_out2 + Y_OFF;
  int total_header_bits = 0;
  ModeScore rd_best;
  if (enc->max_i4_header_bits == 0) return 0;
  InitScore(&rd_best);
  rd_best.H = 211;  // BitCost(0, 145): the i4 flag
  SetRDScore(dqm->lambda_mode, &rd_best);
  it->StartI4();
  do {
    ModeScore rd_i4;
    int best_mode = -1;
    const uint8_t* src = src0 + kScan[it->i4];
    const uint16_t* mode_costs = GetCostModeI4(it, rd->modes_i4);
    uint8_t* best_block = best_blocks + kScan[it->i4];
    uint8_t* tmp_dst = it->yuv_p + I4TMP;
    InitScore(&rd_i4);
    it->MakeIntra4Preds();
    for (int mode = 0; mode < 10; ++mode) {
      ModeScore rd_tmp;
      int16_t tmp_levels[16];
      rd_tmp.nz = ReconstructIntra4(it, tmp_levels, src, tmp_dst, mode)
                  << it->i4;
      rd_tmp.D = SSE(src, tmp_dst, 4, 4);
      rd_tmp.SD =
          tlambda ? Mult8b(tlambda, Disto4x4(src, tmp_dst, kWeightY)) : 0;
      rd_tmp.H = mode_costs[mode];
      if (mode > 0 && IsFlat(tmp_levels, 1, FLATNESS_LIMIT_I4)) {
        rd_tmp.R = FLATNESS_PENALTY;
      } else {
        rd_tmp.R = 0;
      }
      SetRDScore(lambda, &rd_tmp);
      if (best_mode >= 0 && rd_tmp.score >= rd_i4.score) continue;
      rd_tmp.R += GetCostLuma4(it, tmp_levels);
      SetRDScore(lambda, &rd_tmp);
      if (best_mode < 0 || rd_tmp.score < rd_i4.score) {
        CopyScore(&rd_i4, &rd_tmp);
        best_mode = mode;
        std::swap(tmp_dst, best_block);
        memcpy(rd_best.y_ac_levels[it->i4], tmp_levels, sizeof(tmp_levels));
      }
    }
    SetRDScore(dqm->lambda_mode, &rd_i4);
    AddScore(&rd_best, &rd_i4);
    if (rd_best.score >= rd->score) return 0;
    total_header_bits += (int)rd_i4.H;
    if (total_header_bits > enc->max_i4_header_bits) return 0;
    if (best_block != best_blocks + kScan[it->i4]) {
      uint8_t* d = best_blocks + kScan[it->i4];
      for (int j = 0; j < 4; ++j) memcpy(d + j * BPS, best_block + j * BPS, 4);
    }
    rd->modes_i4[it->i4] = (uint8_t)best_mode;
    it->top_nz[it->i4 & 3] = it->left_nz[it->i4 >> 2] = (rd_i4.nz ? 1 : 0);
  } while (it->RotateI4(best_blocks));
  CopyScore(rd, &rd_best);
  it->SetIntra4Mode(rd->modes_i4);
  it->SwapOut();
  memcpy(rd->y_ac_levels, rd_best.y_ac_levels, sizeof(rd->y_ac_levels));
  return 1;
}

void PickBestUV(Iterator* it, ModeScore* rd) {
  const Segment* dqm = &it->enc->dqm[it->mb->segment];
  const int lambda = dqm->lambda_uv;
  const uint8_t* src = it->yuv_in + U_OFF;
  uint8_t* tmp_dst = it->yuv_out2 + U_OFF;
  uint8_t* dst0 = it->yuv_out + U_OFF;
  uint8_t* dst = dst0;
  ModeScore rd_best;
  InitScore(&rd_best);
  rd->mode_uv = -1;
  for (int mode = 0; mode < 4; ++mode) {
    ModeScore rd_uv;
    rd_uv.nz = ReconstructUV(it, &rd_uv, tmp_dst, mode);
    rd_uv.D = SSE(src, tmp_dst, 16, 8);
    rd_uv.SD = 0;
    rd_uv.H = kFixedCostsUV[mode];
    rd_uv.R = GetCostUV(it, &rd_uv);
    if (mode > 0 && IsFlat(rd_uv.uv_levels[0], 8, FLATNESS_LIMIT_UV))
      rd_uv.R += FLATNESS_PENALTY * 8;
    SetRDScore(lambda, &rd_uv);
    if (mode == 0 || rd_uv.score < rd_best.score) {
      CopyScore(&rd_best, &rd_uv);
      rd->mode_uv = mode;
      memcpy(rd->uv_levels, rd_uv.uv_levels, sizeof(rd->uv_levels));
      memcpy(rd->derr, rd_uv.derr, sizeof(rd_uv.derr));
      std::swap(dst, tmp_dst);
    }
  }
  it->mb->uv_mode = (uint8_t)rd->mode_uv;
  AddScore(rd, &rd_best);
  if (dst != dst0) {
    for (int j = 0; j < 8; ++j) memcpy(dst0 + j * BPS, dst + j * BPS, 16);
  }
  StoreDiffusionErrors(it, rd);
}

void Decimate(Iterator* it, ModeScore* rd) {
  InitScore(rd);
  it->MakeLuma16Preds();
  it->MakeChroma8Preds();
  PickBestIntra16(it, rd);
  PickBestIntra4(it, rd);
  PickBestUV(it, rd);
}

// ---------------------------------------------------------------------------
// Token recording and the probabilities (token_enc.c, frame_enc.c)

inline int RecordStats(int bit, proba_t* stats) {
  proba_t p = *stats;
  if (p >= 0xfffe0000u) p = ((p + 1u) >> 1) & 0x7fff7fffu;
  p += 0x00010000u + bit;
  *stats = p;
  return bit;
}

inline uint32_t TokenId(int t, int b, int ctx) {
  return NUM_PROBAS * (ctx + NUM_CTX * (b + NUM_BANDS * t));
}

struct TokenRecorder {
  Encoder* enc;

  int Add(uint32_t bit, uint32_t proba_idx, proba_t* stats) {
    enc->tokens.push_back((uint16_t)((bit << 15) | proba_idx));
    RecordStats(bit, stats);
    return bit;
  }

  void AddConstant(uint32_t bit, uint32_t proba) {
    enc->tokens.push_back((uint16_t)((bit << 15) | FIXED_PROBA_BIT | proba));
  }

  proba_t* Stats(int type, int band, int ctx) {
    return enc->proba.stats[type][band][ctx];
  }

  // VP8RecordCoeffTokens; returns whether any coefficient is non-zero
  int Record(int ctx, const Residual* res) {
    const Tables* T = enc->T;
    const int16_t* coeffs = res->coeffs;
    const int type = res->coeff_type;
    const int last = res->last;
    int n = res->first;
    uint32_t base_id = TokenId(type, n, ctx);
    proba_t* s = Stats(type, n, ctx);
    if (!Add(last >= 0, base_id + 0, s + 0)) return 0;
    while (n < 16) {
      const int c = coeffs[n++];
      const int sign = c < 0;
      const uint32_t v = sign ? -c : c;
      if (!Add(v != 0, base_id + 1, s + 1)) {
        base_id = TokenId(type, T->bands[n], 0);
        s = Stats(type, T->bands[n], 0);
        continue;
      }
      if (!Add(v > 1, base_id + 2, s + 2)) {
        base_id = TokenId(type, T->bands[n], 1);
        s = Stats(type, T->bands[n], 1);
      } else {
        if (!Add(v > 4, base_id + 3, s + 3)) {
          if (Add(v != 2, base_id + 4, s + 4)) Add(v == 4, base_id + 5, s + 5);
        } else if (!Add(v > 10, base_id + 6, s + 6)) {
          if (!Add(v > 6, base_id + 7, s + 7)) {
            AddConstant(v == 6, 159);
          } else {
            AddConstant(v >= 9, 165);
            AddConstant(!(v & 1), 145);
          }
        } else {
          int mask;
          const uint8_t* tab;
          uint32_t residue = v - 3;
          if (residue < (8 << 1)) {
            Add(0, base_id + 8, s + 8);
            Add(0, base_id + 9, s + 9);
            residue -= (8 << 0);
            mask = 1 << 2;
            tab = T->cat[0];
          } else if (residue < (8 << 2)) {
            Add(0, base_id + 8, s + 8);
            Add(1, base_id + 9, s + 9);
            residue -= (8 << 1);
            mask = 1 << 3;
            tab = T->cat[1];
          } else if (residue < (8 << 3)) {
            Add(1, base_id + 8, s + 8);
            Add(0, base_id + 10, s + 9);  // libwebp counts it under proba 9
            residue -= (8 << 2);
            mask = 1 << 4;
            tab = T->cat[2];
          } else {
            Add(1, base_id + 8, s + 8);
            Add(1, base_id + 10, s + 9);
            residue -= (8 << 3);
            mask = 1 << 10;
            tab = T->cat[3];
          }
          while (mask) {
            AddConstant(!!(residue & mask), *tab++);
            mask >>= 1;
          }
        }
        base_id = TokenId(type, T->bands[n], 2);
        s = Stats(type, T->bands[n], 2);
      }
      AddConstant(sign, 128);
      if (n == 16 || !Add(n <= last, base_id + 0, s + 0)) return 1;  // EOB
    }
    return 1;
  }
};

void RecordTokens(Iterator* it, const ModeScore* rd) {
  Encoder* enc = it->enc;
  TokenRecorder rec = {enc};
  Residual res;
  it->NzToBytes();
  if (it->mb->type == 1) {
    const int ctx = it->top_nz[8] + it->left_nz[8];
    res = {0, -1, 1, nullptr};
    SetResidualCoeffs(rd->y_dc_levels, &res);
    it->top_nz[8] = it->left_nz[8] = rec.Record(ctx, &res);
    res = {1, -1, 0, nullptr};
  } else {
    res = {0, -1, 3, nullptr};
  }
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int ctx = it->top_nz[x] + it->left_nz[y];
      SetResidualCoeffs(rd->y_ac_levels[x + y * 4], &res);
      it->top_nz[x] = it->left_nz[y] = rec.Record(ctx, &res);
    }
  }
  res = {0, -1, 2, nullptr};
  for (int ch = 0; ch <= 2; ch += 2) {
    for (int y = 0; y < 2; ++y) {
      for (int x = 0; x < 2; ++x) {
        const int ctx = it->top_nz[4 + ch + x] + it->left_nz[4 + ch + y];
        SetResidualCoeffs(rd->uv_levels[ch * 2 + x + y * 2], &res);
        it->top_nz[4 + ch + x] = it->left_nz[4 + ch + y] =
            rec.Record(ctx, &res);
      }
    }
  }
  it->BytesToNz();
}

int CalcTokenProba(int nb, int total) {
  return nb ? (255 - nb * 255 / total) : 255;
}

int BranchCost(int nb, int total, int proba) {
  return nb * BitCost(1, proba) + (total - nb) * BitCost(0, proba);
}

void FinalizeTokenProbas(Encoder* enc) {
  Proba* proba = &enc->proba;
  int has_changed = 0;
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const proba_t stats = proba->stats[t][b][c][p];
          const int nb = (stats >> 0) & 0xffff;
          const int total = (stats >> 16) & 0xffff;
          const int update_proba = enc->T->update[t][b][c][p];
          const int old_p = enc->T->coeffs0[t][b][c][p];
          const int new_p = CalcTokenProba(nb, total);
          const int old_cost =
              BranchCost(nb, total, old_p) + BitCost(0, update_proba);
          const int new_cost = BranchCost(nb, total, new_p) +
                               BitCost(1, update_proba) + 8 * 256;
          const int use_new_p = (old_cost > new_cost);
          if (use_new_p) {
            proba->coeffs[t][b][c][p] = (uint8_t)new_p;
            has_changed |= (new_p != old_p);
          } else {
            proba->coeffs[t][b][c][p] = (uint8_t)old_p;
          }
        }
  proba->dirty = has_changed;
}

// ---------------------------------------------------------------------------
// Quantizer set-up (quant_enc.c SetupMatrices, frame_enc.c
// SetSegmentProbas)

void SetupMatrices(Encoder* enc) {
  const Tables* T = enc->T;
  const int tlambda_scale = 50;  // sns_strength, at method >= 4
  for (int i = 0; i < enc->num_segments; ++i) {
    Segment* m = &enc->dqm[i];
    const int q = m->quant;
    m->y1.q[0] = (uint16_t)T->dc[clip(q, 0, 127)];
    m->y1.q[1] = (uint16_t)T->ac[clip(q, 0, 127)];
    m->y2.q[0] = (uint16_t)(T->dc[clip(q, 0, 127)] * 2);
    m->y2.q[1] = (uint16_t)T->ac2[clip(q, 0, 127)];
    m->uv.q[0] = (uint16_t)T->dc[clip(q + enc->dq_uv_dc, 0, 117)];
    m->uv.q[1] = (uint16_t)T->ac[clip(q + enc->dq_uv_ac, 0, 127)];
    const int q_i4 = ExpandMatrix(&m->y1, 0);
    const int q_i16 = ExpandMatrix(&m->y2, 1);
    const int q_uv = ExpandMatrix(&m->uv, 2);
    m->lambda_i4 = std::max(1, (3 * q_i4 * q_i4) >> 7);
    m->lambda_i16 = std::max(1, 3 * q_i16 * q_i16);
    m->lambda_uv = std::max(1, (3 * q_uv * q_uv) >> 6);
    m->lambda_mode = std::max(1, (1 * q_i4 * q_i4) >> 7);
    m->tlambda = std::max(1, (tlambda_scale * q_i4) >> 5);
    m->min_disto = 20 * m->y1.q[0];
    m->max_edge = 0;
  }
}

int GetProba(int a, int b) {
  const int total = a + b;
  return (total == 0) ? 255 : (255 * a + total / 2) / total;
}

// returns the segment map's cost, in 1/256 bit
uint64_t SetSegmentProbas(Encoder* enc) {
  int p[NUM_SEG] = {0};
  for (const MBInfo& mb : enc->mb_info) ++p[mb.segment];
  if (enc->num_segments <= 1) {
    enc->update_map = 0;
    return 0;
  }
  uint8_t* probas = enc->proba.segments;
  probas[0] = (uint8_t)GetProba(p[0] + p[1], p[2] + p[3]);
  probas[1] = (uint8_t)GetProba(p[0], p[1]);
  probas[2] = (uint8_t)GetProba(p[2], p[3]);
  enc->update_map =
      (probas[0] != 255) || (probas[1] != 255) || (probas[2] != 255);
  if (!enc->update_map)
    for (MBInfo& mb : enc->mb_info) mb.segment = 0;
  return (uint64_t)p[0] * (BitCost(0, probas[0]) + BitCost(0, probas[1])) +
         (uint64_t)p[1] * (BitCost(0, probas[0]) + BitCost(1, probas[1])) +
         (uint64_t)p[2] * (BitCost(1, probas[0]) + BitCost(0, probas[2])) +
         (uint64_t)p[3] * (BitCost(1, probas[0]) + BitCost(1, probas[2]));
}

// the filter levels after the loop (filter_enc.c VP8AdjustFilterStrength,
// sharpness 0: a level is its delta, at most 63)
void AdjustFilterStrength(Encoder* enc) {
  int max_level = 0;
  for (int s = 0; s < NUM_SEG; ++s) {
    Segment* dqm = &enc->dqm[s];
    const int delta = (dqm->max_edge * dqm->y2.q[1]) >> 3;
    const int level = delta < 63 ? delta : 63;
    if (level > dqm->fstrength) dqm->fstrength = level;
    if (max_level < dqm->fstrength) max_level = dqm->fstrength;
  }
  enc->filter_level = max_level;
}

// ---------------------------------------------------------------------------
// The first partition (syntax_enc.c, tree_enc.c)

void PutSegmentHeader(BitWriter* bw, const Encoder* enc) {
  if (bw->PutBitUniform(enc->num_segments > 1)) {
    bw->PutBitUniform(enc->update_map);
    if (bw->PutBitUniform(1)) {  // update the data, absolute values
      bw->PutBitUniform(1);
      for (int s = 0; s < NUM_SEG; ++s)
        bw->PutSignedBits(enc->dqm[s].quant, 7);
      for (int s = 0; s < NUM_SEG; ++s)
        bw->PutSignedBits(enc->dqm[s].fstrength, 6);
    }
    if (enc->update_map) {
      for (int s = 0; s < 3; ++s) {
        if (bw->PutBitUniform(enc->proba.segments[s] != 255u))
          bw->PutBits(enc->proba.segments[s], 8);
      }
    }
  }
}

void PutI16Mode(BitWriter* bw, int mode) {
  if (bw->PutBit(mode == TM_PRED || mode == H_PRED, 156)) {
    bw->PutBit(mode == TM_PRED, 128);
  } else {
    bw->PutBit(mode == V_PRED, 163);
  }
}

int PutI4Mode(BitWriter* bw, int mode, const uint8_t* prob) {
  if (bw->PutBit(mode != B_DC, prob[0])) {
    if (bw->PutBit(mode != B_TM, prob[1])) {
      if (bw->PutBit(mode != B_VE, prob[2])) {
        if (!bw->PutBit(mode >= B_LD, prob[3])) {
          if (bw->PutBit(mode != B_HE, prob[4]))
            bw->PutBit(mode != B_RD, prob[5]);
        } else {
          if (bw->PutBit(mode != B_LD, prob[6])) {
            if (bw->PutBit(mode != B_VL, prob[7]))
              bw->PutBit(mode != B_HD, prob[8]);
          }
        }
      }
    }
  }
  return mode;
}

void PutUVMode(BitWriter* bw, int uv_mode) {
  if (bw->PutBit(uv_mode != DC_PRED, 142)) {
    if (bw->PutBit(uv_mode != V_PRED, 114))
      bw->PutBit(uv_mode != H_PRED, 183);
  }
}

void CodeIntraModes(Encoder* enc, BitWriter* bw) {
  for (int y = 0; y < enc->mb_h; ++y) {
    for (int x = 0; x < enc->mb_w; ++x) {
      const MBInfo& mb = enc->mb_info[y * enc->mb_w + x];
      const uint8_t* preds = enc->preds + y * 4 * enc->preds_w + x * 4;
      if (enc->update_map) {
        const uint8_t* p = enc->proba.segments;
        const int s = mb.segment;
        if (bw->PutBit(s >= 2, p[0])) p += 1;
        bw->PutBit(s & 1, p[1]);
      }
      if (bw->PutBit(mb.type != 0, 145)) {
        PutI16Mode(bw, preds[0]);
      } else {
        const int preds_w = enc->preds_w;
        const uint8_t* top_pred = preds - preds_w;
        for (int yy = 0; yy < 4; ++yy) {
          int left = preds[-1];
          for (int xx = 0; xx < 4; ++xx) {
            const uint8_t* probas = enc->T->bmodes[top_pred[xx]][left];
            left = PutI4Mode(bw, preds[xx], probas);
          }
          top_pred = preds;
          preds += preds_w;
        }
      }
      PutUVMode(bw, mb.uv_mode);
    }
  }
}

void GeneratePartition0(Encoder* enc, BitWriter* bw) {
  bw->PutBitUniform(0);  // colour space
  bw->PutBitUniform(0);  // clamping type
  PutSegmentHeader(bw, enc);
  bw->PutBitUniform(0);  // normal filter
  bw->PutBits(enc->filter_level, 6);
  bw->PutBits(0, 3);      // sharpness
  bw->PutBitUniform(0);  // no loop-filter deltas
  bw->PutBits(0, 2);      // one token partition
  bw->PutBits(enc->base_quant, 7);
  bw->PutSignedBits(0, 4);  // y1 dc
  bw->PutSignedBits(0, 4);  // y2 dc
  bw->PutSignedBits(0, 4);  // y2 ac
  bw->PutSignedBits(enc->dq_uv_dc, 4);
  bw->PutSignedBits(enc->dq_uv_ac, 4);
  bw->PutBitUniform(0);  // no refresh of the entropy probabilities
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          const uint8_t p0 = enc->proba.coeffs[t][b][c][p];
          const int update = (p0 != enc->T->coeffs0[t][b][c][p]);
          if (bw->PutBit(update, enc->T->update[t][b][c][p]))
            bw->PutBits(p0, 8);
        }
  bw->PutBitUniform(0);  // no skip flag
  CodeIntraModes(enc, bw);
  bw->Finish();
}

void InitEncoder(Encoder* enc, const Tables* T, const uint8_t* y,
                 const uint8_t* u, const uint8_t* v, int width, int height) {
  enc->T = T;
  enc->width = width;
  enc->height = height;
  enc->mb_w = (width + 15) >> 4;
  enc->mb_h = (height + 15) >> 4;
  enc->ysrc = y;
  enc->usrc = u;
  enc->vsrc = v;
  enc->y_stride = width;
  enc->uv_stride = (width + 1) >> 1;
  enc->mb_info.assign(enc->mb_w * enc->mb_h, MBInfo());
  enc->preds_w = 4 * enc->mb_w + 1;
  const int preds_h = 4 * enc->mb_h + 1;
  enc->preds_mem.assign(enc->preds_w * preds_h + 1, B_DC);
  enc->preds = enc->preds_mem.data() + enc->preds_w + 1;
  enc->nz_mem.assign(enc->mb_w + 1, 0);
  enc->nz = enc->nz_mem.data() + 1;
  enc->y_top.assign(enc->mb_w * 16 + 4, 127);
  enc->uv_top.assign(enc->mb_w * 16, 127);
  enc->top_derr.assign(enc->mb_w * 4, 0);
  for (Segment& s : enc->dqm) {
    memset(&s.y1, 0, sizeof(Matrix));
    memset(&s.y2, 0, sizeof(Matrix));
    memset(&s.uv, 0, sizeof(Matrix));
  }
}

}  // namespace

extern "C" {

// The analysis pass over the Y (width x height) and U, V planes
// (ceil(width / 2) x ceil(height / 2)), row-major.  segment_out gets each
// macroblock's segment (0..3, raster order); out gets the four segments'
// alpha, then their beta, then the mean alpha and the mean chroma alpha.
void avrt_vp8_analyze(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                      int width, int height, const int32_t* tables,
                      uint8_t* segment_out, int32_t* out) {
  Tables* T = new Tables;
  InitTables(T, tables);
  Encoder* enc = new Encoder;
  InitEncoder(enc, T, y, u, v, width, height);
  Iterator* it = new Iterator(enc);
  int alphas[MAX_ALPHA + 1] = {0};
  int64_t alpha_sum = 0, uv_alpha_sum = 0;
  uint8_t tmp_32[32];
  do {
    it->Import(tmp_32);
    int best_alpha = AnalyzeBestAlpha(it, 0);
    const int best_uv_alpha = AnalyzeBestAlpha(it, 1);
    best_alpha = (3 * best_alpha + best_uv_alpha + 2) >> 2;
    best_alpha = clip(MAX_ALPHA - best_alpha, 0, MAX_ALPHA);
    alphas[best_alpha]++;
    it->mb->alpha = best_alpha;
    alpha_sum += best_alpha;
    uv_alpha_sum += best_uv_alpha;
  } while (it->Next());
  const int total_mb = enc->mb_w * enc->mb_h;
  int seg_alpha[NUM_SEG], seg_beta[NUM_SEG];
  AssignSegments(enc, alphas, seg_alpha, seg_beta);
  for (int n = 0; n < total_mb; ++n) segment_out[n] = enc->mb_info[n].segment;
  for (int s = 0; s < NUM_SEG; ++s) {
    out[s] = seg_alpha[s];
    out[NUM_SEG + s] = seg_beta[s];
  }
  out[2 * NUM_SEG] = (int32_t)(alpha_sum / total_mb);
  out[2 * NUM_SEG + 1] = (int32_t)(uv_alpha_sum / total_mb);
  delete it;
  delete enc;
  delete T;
}

// The frame, as the VP8 chunk's payload, into dst (capacity cap); returns
// its length, or -(the length needed) when cap is too small.  params:
// the number of segments, their quantizers [4] and filter levels [4], the
// base quantizer, the chroma dc and ac deltas, and the quantizer and
// level the unused segments take when the loop runs again; segment: each
// macroblock's segment after the segments were merged.
int64_t avrt_vp8_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                        int width, int height, const int32_t* tables,
                        const uint8_t* segment, const int32_t* params,
                        uint8_t* dst, int64_t cap) {
  Tables* T = new Tables;
  InitTables(T, tables);
  Encoder* enc = new Encoder;
  InitEncoder(enc, T, y, u, v, width, height);
  enc->num_segments = params[0];
  for (int s = 0; s < NUM_SEG; ++s) {
    enc->dqm[s].quant = params[1 + s];
    enc->dqm[s].fstrength = params[1 + NUM_SEG + s];
  }
  enc->base_quant = params[1 + 2 * NUM_SEG];
  enc->dq_uv_dc = params[2 + 2 * NUM_SEG];
  enc->dq_uv_ac = params[3 + 2 * NUM_SEG];
  const int fill_quant = params[4 + 2 * NUM_SEG];
  const int fill_level = params[5 + 2 * NUM_SEG];
  const int total_mb = enc->mb_w * enc->mb_h;
  for (int n = 0; n < total_mb; ++n) enc->mb_info[n].segment = segment[n];

  // VP8DefaultProbas, SetLoopParams
  memset(&enc->proba, 0, sizeof(enc->proba));
  memset(enc->proba.segments, 255, sizeof(enc->proba.segments));
  memcpy(enc->proba.coeffs, T->coeffs0, sizeof(T->coeffs0));
  enc->proba.dirty = 1;
  const uint64_t segment_map_cost = SetSegmentProbas(enc);
  enc->tokens.reserve((size_t)total_mb * 64);

  // VP8EncTokenLoop: one pass, run again with half the intra-4 header
  // budget while the first partition's estimate passes VP8's 512 KiB
  // (less 2 KiB; in 1/256 bit)
  const uint64_t kPartition0Limit = ((1ull << 19) - 2048ull) << 11;
  int max_count = total_mb >> 3;
  if (max_count < MIN_COUNT) max_count = MIN_COUNT;
  Iterator* it = new Iterator(enc);
  for (;;) {
    SetupMatrices(enc);
    CalculateLevelCosts(&enc->proba);
    memset(enc->proba.stats, 0, sizeof(enc->proba.stats));
    enc->tokens.clear();
    it->Reset();
    uint64_t size_p0 = segment_map_cost;
    int cnt = max_count;
    do {
      ModeScore info;
      it->top_derr = enc->top_derr.data() + it->x * 4;
      it->Import(nullptr);
      if ((--cnt) < 0) {
        FinalizeTokenProbas(enc);
        CalculateLevelCosts(&enc->proba);
        cnt = max_count;
      }
      Decimate(it, &info);
      RecordTokens(it, &info);
      size_p0 += info.H;
      it->SaveBoundary();
    } while (it->Next());
    if (enc->max_i4_header_bits == 0 || size_p0 <= kPartition0Limit) break;
    enc->max_i4_header_bits >>= 1;
    // VP8SetSegmentParams again, over the merged segments only: the slots
    // past them get the base quantizer and its level
    for (int s = enc->num_segments; s < NUM_SEG; ++s) {
      enc->dqm[s].quant = fill_quant;
      enc->dqm[s].fstrength = fill_level;
    }
  }
  FinalizeTokenProbas(enc);
  BitWriter tokens_bw;
  for (uint16_t token : enc->tokens) {
    const int bit = (token >> 15) & 1;
    if (token & FIXED_PROBA_BIT) {
      tokens_bw.PutBit(bit, token & 0x00ffu);
    } else {  // TokenId's index into coeffs[type][band][ctx][proba]
      const int id = token & 0x3fffu;
      const int p = id % NUM_PROBAS, c = id / NUM_PROBAS % NUM_CTX;
      const int b = id / (NUM_PROBAS * NUM_CTX) % NUM_BANDS;
      const int t = id / (NUM_PROBAS * NUM_CTX * NUM_BANDS);
      tokens_bw.PutBit(bit, enc->proba.coeffs[t][b][c][p]);
    }
  }
  tokens_bw.Finish();
  AdjustFilterStrength(enc);

  BitWriter bw;
  GeneratePartition0(enc, &bw);
  const int64_t size0 = (int64_t)bw.buf.size();
  const int64_t total = 10 + size0 + (int64_t)tokens_bw.buf.size();
  if (total <= cap) {
    const uint32_t bits = 0 | (0 << 1) | (1 << 4) | ((uint32_t)size0 << 5);
    dst[0] = bits & 0xff;
    dst[1] = (bits >> 8) & 0xff;
    dst[2] = (bits >> 16) & 0xff;
    dst[3] = 0x9d;
    dst[4] = 0x01;
    dst[5] = 0x2a;
    dst[6] = width & 0xff;
    dst[7] = (width >> 8) & 0xff;
    dst[8] = height & 0xff;
    dst[9] = (height >> 8) & 0xff;
    memcpy(dst + 10, bw.buf.data(), size0);
    memcpy(dst + 10 + size0, tokens_bw.buf.data(), tokens_bw.buf.size());
  }
  delete it;
  delete enc;
  delete T;
  return total <= cap ? total : -total;
}

}  // extern "C"
