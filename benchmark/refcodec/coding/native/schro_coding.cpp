// The reference decoder's native entropy decoding: the decoding half of a
// frozen copy of the port's C++ coder.
//   - Dirac adaptive binary arithmetic decoder (schroarith.h:146-335)
//   - exp-Golomb bit reading (schrounpack.c)
//   - Dirac subband codeblock decoding (schrodecoder.c:3018-3100)
//   - intra DC prediction and block motion data decoding
//     (schrodecoder.c:2556-2816, 3220-3275)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Tables (Dirac/VC-2 spec data; see tables.py of this package)

static const uint32_t QUANT_FACTOR[61] = {
    4, 5, 6, 7, 8, 10, 11, 13, 16, 19, 23, 27, 32, 38, 45, 54,
    64, 76, 91, 108, 128, 152, 181, 215, 256, 304, 362, 431,
    512, 609, 724, 861, 1024, 1218, 1448, 1722, 2048, 2435, 2896, 3444,
    4096, 4871, 5793, 6889, 8192, 9742, 11585, 13777,
    16384, 19484, 23170, 27554, 32768, 38968, 46341, 55109,
    65536, 77936, 92682, 110218, 131072};

static const uint32_t QUANT_OFFSET_1_2[61] = {
    1, 2, 3, 4, 4, 5, 6, 7, 8, 10, 12, 14, 16, 19, 23, 27,
    32, 38, 46, 54, 64, 76, 91, 108, 128, 152, 181, 216,
    256, 305, 362, 431, 512, 609, 724, 861, 1024, 1218, 1448, 1722,
    2048, 2436, 2897, 3445, 4096, 4871, 5793, 6889,
    8192, 9742, 11585, 13777, 16384, 19484, 23171, 27555,
    32768, 38968, 46341, 55109, 65536};

static const uint32_t QUANT_OFFSET_3_8[61] = {
    1, 2, 2, 3, 3, 4, 4, 5, 6, 7, 9, 10, 12, 14, 17, 20,
    24, 29, 34, 41, 48, 57, 68, 81, 96, 114, 136, 162,
    192, 228, 272, 323, 384, 457, 543, 646, 768, 913, 1086, 1292,
    1536, 1827, 2172, 2583, 3072, 3653, 4344, 5166,
    6144, 7307, 8689, 10333, 12288, 14613, 17378, 20666,
    24576, 29226, 34756, 41332, 49152};

// Arith adaptation LUT (schroarith.c:90-122)
static const uint16_t ALUT[256] = {
    0, 2, 5, 8, 11, 15, 20, 24, 29, 35, 41, 47, 53, 60, 67, 74,
    82, 89, 97, 106, 114, 123, 132, 141, 150, 160, 170, 180, 190, 201, 211,
    222, 233, 244, 256, 267, 279, 291, 303, 315, 327, 340, 353, 366, 379, 392,
    405, 419, 433, 447, 461, 475, 489, 504, 518, 533, 548, 563, 578, 593, 609,
    624, 640, 656, 672, 688, 705, 721, 738, 754, 771, 788, 805, 822, 840, 857,
    875, 892, 910, 928, 946, 964, 983, 1001, 1020, 1038, 1057, 1076, 1095,
    1114, 1133, 1153, 1172, 1192, 1211, 1231, 1251, 1271, 1291, 1311, 1332,
    1352, 1373, 1393, 1414, 1435, 1456, 1477, 1498, 1520, 1541, 1562, 1584,
    1606, 1628, 1649, 1671, 1694, 1716, 1738, 1760, 1783, 1806, 1828, 1851,
    1874, 1897, 1920, 1935, 1942, 1949, 1955, 1961, 1968, 1974, 1980, 1985,
    1991, 1996, 2001, 2006, 2011, 2016, 2021, 2025, 2029, 2033, 2037, 2040,
    2044, 2047, 2050, 2053, 2056, 2058, 2061, 2063, 2065, 2066, 2068, 2069,
    2070, 2071, 2072, 2072, 2072, 2072, 2072, 2072, 2071, 2070, 2069, 2068,
    2066, 2065, 2063, 2060, 2058, 2055, 2052, 2049, 2045, 2042, 2038, 2033,
    2029, 2024, 2019, 2013, 2008, 2002, 1996, 1989, 1982, 1975, 1968, 1960,
    1952, 1943, 1934, 1925, 1916, 1906, 1896, 1885, 1874, 1863, 1851, 1839,
    1827, 1814, 1800, 1786, 1772, 1757, 1742, 1727, 1710, 1694, 1676, 1659,
    1640, 1622, 1602, 1582, 1561, 1540, 1518, 1495, 1471, 1447, 1422, 1396,
    1369, 1341, 1312, 1282, 1251, 1219, 1186, 1151, 1114, 1077, 1037, 995,
    952, 906, 857, 805, 750, 690, 625, 553, 471, 376, 255};

// Context chaining (schroarith.c next_list); see coding/arith.py for names.
enum {
  CTX_ZERO_CODEBLOCK = 0, CTX_QUANTISER_CONT, CTX_QUANTISER_VALUE,
  CTX_QUANTISER_SIGN, CTX_ZPZN_F1, CTX_ZPNN_F1, CTX_ZP_F2, CTX_ZP_F3,
  CTX_ZP_F4, CTX_ZP_F5, CTX_ZP_F6p, CTX_NPZN_F1, CTX_NPNN_F1, CTX_NP_F2,
  CTX_NP_F3, CTX_NP_F4, CTX_NP_F5, CTX_NP_F6p, CTX_SIGN_POS, CTX_SIGN_NEG,
  CTX_SIGN_ZERO, CTX_COEFF_DATA, CTX_SB_F1, CTX_SB_F2, CTX_SB_DATA,
  CTX_BLOCK_MODE_REF1, CTX_BLOCK_MODE_REF2, CTX_GLOBAL_BLOCK,
  CTX_LUMA_DC_CONT_BIN1, CTX_LUMA_DC_CONT_BIN2, CTX_LUMA_DC_VALUE,
  CTX_LUMA_DC_SIGN, CTX_CHROMA1_DC_CONT_BIN1, CTX_CHROMA1_DC_CONT_BIN2,
  CTX_CHROMA1_DC_VALUE, CTX_CHROMA1_DC_SIGN, CTX_CHROMA2_DC_CONT_BIN1,
  CTX_CHROMA2_DC_CONT_BIN2, CTX_CHROMA2_DC_VALUE, CTX_CHROMA2_DC_SIGN,
  CTX_MV_REF1_H_CONT_BIN1, CTX_MV_REF1_H_CONT_BIN2, CTX_MV_REF1_H_CONT_BIN3,
  CTX_MV_REF1_H_CONT_BIN4, CTX_MV_REF1_H_CONT_BIN5, CTX_MV_REF1_H_VALUE,
  CTX_MV_REF1_H_SIGN, CTX_MV_REF1_V_CONT_BIN1, CTX_MV_REF1_V_CONT_BIN2,
  CTX_MV_REF1_V_CONT_BIN3, CTX_MV_REF1_V_CONT_BIN4, CTX_MV_REF1_V_CONT_BIN5,
  CTX_MV_REF1_V_VALUE, CTX_MV_REF1_V_SIGN, CTX_MV_REF2_H_CONT_BIN1,
  CTX_MV_REF2_H_CONT_BIN2, CTX_MV_REF2_H_CONT_BIN3, CTX_MV_REF2_H_CONT_BIN4,
  CTX_MV_REF2_H_CONT_BIN5, CTX_MV_REF2_H_VALUE, CTX_MV_REF2_H_SIGN,
  CTX_MV_REF2_V_CONT_BIN1, CTX_MV_REF2_V_CONT_BIN2, CTX_MV_REF2_V_CONT_BIN3,
  CTX_MV_REF2_V_CONT_BIN4, CTX_MV_REF2_V_CONT_BIN5, CTX_MV_REF2_V_VALUE,
  CTX_MV_REF2_V_SIGN, CTX_LAST
};

static const uint8_t NEXT_CTX[CTX_LAST] = {
    0, CTX_QUANTISER_CONT, 0, 0,
    CTX_ZP_F2, CTX_ZP_F2, CTX_ZP_F3, CTX_ZP_F4,
    CTX_ZP_F5, CTX_ZP_F6p, CTX_ZP_F6p, CTX_NP_F2,
    CTX_NP_F2, CTX_NP_F3, CTX_NP_F4, CTX_NP_F5,
    CTX_NP_F6p, CTX_NP_F6p, 0, 0,
    0, 0, CTX_SB_F2, CTX_SB_F2,
    0, 0, 0, 0,
    CTX_LUMA_DC_CONT_BIN2, CTX_LUMA_DC_CONT_BIN2, 0, 0,
    CTX_CHROMA1_DC_CONT_BIN2, CTX_CHROMA1_DC_CONT_BIN2, 0, 0,
    CTX_CHROMA2_DC_CONT_BIN2, CTX_CHROMA2_DC_CONT_BIN2, 0, 0,
    CTX_MV_REF1_H_CONT_BIN2, CTX_MV_REF1_H_CONT_BIN3, CTX_MV_REF1_H_CONT_BIN4, CTX_MV_REF1_H_CONT_BIN5,
    CTX_MV_REF1_H_CONT_BIN5, 0, 0, CTX_MV_REF1_V_CONT_BIN2,
    CTX_MV_REF1_V_CONT_BIN3, CTX_MV_REF1_V_CONT_BIN4, CTX_MV_REF1_V_CONT_BIN5, CTX_MV_REF1_V_CONT_BIN5,
    0, 0, CTX_MV_REF2_H_CONT_BIN2, CTX_MV_REF2_H_CONT_BIN3,
    CTX_MV_REF2_H_CONT_BIN4, CTX_MV_REF2_H_CONT_BIN5, CTX_MV_REF2_H_CONT_BIN5, 0,
    0, CTX_MV_REF2_V_CONT_BIN2, CTX_MV_REF2_V_CONT_BIN3, CTX_MV_REF2_V_CONT_BIN4,
    CTX_MV_REF2_V_CONT_BIN5, CTX_MV_REF2_V_CONT_BIN5, 0, 0};

// ---------------------------------------------------------------------------
// Quantiser

static inline int64_t dequantise1(int64_t q, int64_t qf, int64_t qo) {
  if (q == 0) return 0;
  int64_t m = ((q < 0 ? -q : q) * qf + qo + 2) >> 2;
  return q < 0 ? -m : m;
}

static inline int divide3(int32_t a) {
  return ((int32_t)(a * 21845) + 10922) >> 16;
}

// The reference's s32 (deep) DC-prediction divide is NOT the fixed-point
// divide3 but schro_divide(a, 3) (schroutils.h:63): truncating division
// with a negative adjustment, i.e. floor toward -inf.  Used by the deep
// paths only (schrodecoder.c:3271, schroencoder.c:3648).
static inline int divide3_s32(int32_t a) {
  return a < 0 ? (a - 2) / 3 : a / 3;
}

static inline int dc_div3(int32_t a, int deep) {
  return deep ? divide3_s32(a) : divide3(a);
}


// ---------------------------------------------------------------------------
// Bit writer (MSB first) + exp-Golomb

// Bit reader with guard bit (schrounpack semantics)
struct BitReader {
  const uint8_t* buf;
  int64_t limit;  // bit limit
  int64_t pos;
  int guard;

  void init(const uint8_t* b, int64_t limit_bits, int g) {
    buf = b; limit = limit_bits; pos = 0; guard = g;
  }
  inline int get_bit() {
    if (pos >= limit) { pos++; return guard; }
    int b = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  inline uint64_t get_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint64_t)get_bit();
    return v;
  }
  inline int64_t get_uint() {
    int64_t v = 1;
    while (!get_bit()) v = (v << 1) | get_bit();
    return v - 1;
  }
  inline int64_t get_sint() {
    int64_t m = get_uint();
    if (m && get_bit()) return -m;
    return m;
  }
};

// ---------------------------------------------------------------------------
// Arithmetic coder (bit-exact; see coding/arith.py for the derivation)

struct ArithDec {
  uint32_t range, code;
  int64_t offset, len;
  int cntr;
  const uint8_t* data;
  uint16_t prob[CTX_LAST];

  void init(const uint8_t* d, int64_t l) {
    data = d; len = l;
    range = 0xFFFF0000;
    code = ((uint32_t)(l > 0 ? d[0] : 0xFF) << 24)
         | ((uint32_t)(l > 1 ? d[1] : 0xFF) << 16)
         | ((uint32_t)(l > 2 ? d[2] : 0xFF) << 8)
         | (uint32_t)(l > 3 ? d[3] : 0xFF);
    offset = 3;
    cntr = 16;
    for (int i = 0; i < CTX_LAST; i++) prob[i] = 0x8000;
  }

  inline int decode_bit(int i) {
    while (range <= 0x40000000u) {
      range <<= 1;
      code <<= 1;
      if (--cntr == 0) {
        offset++;
        code |= (uint32_t)(offset < len ? data[offset] : 0xFF) << 8;
        offset++;
        code |= (uint32_t)(offset < len ? data[offset] : 0xFF);
        cntr = 16;
      }
    }
    uint32_t p0 = prob[i];
    uint32_t rxp = ((range >> 16) * p0) & 0xFFFF0000u;
    int value = code >= rxp;
    if (value) {
      prob[i] = (uint16_t)(p0 - ALUT[p0 >> 8]);
      code -= rxp;
      range -= rxp;
    } else {
      prob[i] = (uint16_t)(p0 + ALUT[255 - (p0 >> 8)]);
      range = rxp;
    }
    return value;
  }

  inline int64_t decode_uint(int cont_ctx, int value_ctx) {
    int64_t bits = 1;
    while (!decode_bit(cont_ctx)) {
      bits = (bits << 1) | decode_bit(value_ctx);
      cont_ctx = NEXT_CTX[cont_ctx];
    }
    return bits - 1;
  }

  inline int64_t decode_sint(int cont_ctx, int value_ctx, int sign_ctx) {
    int64_t v = decode_uint(cont_ctx, value_ctx);
    if (v && decode_bit(sign_ctx)) return -v;
    return v;
  }
};

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

extern "C" {

// In-place DC prediction integration over an LL band (decoder side).
void dc_predict_integrate(int32_t* b, int h, int w, int deep) {
  for (int i = 1; i < w; i++) b[i] += b[i - 1];
  for (int j = 1; j < h; j++) {
    int32_t* line = b + (int64_t)j * w;
    int32_t* prev = line - w;
    line[0] += prev[0];
    for (int i = 1; i < w; i++) {
      line[i] += dc_div3(line[i - 1] + prev[i] + prev[i - 1] + 1, deep);
    }
  }
}

// ---------------------------------------------------------------------------
// Dirac subband codeblock coding (intra + inter residuals)

static void cb_bounds(int size, int n, int idx, int* lo, int* hi) {
  *lo = (size * idx) / n;
  *hi = (size * (idx + 1)) / n;
}

// Decode one subband (dequantised values; DC prediction NOT applied).
void subband_decode_arith(
    const uint8_t* payload, int64_t payload_len,
    int h, int w, int quant_index,
    const int32_t* parent_deq, int pw,
    int position, int hcb, int vcb, int have_quant_offset, int is_intra,
    int num_refs, int32_t* out) {
  ArithDec dec;
  dec.init(payload, payload_len);
  bool have_zero_flags = hcb > 1 || vcb > 1;
  bool horiz = (position & 3) == 2;
  bool vert = (position & 3) == 1;
  bool have_parent = position >= 4;
  int qi = quant_index;

  memset(out, 0, sizeof(int32_t) * (size_t)h * w);

  for (int cy = 0; cy < vcb; cy++) {
    int y0, y1;
    cb_bounds(h, vcb, cy, &y0, &y1);
    for (int cx = 0; cx < hcb; cx++) {
      int x0, x1;
      cb_bounds(w, hcb, cx, &x0, &x1);
      if (have_zero_flags) {
        if (dec.decode_bit(CTX_ZERO_CODEBLOCK)) continue;
      }
      if (have_quant_offset) {
        qi += (int)dec.decode_sint(CTX_QUANTISER_CONT, CTX_QUANTISER_VALUE,
                                   CTX_QUANTISER_SIGN);
        qi = std::min(std::max(qi, 0), 60);
      }
      int64_t qf = QUANT_FACTOR[qi];
      int64_t qo = (num_refs > 0) ? QUANT_OFFSET_3_8[qi] : QUANT_OFFSET_1_2[qi];
      for (int j = y0; j < y1; j++) {
        int32_t* line = out + (int64_t)j * w;
        int32_t* prev = line - w;
        const int32_t* parent_line =
            have_parent ? parent_deq + (int64_t)(j >> 1) * pw : nullptr;
        for (int i = x0; i < x1; i++) {
          int parent = have_parent ? parent_line[i >> 1] : 0;
          int nhood = 0;
          if (j > 0) nhood |= prev[i];
          if (i > 0) nhood |= line[i - 1];
          if (i > 0 && j > 0) nhood |= prev[i - 1];
          int prev_v = 0;
          if (horiz) { if (i > 0) prev_v = line[i - 1]; }
          else if (vert) { if (j > 0) prev_v = prev[i]; }
          int sign_ctx = prev_v < 0 ? CTX_SIGN_NEG
                        : (prev_v > 0 ? CTX_SIGN_POS : CTX_SIGN_ZERO);
          int cont = parent == 0 ? (nhood ? CTX_ZPNN_F1 : CTX_ZPZN_F1)
                                 : (nhood ? CTX_NPNN_F1 : CTX_NPZN_F1);
          int64_t v = dec.decode_uint(cont, CTX_COEFF_DATA);
          if (v) {
            v = (qo + qf * v + 2) >> 2;
            if (dec.decode_bit(sign_ctx)) v = -v;
          }
          line[i] = (int32_t)v;
        }
      }
    }
  }
  (void)is_intra;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Motion block data decode (schrodecoder.c:2556-2816).
//
// 9 independent entropy streams: superblock, pred_mode, vec ref1 x/y,
// vec ref2 x/y, dc 0/1/2. Outputs per-block MV fields.

extern "C" {

struct MvArrays {
  int32_t* split;
  int32_t* pred_mode;
  int32_t* using_global;
  int32_t* dx1;
  int32_t* dy1;
  int32_t* dx2;
  int32_t* dy2;
  int32_t* dc0;
  int32_t* dc1;
  int32_t* dc2;
};

namespace {

struct MvCtx {
  ArithDec arith[9];
  BitReader unpack[9];
  bool has[9];
  bool noarith;
  int xnb, ynb, num_refs, have_global;
  MvArrays out;

  int64_t dec_uint(int s, int cont_ctx, int value_ctx) {
    if (noarith) return unpack[s].get_uint();
    return arith[s].decode_uint(cont_ctx, value_ctx);
  }
  int64_t dec_sint(int s, int cc, int vc, int sc) {
    if (noarith) return unpack[s].get_sint();
    return arith[s].decode_sint(cc, vc, sc);
  }
  int dec_bit(int s, int ctx) {
    if (noarith) return unpack[s].get_bit();
    return arith[s].decode_bit(ctx);
  }
};

static int median3i(int a, int b, int c) {
  if (a < b) {
    if (b < c) return b;
    if (c < a) return a;
    return c;
  } else {
    if (a < c) return a;
    if (c < b) return b;
    return c;
  }
}

static int mode_prediction(MvCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (y == 0) {
    if (x == 0) return 0;
    return m->out.pred_mode[x - 1];
  }
  if (x == 0) return m->out.pred_mode[(y - 1) * xnb];
  int a = m->out.pred_mode[y * xnb + x - 1];
  int b = m->out.pred_mode[(y - 1) * xnb + x];
  int c = m->out.pred_mode[(y - 1) * xnb + x - 1];
  return (a & b) | (b & c) | (c & a);
}

static int split_prediction(MvCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (y == 0) {
    if (x == 0) return 0;
    return m->out.split[x - 4];
  }
  if (x == 0) return m->out.split[(y - 4) * xnb];
  int sum = m->out.split[(y - 4) * xnb + x]
          + m->out.split[y * xnb + x - 4]
          + m->out.split[(y - 4) * xnb + x - 4];
  return (sum + 1) / 3;
}

static int global_prediction(MvCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (x == 0 && y == 0) return 0;
  if (y == 0) return m->out.using_global[x - 1];
  if (x == 0) return m->out.using_global[(y - 1) * xnb];
  int sum = m->out.using_global[y * xnb + x - 1]
          + m->out.using_global[(y - 1) * xnb + x]
          + m->out.using_global[(y - 1) * xnb + x - 1];
  return sum >= 2;
}

static void dc_prediction(MvCtx* m, int x, int y, int pred[3]) {
  int xnb = m->xnb;
  const int32_t* dcs[3] = {m->out.dc0, m->out.dc1, m->out.dc2};
  for (int k = 0; k < 3; k++) {
    int sum = 0, n = 0;
    if (x > 0 && m->out.pred_mode[y * xnb + x - 1] == 0) {
      sum += dcs[k][y * xnb + x - 1]; n++;
    }
    if (y > 0 && m->out.pred_mode[(y - 1) * xnb + x] == 0) {
      sum += dcs[k][(y - 1) * xnb + x]; n++;
    }
    if (x > 0 && y > 0 && m->out.pred_mode[(y - 1) * xnb + x - 1] == 0) {
      sum += dcs[k][(y - 1) * xnb + x - 1]; n++;
    }
    switch (n) {
      case 0: pred[k] = 0; break;
      case 1: pred[k] = (int16_t)sum; break;
      case 2: pred[k] = (sum + 1) >> 1; break;
      default: pred[k] = divide3(sum + 1); break;
    }
  }
}

static void vector_prediction(MvCtx* m, int x, int y, int* px, int* py,
                              int mode) {
  int xnb = m->xnb;
  int ref = mode - 1;
  const int32_t* dxs = ref == 0 ? m->out.dx1 : m->out.dx2;
  const int32_t* dys = ref == 0 ? m->out.dy1 : m->out.dy2;
  int vx[3], vy[3];
  int n = 0;
  if (x > 0) {
    int idx = y * xnb + x - 1;
    if (!m->out.using_global[idx] && (m->out.pred_mode[idx] & mode)) {
      vx[n] = dxs[idx]; vy[n] = dys[idx]; n++;
    }
  }
  if (y > 0) {
    int idx = (y - 1) * xnb + x;
    if (!m->out.using_global[idx] && (m->out.pred_mode[idx] & mode)) {
      vx[n] = dxs[idx]; vy[n] = dys[idx]; n++;
    }
  }
  if (x > 0 && y > 0) {
    int idx = (y - 1) * xnb + x - 1;
    if (!m->out.using_global[idx] && (m->out.pred_mode[idx] & mode)) {
      vx[n] = dxs[idx]; vy[n] = dys[idx]; n++;
    }
  }
  switch (n) {
    case 0: *px = 0; *py = 0; break;
    case 1: *px = vx[0]; *py = vy[0]; break;
    case 2:
      *px = (vx[0] + vx[1] + 1) >> 1;
      *py = (vy[0] + vy[1] + 1) >> 1;
      break;
    default:
      *px = median3i(vx[0], vx[1], vx[2]);
      *py = median3i(vy[0], vy[1], vy[2]);
      break;
  }
}

enum { S_SB = 0, S_PM = 1, S_V1X = 2, S_V1Y = 3, S_V2X = 4, S_V2Y = 5,
       S_DC0 = 6, S_DC1 = 7, S_DC2 = 8 };

static void decode_prediction_unit(MvCtx* m, int x, int y) {
  int xnb = m->xnb;
  int idx = y * xnb + x;
  int mode = mode_prediction(m, x, y);
  mode ^= m->dec_bit(S_PM, CTX_BLOCK_MODE_REF1);
  if (m->num_refs > 1) {
    mode ^= m->dec_bit(S_PM, CTX_BLOCK_MODE_REF2) << 1;
  }
  m->out.pred_mode[idx] = mode;
  m->out.using_global[idx] = 0;
  m->out.dx1[idx] = m->out.dy1[idx] = 0;
  m->out.dx2[idx] = m->out.dy2[idx] = 0;
  m->out.dc0[idx] = m->out.dc1[idx] = m->out.dc2[idx] = 0;

  if (mode == 0) {
    int pred[3];
    dc_prediction(m, x, y, pred);
    m->out.dc0[idx] = pred[0] + (int)m->dec_sint(
        S_DC0, CTX_LUMA_DC_CONT_BIN1, CTX_LUMA_DC_VALUE, CTX_LUMA_DC_SIGN);
    m->out.dc1[idx] = pred[1] + (int)m->dec_sint(
        S_DC1, CTX_CHROMA1_DC_CONT_BIN1, CTX_CHROMA1_DC_VALUE,
        CTX_CHROMA1_DC_SIGN);
    m->out.dc2[idx] = pred[2] + (int)m->dec_sint(
        S_DC2, CTX_CHROMA2_DC_CONT_BIN1, CTX_CHROMA2_DC_VALUE,
        CTX_CHROMA2_DC_SIGN);
  } else {
    if (m->have_global) {
      int pred = global_prediction(m, x, y);
      m->out.using_global[idx] = pred ^ m->dec_bit(S_PM, CTX_GLOBAL_BLOCK);
    }
    if (!m->out.using_global[idx]) {
      if (mode & 1) {
        int px, py;
        vector_prediction(m, x, y, &px, &py, 1);
        m->out.dx1[idx] = px + (int)m->dec_sint(
            S_V1X, CTX_MV_REF1_H_CONT_BIN1, CTX_MV_REF1_H_VALUE,
            CTX_MV_REF1_H_SIGN);
        m->out.dy1[idx] = py + (int)m->dec_sint(
            S_V1Y, CTX_MV_REF1_V_CONT_BIN1, CTX_MV_REF1_V_VALUE,
            CTX_MV_REF1_V_SIGN);
      }
      if (mode & 2) {
        int px, py;
        vector_prediction(m, x, y, &px, &py, 2);
        m->out.dx2[idx] = px + (int)m->dec_sint(
            S_V2X, CTX_MV_REF2_H_CONT_BIN1, CTX_MV_REF2_H_VALUE,
            CTX_MV_REF2_H_SIGN);
        m->out.dy2[idx] = py + (int)m->dec_sint(
            S_V2Y, CTX_MV_REF2_V_CONT_BIN1, CTX_MV_REF2_V_VALUE,
            CTX_MV_REF2_V_SIGN);
      }
    }
  }
}

static void copy_block(MvCtx* m, int dst, int src) {
  MvArrays& o = m->out;
  o.split[dst] = o.split[src];
  o.pred_mode[dst] = o.pred_mode[src];
  o.using_global[dst] = o.using_global[src];
  o.dx1[dst] = o.dx1[src];
  o.dy1[dst] = o.dy1[src];
  o.dx2[dst] = o.dx2[src];
  o.dy2[dst] = o.dy2[src];
  o.dc0[dst] = o.dc0[src];
  o.dc1[dst] = o.dc1[src];
  o.dc2[dst] = o.dc2[src];
}

}  // namespace

void motion_decode(
    const uint8_t* data, const int64_t* offsets, const int64_t* lengths,
    int x_num_blocks, int y_num_blocks, int num_refs, int have_global,
    int is_noarith,
    int32_t* split, int32_t* pred_mode, int32_t* using_global,
    int32_t* dx1, int32_t* dy1, int32_t* dx2, int32_t* dy2,
    int32_t* dc0, int32_t* dc1, int32_t* dc2) {
  MvCtx m;
  m.noarith = is_noarith != 0;
  m.xnb = x_num_blocks;
  m.ynb = y_num_blocks;
  m.num_refs = num_refs;
  m.have_global = have_global;
  m.out = MvArrays{split, pred_mode, using_global, dx1, dy1, dx2, dy2,
                   dc0, dc1, dc2};
  int n = x_num_blocks * y_num_blocks;
  memset(split, 0, 4 * n);
  memset(pred_mode, 0, 4 * n);
  memset(using_global, 0, 4 * n);
  memset(dx1, 0, 4 * n); memset(dy1, 0, 4 * n);
  memset(dx2, 0, 4 * n); memset(dy2, 0, 4 * n);
  memset(dc0, 0, 4 * n); memset(dc1, 0, 4 * n); memset(dc2, 0, 4 * n);

  for (int s = 0; s < 9; s++) {
    m.has[s] = !(num_refs < 2 && (s == S_V2X || s == S_V2Y));
    if (!m.has[s]) continue;
    if (m.noarith) {
      m.unpack[s].init(data + offsets[s], lengths[s] * 8, 1);
    } else {
      m.arith[s].init(data + offsets[s], lengths[s]);
    }
  }

  int xnb = x_num_blocks;
  for (int j = 0; j < y_num_blocks; j += 4) {
    for (int i = 0; i < x_num_blocks; i += 4) {
      int sp = split_prediction(&m, i, j);
      int split_v = (sp + (int)m.dec_uint(S_SB, CTX_SB_F1, CTX_SB_DATA)) % 3;
      if (split_v < 0) split_v = 0;
      int base = j * xnb + i;
      m.out.split[base] = split_v;

      switch (split_v) {
        case 0: {
          decode_prediction_unit(&m, i, j);
          m.out.split[base] = split_v;
          for (int l = 0; l < 4; l++)
            for (int k = 0; k < 4; k++) {
              if (l == 0 && k == 0) continue;
              copy_block(&m, (j + l) * xnb + i + k, base);
              m.out.split[(j + l) * xnb + i + k] = split_v;
            }
          break;
        }
        case 1: {
          decode_prediction_unit(&m, i, j);
          m.out.split[base] = 1;
          copy_block(&m, base + 1, base);
          decode_prediction_unit(&m, i + 2, j);
          m.out.split[base + 2] = 1;
          copy_block(&m, base + 3, base + 2);
          for (int k = 0; k < 4; k++)
            copy_block(&m, base + xnb + k, base + k);
          int b2 = (j + 2) * xnb + i;
          decode_prediction_unit(&m, i, j + 2);
          m.out.split[b2] = 1;
          copy_block(&m, b2 + 1, b2);
          decode_prediction_unit(&m, i + 2, j + 2);
          m.out.split[b2 + 2] = 1;
          copy_block(&m, b2 + 3, b2 + 2);
          for (int k = 0; k < 4; k++)
            copy_block(&m, b2 + xnb + k, b2 + k);
          break;
        }
        case 2: {
          for (int l = 0; l < 4; l++)
            for (int k = 0; k < 4; k++) {
              m.out.split[(j + l) * xnb + i + k] = 2;
              decode_prediction_unit(&m, i + k, j + l);
            }
          break;
        }
      }
    }
  }
}

}  // extern "C"
