// Native coding layer: the serial bit-plumbing of the codec.
//
// TPU (XLA/Pallas) owns the dense math (wavelets, quantisation estimates,
// motion); this C++ layer owns what is inherently sequential per stream:
//   - Dirac adaptive binary arithmetic coder (bit-exact with the reference
//     state machine, schroarith.h:146-335)
//   - interleaved exp-Golomb bit packing/unpacking (schropack.c/schrounpack.c)
//   - VC-2 low-delay slice search + DC prediction chains + payload packing
//     (schrolowdelay.c:766-1200)
//   - Dirac subband codeblock entropy coding (schroencoder.c:3798-4072,
//     schrodecoder.c:3018-3100)
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

// Exact magic division for the quantiser divisors: floor(n / d) ==
// (n * M) >> S for all n in [0, 2^22], verified at init.
struct MagicDiv { uint64_t M; int S; };
static MagicDiv QF_MAGIC[61];
static bool qf_magic_init_done = false;
static void qf_magic_init() {
  if (qf_magic_init_done) return;
  for (int i = 0; i < 61; i++) {
    uint64_t d = QUANT_FACTOR[i];
    int S = 42;
    uint64_t M = ((__uint128_t(1) << S) + d - 1) / d;  // ceil(2^S/d)
    QF_MAGIC[i].M = M;
    QF_MAGIC[i].S = S;
  }
  qf_magic_init_done = true;
}

static inline int64_t quantise1(int64_t v, int64_t qf, int64_t qo) {
  if (v == 0) return 0;
  int64_t x = (v < 0 ? -v : v) << 2;
  if (x < qo) return 0;
  int64_t q = (x - (qo - qf / 2)) / qf;
  return v < 0 ? -q : q;
}

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

static inline int sint_bits(int64_t v) {
  uint64_t m = (uint64_t)(v < 0 ? -v : v);
  int n = 64 - __builtin_clzll(m + 1);
  return 2 * n - 1 + (m != 0 ? 1 : 0);
}

// ---------------------------------------------------------------------------
// Bit writer (MSB first) + exp-Golomb

struct BitWriter {
  uint8_t* buf;
  int64_t capacity;  // bytes
  int64_t pos;       // bit position

  void init(uint8_t* b, int64_t cap) { buf = b; capacity = cap; pos = 0; }

  inline void put_bit(int b) {
    int64_t byte = pos >> 3;
    int sh = 7 - (pos & 7);
    if (b) buf[byte] |= (uint8_t)(1u << sh);
    else buf[byte] &= (uint8_t)~(1u << sh);
    pos++;
  }
  inline void put_bits(int n, uint64_t v) {
    for (int i = n - 1; i >= 0; i--) put_bit((v >> i) & 1);
  }
  inline void put_uint(uint64_t v) {
    uint64_t t = v + 1;
    int n = 64 - __builtin_clzll(t);
    for (int i = n - 2; i >= 0; i--) {
      put_bit(0);
      put_bit((t >> i) & 1);
    }
    put_bit(1);
  }
  inline void put_sint(int64_t v) {
    uint64_t m = (uint64_t)(v < 0 ? -v : v);
    put_uint(m);
    if (m) put_bit(v < 0 ? 1 : 0);
  }
};

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

struct ArithEnc {
  uint32_t low, range;
  int cntr, carry;
  uint8_t* out;
  int64_t n, capacity;
  uint16_t prob[CTX_LAST];

  void init(uint8_t* buf, int64_t cap) {
    low = 0; range = 0xFFFF; cntr = 0; carry = 0; out = buf; n = 0;
    capacity = cap;
    for (int i = 0; i < CTX_LAST; i++) prob[i] = 0x8000;
  }

  inline void encode_bit(int i, int value) {
    uint32_t p0 = prob[i];
    uint32_t rxp = (range * p0) >> 16;
    if (value) {
      low += rxp;
      range -= rxp;
      prob[i] = (uint16_t)(p0 - ALUT[p0 >> 8]);
    } else {
      range = rxp;
      prob[i] = (uint16_t)(p0 + ALUT[255 - (p0 >> 8)]);
    }
    while (range <= 0x4000) {
      low <<= 1;
      range <<= 1;
      if (++cntr == 8) {
        if (low < (1u << 24) && (low + range) >= (1u << 24)) {
          carry++;
        } else {
          if (low >= (1u << 24)) {
            out[n - 1]++;
            while (carry) { out[n++] = 0x00; carry--; }
          } else {
            while (carry) { out[n++] = 0xFF; carry--; }
          }
          out[n++] = (uint8_t)(low >> 16);
        }
        low &= 0xFFFF;
        cntr = 0;
      }
    }
  }

  inline void encode_uint(int cont_ctx, int value_ctx, int64_t value) {
    uint64_t t = (uint64_t)value + 1;
    int nb = 64 - __builtin_clzll(t);
    for (int i = 0; i < nb - 1; i++) {
      encode_bit(cont_ctx, 0);
      encode_bit(value_ctx, (t >> (nb - 2 - i)) & 1);
      cont_ctx = NEXT_CTX[cont_ctx];
    }
    encode_bit(cont_ctx, 1);
  }

  inline void encode_sint(int cont_ctx, int value_ctx, int sign_ctx,
                          int64_t value) {
    int sign = value < 0;
    int64_t m = sign ? -value : value;
    encode_uint(cont_ctx, value_ctx, m);
    if (m) encode_bit(sign_ctx, sign);
  }

  int64_t flush() {
    bool extra_byte = cntr > 0;
    int i;
    for (i = 0; i < 16; i++) {
      if ((low | ((1u << (i + 1)) - 1)) > range - 1) break;
    }
    low |= (1u << i) - 1;
    while (cntr < 8) {
      low = (low << 1) | 1;
      cntr++;
    }
    if (low >= (1u << 24)) {
      out[n - 1]++;
      while (carry) { out[n++] = 0x00; carry--; }
    } else {
      while (carry) { out[n++] = 0xFF; carry--; }
    }
    out[n++] = (uint8_t)(low >> 16);
    out[n++] = (uint8_t)(low >> 8);
    if (extra_byte) out[n++] = (uint8_t)low;
    while (n > 1 && out[n - 1] == 0xFF) n--;
    return n;
  }
};

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

static inline int ilog2up(uint32_t x) {
  int i = 0;
  while (x) { x >>= 1; i++; }
  return i;
}

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

extern "C" {

// ---------------------------------------------------------------------------
// VC-2 low-delay slice encoding.
//
// Inputs are slice-ordered coefficient tensors (as produced on TPU):
//   comp[c]: int32 array (ny*nx, S_c), DC block first within each slice.
// qmo[c]: per-position quant matrix offsets. slice_bytes: per slice.
// Output: packed payload (sum of slice_bytes), chosen base per slice.

struct LdPlane {
  const int32_t* data;  // (ny*nx, S)
  const int32_t* qmo;   // (S,)
  int S;
  int dcs;    // DC block size per slice
  int bh, bw; // DC block dims per slice
  int llw, llh;
};

static void ld_quant_dc_block(
    const int32_t* orig_ll, int32_t* recon_ll, int llw,
    int y0, int y1, int x0, int x1, int qi, int64_t* out, int deep) {
  int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
  int n = 0;
  for (int y = y0; y < y1; y++) {
    for (int x = x0; x < x1; x++) {
      int pred;
      if (y > 0) {
        if (x > 0)
          pred = dc_div3(recon_ll[y * llw + x - 1] + recon_ll[(y - 1) * llw + x]
                         + recon_ll[(y - 1) * llw + x - 1] + 1, deep);
        else
          pred = recon_ll[(y - 1) * llw + x];
      } else {
        pred = x > 0 ? recon_ll[y * llw + x - 1] : 0;
      }
      int64_t d = (int64_t)orig_ll[y * llw + x] - pred;
      int64_t q = quantise1(d, qf, qo);
      recon_ll[y * llw + x] = (int32_t)(pred + dequantise1(q, qf, qo));
      out[n++] = q;
    }
  }
}

int64_t ld_encode(
    // planes: y, u, v slice tensors
    const int32_t* yd, const int32_t* ud, const int32_t* vd,
    const int32_t* y_qmo, const int32_t* uv_qmo,
    int ny, int nx, int Sy, int Suv,
    int y_bh, int y_bw, int uv_bh, int uv_bw,
    // LL planes (original coefficients) for DC chains
    const int32_t* y_ll, const int32_t* u_ll, const int32_t* v_ll,
    int y_llw, int y_llh, int uv_llw, int uv_llh,
    int dc_qm,  // quant_matrix[0]
    int deep,   // s32 (10/16-bit) DC divide semantics
    const int64_t* slice_bytes,
    uint8_t* out, int64_t out_capacity,
    int32_t* chosen_base_out) {
  qf_magic_init();
  int dcs_y = y_bh * y_bw;
  int dcs_uv = uv_bh * uv_bw;
  int n_slices = ny * nx;

  int32_t* y_recon = (int32_t*)calloc((size_t)y_llw * y_llh, 4);
  int32_t* u_recon = (int32_t*)calloc((size_t)uv_llw * uv_llh, 4);
  int32_t* v_recon = (int32_t*)calloc((size_t)uv_llw * uv_llh, 4);

  int64_t* dqy = (int64_t*)malloc(sizeof(int64_t) * dcs_y);
  int64_t* dqu = (int64_t*)malloc(sizeof(int64_t) * dcs_uv);
  int64_t* dqv = (int64_t*)malloc(sizeof(int64_t) * dcs_uv);
  // final quantised values per slice
  int64_t* qy = (int64_t*)malloc(sizeof(int64_t) * Sy);
  int64_t* qu = (int64_t*)malloc(sizeof(int64_t) * Suv);
  int64_t* qv = (int64_t*)malloc(sizeof(int64_t) * Suv);

  BitWriter bw;
  // zero output; fill pattern handled per-slice below
  memset(out, 0, (size_t)out_capacity);
  bw.init(out, out_capacity);

  int64_t total_bits = 0;
  int si = 0;
  for (int sy = 0; sy < ny; sy++) {
    for (int sx = 0; sx < nx; sx++, si++) {
      int sbytes = (int)slice_bytes[si];
      int length_bits = ilog2up(8 * (uint32_t)sbytes);
      const int32_t* yv = yd + (int64_t)si * Sy;
      const int32_t* uv_ = ud + (int64_t)si * Suv;
      const int32_t* vv = vd + (int64_t)si * Suv;

      int y_bits_f = 0, trail_y_f = 0, trail_uv_f = 0;

      // estimate(base): DC chains mutate recon; returns total bit estimate
      auto estimate = [&](int base) {
        int qi0 = std::min(std::max(base - dc_qm, 0), 60);
        ld_quant_dc_block(y_ll, y_recon, y_llw, sy * y_bh, (sy + 1) * y_bh,
                          sx * y_bw, (sx + 1) * y_bw, qi0, dqy, deep);
        ld_quant_dc_block(u_ll, u_recon, uv_llw, sy * uv_bh, (sy + 1) * uv_bh,
                          sx * uv_bw, (sx + 1) * uv_bw, qi0, dqu, deep);
        ld_quant_dc_block(v_ll, v_recon, uv_llw, sy * uv_bh, (sy + 1) * uv_bh,
                          sx * uv_bw, (sx + 1) * uv_bw, qi0, dqv, deep);

        // Y: DC then non-DC (magic-division fast path per qmo segment)
        int y_bits = 0;
        int y_last = -1;
        for (int k = 0; k < dcs_y; k++) {
          qy[k] = dqy[k];
          y_bits += sint_bits(dqy[k]);
          if (dqy[k]) y_last = k;
        }
        for (int seg = dcs_y; seg < Sy;) {
          int32_t qmo_v = y_qmo[seg];
          int seg_end = seg;
          while (seg_end < Sy && y_qmo[seg_end] == qmo_v) seg_end++;
          int qi = std::min(std::max(base - qmo_v, 0), 60);
          int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
          int64_t offset = qo - qf / 2;
          uint64_t M = QF_MAGIC[qi].M;
          int S = QF_MAGIC[qi].S;
          for (int k = seg; k < seg_end; k++) {
            int64_t v = yv[k];
            int64_t x = (v < 0 ? -v : v) << 2;
            int64_t mag = x < qo ? 0
                : (int64_t)(((__uint128_t)(uint64_t)(x - offset) * M) >> S);
            int64_t q = v < 0 ? -mag : mag;
            qy[k] = q;
            y_bits += sint_bits(q);
            if (q) y_last = k;
          }
          seg = seg_end;
        }
        int trail_y = (y_last >= 0) ? (Sy - 1 - y_last) : Sy;

        int u_bits = 0, v_bits = 0;
        int u_last = -1, v_last = -1;
        for (int k = 0; k < dcs_uv; k++) {
          qu[k] = dqu[k];
          qv[k] = dqv[k];
          u_bits += sint_bits(dqu[k]);
          v_bits += sint_bits(dqv[k]);
          if (dqu[k]) u_last = k;
          if (dqv[k]) v_last = k;
        }
        for (int seg = dcs_uv; seg < Suv;) {
          int32_t qmo_v = uv_qmo[seg];
          int seg_end = seg;
          while (seg_end < Suv && uv_qmo[seg_end] == qmo_v) seg_end++;
          int qi = std::min(std::max(base - qmo_v, 0), 60);
          int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
          int64_t offset = qo - qf / 2;
          uint64_t M = QF_MAGIC[qi].M;
          int S = QF_MAGIC[qi].S;
          for (int k = seg; k < seg_end; k++) {
            int64_t v1 = uv_[k];
            int64_t x1 = (v1 < 0 ? -v1 : v1) << 2;
            int64_t m1 = x1 < qo ? 0
                : (int64_t)(((__uint128_t)(uint64_t)(x1 - offset) * M) >> S);
            int64_t q1 = v1 < 0 ? -m1 : m1;
            int64_t v2 = vv[k];
            int64_t x2 = (v2 < 0 ? -v2 : v2) << 2;
            int64_t m2 = x2 < qo ? 0
                : (int64_t)(((__uint128_t)(uint64_t)(x2 - offset) * M) >> S);
            int64_t q2 = v2 < 0 ? -m2 : m2;
            qu[k] = q1;
            qv[k] = q2;
            u_bits += sint_bits(q1);
            v_bits += sint_bits(q2);
            if (q1) u_last = k;
            if (q2) v_last = k;
          }
          seg = seg_end;
        }
        int trail_u = (u_last >= 0) ? (Suv - 1 - u_last) : Suv;
        int trail_v = (v_last >= 0) ? (Suv - 1 - v_last) : Suv;
        int trail_uv = 2 * std::min(trail_u, trail_v);

        y_bits_f = y_bits;
        trail_y_f = trail_y;
        trail_uv_f = trail_uv;
        return 7 + length_bits + y_bits + u_bits + v_bits - trail_y - trail_uv;
      };

      // pick_slice_index (schrolowdelay.c:1117-1148)
      int base;
      int n_est = estimate(0);
      if (n_est <= sbytes * 8) {
        base = 0;
      } else {
        int i = 0;
        for (int size = 32; size >= 1; size >>= 1) {
          n_est = estimate(i + size);
          if (n_est >= sbytes * 8) i += size;
        }
        estimate(i + 1);
        base = i + 1;
      }
      chosen_base_out[si] = base;

      // emit slice
      int64_t start = bw.pos;
      bw.put_bits(7, base);
      int slice_y_length = y_bits_f - trail_y_f;
      bw.put_bits(length_bits, slice_y_length);
      int ny_coef = Sy - trail_y_f;
      for (int k = 0; k < ny_coef; k++) bw.put_sint(qy[k]);
      int nuv_pair = Suv - trail_uv_f / 2;
      for (int k = 0; k < nuv_pair; k++) {
        bw.put_sint(qu[k]);
        bw.put_sint(qv[k]);
      }
      int64_t used = bw.pos - start;
      int64_t cap_bits = (int64_t)sbytes * 8;
      if (used > cap_bits) {
        free(y_recon); free(u_recon); free(v_recon);
        free(dqy); free(dqu); free(dqv); free(qy); free(qu); free(qv);
        return -1;  // overflow: caller error
      }
      while (bw.pos < start + cap_bits) bw.put_bit(1);
      total_bits += used;
    }
  }

  free(y_recon); free(u_recon); free(v_recon);
  free(dqy); free(dqu); free(dqv); free(qy); free(qu); free(qv);
  return bw.pos / 8;
}

// Low-delay slice decoding: payload -> dequantised slice tensors.
int64_t ld_decode(
    const uint8_t* payload, int64_t payload_len,
    const int32_t* y_qmo, const int32_t* uv_qmo,
    int ny, int nx, int Sy, int Suv,
    int dc_qm_unused,
    const int64_t* slice_bytes,
    int32_t* y_out, int32_t* u_out, int32_t* v_out,
    int32_t* base_out) {
  (void)dc_qm_unused;
  int n_slices = ny * nx;
  int64_t off_bytes = 0;
  for (int si = 0; si < n_slices; si++) {
    int sbytes = (int)slice_bytes[si];
    const uint8_t* sdata = payload + off_bytes;
    if (off_bytes + sbytes > payload_len) return -1;
    int length_bits = ilog2up(8 * (uint32_t)sbytes);

    BitReader r;
    r.init(sdata, (int64_t)sbytes * 8, 1);
    int base = (int)r.get_bits(7);
    base_out[si] = base;
    int64_t y_len = (int64_t)r.get_bits(length_bits);

    BitReader ry = r;
    ry.limit = std::min(ry.limit, ry.pos + y_len);
    BitReader ruv = r;
    ruv.pos += y_len;

    int32_t* yv = y_out + (int64_t)si * Sy;
    for (int k = 0; k < Sy; k++) {
      int qi = std::min(std::max(base - y_qmo[k], 0), 60);
      int64_t q = ry.get_sint();
      yv[k] = (int32_t)dequantise1(q, QUANT_FACTOR[qi], QUANT_OFFSET_1_2[qi]);
    }
    int32_t* uv_ = u_out + (int64_t)si * Suv;
    int32_t* vv = v_out + (int64_t)si * Suv;
    for (int k = 0; k < Suv; k++) {
      int qi = std::min(std::max(base - uv_qmo[k], 0), 60);
      int64_t fq = QUANT_FACTOR[qi], fo = QUANT_OFFSET_1_2[qi];
      uv_[k] = (int32_t)dequantise1(ruv.get_sint(), fq, fo);
      vv[k] = (int32_t)dequantise1(ruv.get_sint(), fq, fo);
    }
    off_bytes += sbytes;
  }
  return off_bytes;
}

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

// Encode one quantised subband with arith contexts. Returns payload length.
int64_t subband_encode_arith(
    const int32_t* qdata, int h, int w,
    const int32_t* parent_deq, int pw,  // parent width (0 if none)
    int position, int hcb, int vcb, int have_quant_offset,
    const int32_t* quant_indices,  // (vcb, hcb)
    uint8_t* out, int64_t out_capacity, int32_t* first_qi_out) {
  ArithEnc enc;
  enc.init(out, out_capacity);
  bool have_zero_flags = hcb > 1 || vcb > 1;
  bool horiz = (position & 3) == 2;
  bool vert = (position & 3) == 1;
  bool have_parent = position >= 4;
  int first_qi = -1, run_qi = 0;

  for (int cy = 0; cy < vcb; cy++) {
    int y0, y1;
    cb_bounds(h, vcb, cy, &y0, &y1);
    for (int cx = 0; cx < hcb; cx++) {
      int x0, x1;
      cb_bounds(w, hcb, cx, &x0, &x1);
      if (have_zero_flags) {
        int zero = 1;
        for (int j = y0; j < y1 && zero; j++)
          for (int i = x0; i < x1; i++)
            if (qdata[(int64_t)j * w + i]) { zero = 0; break; }
        enc.encode_bit(CTX_ZERO_CODEBLOCK, zero);
        if (zero) continue;
      }
      if (have_quant_offset) {
        int new_qi = quant_indices[cy * hcb + cx];
        if (first_qi == -1) { run_qi = new_qi; first_qi = new_qi; }
        enc.encode_sint(CTX_QUANTISER_CONT, CTX_QUANTISER_VALUE,
                        CTX_QUANTISER_SIGN, new_qi - run_qi);
        run_qi = new_qi;
      }
      for (int j = y0; j < y1; j++) {
        const int32_t* line = qdata + (int64_t)j * w;
        const int32_t* prev = line - w;
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
          enc.encode_sint(cont, CTX_COEFF_DATA, sign_ctx, line[i]);
        }
      }
    }
  }
  *first_qi_out = first_qi;
  return enc.flush();
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

// Raw (quantised) variant of subband_decode_arith: stores the SIGNED
// quantised magnitudes instead of dequantised values, and records the
// per-codeblock quant index actually used, so the dequantisation can run
// on device with the uploaded quantised data (half the wire bytes).
// Context modeling is unchanged — parent / neighborhood / sign contexts
// are zero- and sign-tests, for which quantised and dequantised values
// are interchangeable (the caller must then also pass a QUANTISED parent
// band).
void subband_decode_arith_raw(
    const uint8_t* payload, int64_t payload_len,
    int h, int w, int quant_index,
    const int32_t* parent_q, int pw,
    int position, int hcb, int vcb, int have_quant_offset,
    int32_t* out, int32_t* qi_out) {
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
        if (dec.decode_bit(CTX_ZERO_CODEBLOCK)) {
          qi_out[cy * hcb + cx] = qi;
          continue;
        }
      }
      if (have_quant_offset) {
        qi += (int)dec.decode_sint(CTX_QUANTISER_CONT, CTX_QUANTISER_VALUE,
                                   CTX_QUANTISER_SIGN);
        qi = std::min(std::max(qi, 0), 60);
      }
      qi_out[cy * hcb + cx] = qi;
      for (int j = y0; j < y1; j++) {
        int32_t* line = out + (int64_t)j * w;
        int32_t* prev = line - w;
        const int32_t* parent_line =
            have_parent ? parent_q + (int64_t)(j >> 1) * pw : nullptr;
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
          if (v && dec.decode_bit(sign_ctx)) v = -v;
          line[i] = (int32_t)v;
        }
      }
    }
  }
}

// Quantise a full subband codeblock-wise; DC prediction for intra band 0.
// data in/out: int32 (h, w). Writes quantised into qout, dequantised into
// data (in place), matching schro_encoder_quantise_subband.
void subband_quantise(
    int32_t* data, int h, int w, int position,
    int hcb, int vcb, const int32_t* quant_indices, int is_intra,
    int num_refs, int deep, int32_t* qout) {
  for (int cy = 0; cy < vcb; cy++) {
    int y0, y1;
    cb_bounds(h, vcb, cy, &y0, &y1);
    for (int cx = 0; cx < hcb; cx++) {
      int x0, x1;
      cb_bounds(w, hcb, cx, &x0, &x1);
      int qi = quant_indices[cy * hcb + cx];
      int64_t qf = QUANT_FACTOR[qi];
      int64_t qo = is_intra ? QUANT_OFFSET_1_2[qi] : QUANT_OFFSET_3_8[qi];
      if (num_refs == 0 && position == 0 && is_intra) {
        for (int j = y0; j < y1; j++) {
          for (int i = x0; i < x1; i++) {
            int pred;
            // reference tests (codeblock idx + relative pos) > 0, which is
            // equivalent to the global position check (schroencoder.c:3611)
            if (j > 0) {
              if (i > 0)
                pred = dc_div3(data[(int64_t)j * w + i - 1]
                               + data[(int64_t)(j - 1) * w + i]
                               + data[(int64_t)(j - 1) * w + i - 1] + 1, deep);
              else
                pred = data[(int64_t)(j - 1) * w + i];
            } else {
              pred = (i > 0) ? data[(int64_t)j * w + i - 1] : 0;
            }
            int64_t q = quantise1((int64_t)data[(int64_t)j * w + i] - pred,
                                  qf, qo);
            qout[(int64_t)j * w + i] = (int32_t)q;
            data[(int64_t)j * w + i] =
                (int32_t)(dequantise1(q, qf, qo) + pred);
          }
        }
      } else {
        for (int j = y0; j < y1; j++) {
          for (int i = x0; i < x1; i++) {
            int64_t q = quantise1(data[(int64_t)j * w + i], qf, qo);
            qout[(int64_t)j * w + i] = (int32_t)q;
            data[(int64_t)j * w + i] = (int32_t)dequantise1(q, qf, qo);
          }
        }
      }
    }
  }
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

// ---------------------------------------------------------------------------
// No-arith (VC-2 simple) subband coding: raw exp-Golomb in codeblock order
// (schroencoder.c schro_encoder_encode_subband_noarith,
//  schrodecoder.c schro_decoder_decode_codeblock_noarith).

extern "C" {

int64_t subband_encode_noarith(
    const int32_t* qdata, int h, int w,
    int position, int hcb, int vcb, int have_quant_offset_mode,
    uint8_t* out, int64_t out_capacity) {
  BitWriter bw;
  memset(out, 0, out_capacity);
  bw.init(out, out_capacity);
  // encoder rule: zero flags only when split AND index > 0 (position > 0)
  bool have_zero_flags = (hcb > 1 || vcb > 1) && position > 0;
  bool have_quant_offset = (hcb > 1 || vcb > 1) && have_quant_offset_mode;

  for (int cy = 0; cy < vcb; cy++) {
    int y0, y1;
    cb_bounds(h, vcb, cy, &y0, &y1);
    for (int cx = 0; cx < hcb; cx++) {
      int x0, x1;
      cb_bounds(w, hcb, cx, &x0, &x1);
      if (have_zero_flags) {
        int zero = 1;
        for (int j = y0; j < y1 && zero; j++)
          for (int i = x0; i < x1; i++)
            if (qdata[(int64_t)j * w + i]) { zero = 0; break; }
        bw.put_bit(zero);
        if (zero) continue;
      }
      if (have_quant_offset) bw.put_sint(0);
      for (int j = y0; j < y1; j++)
        for (int i = x0; i < x1; i++)
          bw.put_sint(qdata[(int64_t)j * w + i]);
    }
  }
  // pack flush = byte align with zero bits
  return (bw.pos + 7) / 8;
}

void subband_decode_noarith(
    const uint8_t* payload, int64_t payload_len,
    int h, int w, int quant_index,
    int position, int hcb, int vcb, int have_quant_offset_mode,
    int num_refs, int32_t* out) {
  BitReader r;
  r.init(payload, payload_len * 8, 1);
  bool have_zero_flags = (hcb > 1 || vcb > 1) && position > 0;
  bool have_quant_offset = (hcb > 1 || vcb > 1) && have_quant_offset_mode;
  int qi = quant_index;
  memset(out, 0, sizeof(int32_t) * (size_t)h * w);

  for (int cy = 0; cy < vcb; cy++) {
    int y0, y1;
    cb_bounds(h, vcb, cy, &y0, &y1);
    for (int cx = 0; cx < hcb; cx++) {
      int x0, x1;
      cb_bounds(w, hcb, cx, &x0, &x1);
      if (have_zero_flags) {
        if (r.get_bit()) continue;
      }
      if (have_quant_offset) {
        qi += (int)r.get_sint();
        qi = std::min(std::max(qi, 0), 60);
      }
      int64_t qf = QUANT_FACTOR[qi];
      int64_t qo = num_refs > 0 ? QUANT_OFFSET_3_8[qi] : QUANT_OFFSET_1_2[qi];
      for (int j = y0; j < y1; j++)
        for (int i = x0; i < x1; i++)
          out[(int64_t)j * w + i] = (int32_t)dequantise1(r.get_sint(), qf, qo);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Motion block data ENCODE (mirror of motion_decode; encoder side of
// schroencoder.c schro_encoder_encode_superblock_split/prediction_modes/
// vector_data/dc_data). Uses the same spatial predictions; 9 streams.

extern "C" {

namespace {

struct MvEncCtx {
  ArithEnc arith[9];
  BitWriter pack[9];
  bool noarith;
  int xnb, ynb, num_refs, have_global;
  MvArrays in;  // inputs to encode

  void enc_uint(int s, int cc, int vc, int64_t v) {
    if (noarith) pack[s].put_uint(v);
    else arith[s].encode_uint(cc, vc, v);
  }
  void enc_sint(int s, int cc, int vc, int sc, int64_t v) {
    if (noarith) pack[s].put_sint(v);
    else arith[s].encode_sint(cc, vc, sc, v);
  }
  void enc_bit(int s, int ctx, int v) {
    if (noarith) pack[s].put_bit(v);
    else arith[s].encode_bit(ctx, v);
  }
};

// reuse the same spatial predictors via a shim over MvArrays
static int e_mode_prediction(MvEncCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (y == 0) return x == 0 ? 0 : m->in.pred_mode[x - 1];
  if (x == 0) return m->in.pred_mode[(y - 1) * xnb];
  int a = m->in.pred_mode[y * xnb + x - 1];
  int b = m->in.pred_mode[(y - 1) * xnb + x];
  int c = m->in.pred_mode[(y - 1) * xnb + x - 1];
  return (a & b) | (b & c) | (c & a);
}

static int e_split_prediction(MvEncCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (y == 0) return x == 0 ? 0 : m->in.split[x - 4];
  if (x == 0) return m->in.split[(y - 4) * xnb];
  int sum = m->in.split[(y - 4) * xnb + x]
          + m->in.split[y * xnb + x - 4]
          + m->in.split[(y - 4) * xnb + x - 4];
  return (sum + 1) / 3;
}

static int e_global_prediction(MvEncCtx* m, int x, int y) {
  int xnb = m->xnb;
  if (x == 0 && y == 0) return 0;
  if (y == 0) return m->in.using_global[x - 1];
  if (x == 0) return m->in.using_global[(y - 1) * xnb];
  int sum = m->in.using_global[y * xnb + x - 1]
          + m->in.using_global[(y - 1) * xnb + x]
          + m->in.using_global[(y - 1) * xnb + x - 1];
  return sum >= 2;
}

static void e_dc_prediction(MvEncCtx* m, int x, int y, int pred[3]) {
  int xnb = m->xnb;
  const int32_t* dcs[3] = {m->in.dc0, m->in.dc1, m->in.dc2};
  for (int k = 0; k < 3; k++) {
    int sum = 0, n = 0;
    if (x > 0 && m->in.pred_mode[y * xnb + x - 1] == 0) {
      sum += dcs[k][y * xnb + x - 1]; n++;
    }
    if (y > 0 && m->in.pred_mode[(y - 1) * xnb + x] == 0) {
      sum += dcs[k][(y - 1) * xnb + x]; n++;
    }
    if (x > 0 && y > 0 && m->in.pred_mode[(y - 1) * xnb + x - 1] == 0) {
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

static void e_vector_prediction(MvEncCtx* m, int x, int y, int* px, int* py,
                                int mode) {
  int xnb = m->xnb;
  int ref = mode - 1;
  const int32_t* dxs = ref == 0 ? m->in.dx1 : m->in.dx2;
  const int32_t* dys = ref == 0 ? m->in.dy1 : m->in.dy2;
  int vx[3], vy[3];
  int n = 0;
  if (x > 0) {
    int idx = y * xnb + x - 1;
    if (!m->in.using_global[idx] && (m->in.pred_mode[idx] & mode)) {
      vx[n] = dxs[idx]; vy[n] = dys[idx]; n++;
    }
  }
  if (y > 0) {
    int idx = (y - 1) * xnb + x;
    if (!m->in.using_global[idx] && (m->in.pred_mode[idx] & mode)) {
      vx[n] = dxs[idx]; vy[n] = dys[idx]; n++;
    }
  }
  if (x > 0 && y > 0) {
    int idx = (y - 1) * xnb + x - 1;
    if (!m->in.using_global[idx] && (m->in.pred_mode[idx] & mode)) {
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

static void encode_prediction_unit(MvEncCtx* m, int x, int y) {
  int xnb = m->xnb;
  int idx = y * xnb + x;
  int mode = m->in.pred_mode[idx];
  int mode_pred = e_mode_prediction(m, x, y);
  m->enc_bit(S_PM, CTX_BLOCK_MODE_REF1, (mode ^ mode_pred) & 1);
  if (m->num_refs > 1) {
    m->enc_bit(S_PM, CTX_BLOCK_MODE_REF2, ((mode ^ mode_pred) >> 1) & 1);
  }
  if (mode == 0) {
    int pred[3];
    e_dc_prediction(m, x, y, pred);
    m->enc_sint(S_DC0, CTX_LUMA_DC_CONT_BIN1, CTX_LUMA_DC_VALUE,
                CTX_LUMA_DC_SIGN, m->in.dc0[idx] - pred[0]);
    m->enc_sint(S_DC1, CTX_CHROMA1_DC_CONT_BIN1, CTX_CHROMA1_DC_VALUE,
                CTX_CHROMA1_DC_SIGN, m->in.dc1[idx] - pred[1]);
    m->enc_sint(S_DC2, CTX_CHROMA2_DC_CONT_BIN1, CTX_CHROMA2_DC_VALUE,
                CTX_CHROMA2_DC_SIGN, m->in.dc2[idx] - pred[2]);
  } else {
    if (m->have_global) {
      int gp = e_global_prediction(m, x, y);
      m->enc_bit(S_PM, CTX_GLOBAL_BLOCK, m->in.using_global[idx] ^ gp);
    }
    if (!m->in.using_global[idx]) {
      if (mode & 1) {
        int px, py;
        e_vector_prediction(m, x, y, &px, &py, 1);
        m->enc_sint(S_V1X, CTX_MV_REF1_H_CONT_BIN1, CTX_MV_REF1_H_VALUE,
                    CTX_MV_REF1_H_SIGN, m->in.dx1[idx] - px);
        m->enc_sint(S_V1Y, CTX_MV_REF1_V_CONT_BIN1, CTX_MV_REF1_V_VALUE,
                    CTX_MV_REF1_V_SIGN, m->in.dy1[idx] - py);
      }
      if (mode & 2) {
        int px, py;
        e_vector_prediction(m, x, y, &px, &py, 2);
        m->enc_sint(S_V2X, CTX_MV_REF2_H_CONT_BIN1, CTX_MV_REF2_H_VALUE,
                    CTX_MV_REF2_H_SIGN, m->in.dx2[idx] - px);
        m->enc_sint(S_V2Y, CTX_MV_REF2_V_CONT_BIN1, CTX_MV_REF2_V_VALUE,
                    CTX_MV_REF2_V_SIGN, m->in.dy2[idx] - py);
      }
    }
  }
}

}  // namespace

// Encodes MV fields; returns 9 buffer lengths in lengths_out; buffers are
// packed back-to-back into `out` at offsets_out.
// The caller must ensure the per-block arrays are consistent with the split
// values (blocks within a prediction unit identical).
int64_t motion_encode(
    int x_num_blocks, int y_num_blocks, int num_refs, int have_global,
    int is_noarith,
    const int32_t* split, const int32_t* pred_mode,
    const int32_t* using_global,
    const int32_t* dx1, const int32_t* dy1,
    const int32_t* dx2, const int32_t* dy2,
    const int32_t* dc0, const int32_t* dc1, const int32_t* dc2,
    uint8_t* out, int64_t out_capacity,
    int64_t* offsets_out, int64_t* lengths_out) {
  MvEncCtx m;
  m.noarith = is_noarith != 0;
  m.xnb = x_num_blocks;
  m.ynb = y_num_blocks;
  m.num_refs = num_refs;
  m.have_global = have_global;
  m.in = MvArrays{const_cast<int32_t*>(split), const_cast<int32_t*>(pred_mode),
                  const_cast<int32_t*>(using_global),
                  const_cast<int32_t*>(dx1), const_cast<int32_t*>(dy1),
                  const_cast<int32_t*>(dx2), const_cast<int32_t*>(dy2),
                  const_cast<int32_t*>(dc0), const_cast<int32_t*>(dc1),
                  const_cast<int32_t*>(dc2)};

  // each stream gets a private slab of the output buffer
  int64_t slab = out_capacity / 9;
  uint8_t* bufs[9];
  for (int s = 0; s < 9; s++) {
    bufs[s] = out + s * slab;
    if (m.noarith) {
      memset(bufs[s], 0, slab);
      m.pack[s].init(bufs[s], slab);
    } else {
      m.arith[s].init(bufs[s], slab);
    }
  }

  for (int j = 0; j < y_num_blocks; j += 4) {
    for (int i = 0; i < x_num_blocks; i += 4) {
      int base = j * x_num_blocks + i;
      int sp = e_split_prediction(&m, i, j);
      int split_v = split[base];
      // value encoded so decoder's (pred + v) % 3 == split
      int delta = (split_v - sp) % 3;
      if (delta < 0) delta += 3;
      m.enc_uint(S_SB, CTX_SB_F1, CTX_SB_DATA, delta);
      switch (split_v) {
        case 0:
          encode_prediction_unit(&m, i, j);
          break;
        case 1:
          encode_prediction_unit(&m, i, j);
          encode_prediction_unit(&m, i + 2, j);
          encode_prediction_unit(&m, i, j + 2);
          encode_prediction_unit(&m, i + 2, j + 2);
          break;
        case 2:
          for (int l = 0; l < 4; l++)
            for (int k = 0; k < 4; k++)
              encode_prediction_unit(&m, i + k, j + l);
          break;
      }
    }
  }

  int64_t total = 0;
  for (int s = 0; s < 9; s++) {
    int64_t len;
    if (num_refs < 2 && (s == S_V2X || s == S_V2Y)) {
      len = 0;
    } else if (m.noarith) {
      len = (m.pack[s].pos + 7) / 8;
    } else {
      len = m.arith[s].flush();
    }
    offsets_out[s] = s * slab;
    lengths_out[s] = len;
    total += len;
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// schro_frame_md5: raw MD5 compression rounds over each row zero-padded to a
// 64-byte multiple, planes Y,U,V in order; no standard MD5 finalization
// (schroframe.c:1819-1847, schroutils.c schro_md5).

extern "C" {

namespace {

static const uint32_t MD5_K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

static const int MD5_R[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

static inline uint32_t rotl(uint32_t x, int c) {
  return (x << c) | (x >> (32 - c));
}

static void md5_block(uint32_t* state, const uint32_t* m) {
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  for (int i = 0; i < 64; i++) {
    uint32_t f;
    int g;
    if (i < 16) { f = (b & c) | (~b & d); g = i; }
    else if (i < 32) { f = (d & b) | (~d & c); g = (5 * i + 1) & 15; }
    else if (i < 48) { f = b ^ c ^ d; g = (3 * i + 5) & 15; }
    else { f = c ^ (b | ~d); g = (7 * i) & 15; }
    uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + MD5_K[i] + m[g], MD5_R[i]);
    a = tmp;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
}

}  // namespace

void frame_md5(const uint8_t* y, int yw, int yh,
               const uint8_t* u, const uint8_t* v, int cw, int ch,
               uint8_t* out16) {
  uint32_t state[4] = {0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476};
  const uint8_t* planes[3] = {y, u, v};
  int ws[3] = {yw, cw, cw};
  int hs[3] = {yh, ch, ch};
  for (int k = 0; k < 3; k++) {
    int w = ws[k], h = hs[k];
    for (int j = 0; j < h; j++) {
      const uint8_t* line = planes[k] + (int64_t)j * w;
      int x = 0;
      for (; x + 63 < w; x += 64) {
        uint32_t m[16];
        memcpy(m, line + x, 64);
        md5_block(state, m);
      }
      if (x < w) {
        uint8_t tmp[64];
        memset(tmp, 0, 64);
        memcpy(tmp, line + x, w - x);
        uint32_t m[16];
        memcpy(m, tmp, 64);
        md5_block(state, m);
      }
    }
  }
  memcpy(out16, state, 16);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Low-delay slice search using TPU-precomputed per-base aggregates.
//
// bits_tab/last_tab: (61, n_slices) int32 — total sint bits and last-nonzero
// position of the NON-DC segment at each base index (computed on device by
// pipeline.make_lowdelay_analyze). The host then only runs the DC chains and
// table lookups during the search, and one final quantise pass for packing.

extern "C" {

int64_t ld_encode_tab(
    const int32_t* yd, const int32_t* ud, const int32_t* vd,
    const int32_t* y_qmo, const int32_t* uv_qmo,
    int ny, int nx, int Sy, int Suv,
    int y_bh, int y_bw, int uv_bh, int uv_bw,
    const int32_t* y_ll, const int32_t* u_ll, const int32_t* v_ll,
    int y_llw, int y_llh, int uv_llw, int uv_llh,
    int dc_qm, int deep,
    const int64_t* slice_bytes,
    const int32_t* y_bits_tab, const int32_t* y_last_tab,
    const int32_t* u_bits_tab, const int32_t* u_last_tab,
    const int32_t* v_bits_tab, const int32_t* v_last_tab,
    uint8_t* out, int64_t out_capacity,
    int32_t* chosen_base_out) {
  qf_magic_init();
  int dcs_y = y_bh * y_bw;
  int dcs_uv = uv_bh * uv_bw;
  int n_slices = ny * nx;

  int32_t* y_recon = (int32_t*)calloc((size_t)y_llw * y_llh, 4);
  int32_t* u_recon = (int32_t*)calloc((size_t)uv_llw * uv_llh, 4);
  int32_t* v_recon = (int32_t*)calloc((size_t)uv_llw * uv_llh, 4);
  int64_t* dqy = (int64_t*)malloc(sizeof(int64_t) * dcs_y);
  int64_t* dqu = (int64_t*)malloc(sizeof(int64_t) * dcs_uv);
  int64_t* dqv = (int64_t*)malloc(sizeof(int64_t) * dcs_uv);
  int64_t* qy = (int64_t*)malloc(sizeof(int64_t) * Sy);
  int64_t* qu = (int64_t*)malloc(sizeof(int64_t) * Suv);
  int64_t* qv = (int64_t*)malloc(sizeof(int64_t) * Suv);

  BitWriter bw;
  memset(out, 0, (size_t)out_capacity);
  bw.init(out, out_capacity);

  int si = 0;
  for (int sy = 0; sy < ny; sy++) {
    for (int sx = 0; sx < nx; sx++, si++) {
      int sbytes = (int)slice_bytes[si];
      int length_bits = ilog2up(8 * (uint32_t)sbytes);
      const int32_t* yv = yd + (int64_t)si * Sy;
      const int32_t* uv_ = ud + (int64_t)si * Suv;
      const int32_t* vv = vd + (int64_t)si * Suv;

      int y_bits_f = 0, trail_y_f = 0, trail_uv_f = 0;

      auto estimate = [&](int base) {
        int qi0 = std::min(std::max(base - dc_qm, 0), 60);
        ld_quant_dc_block(y_ll, y_recon, y_llw, sy * y_bh, (sy + 1) * y_bh,
                          sx * y_bw, (sx + 1) * y_bw, qi0, dqy, deep);
        ld_quant_dc_block(u_ll, u_recon, uv_llw, sy * uv_bh, (sy + 1) * uv_bh,
                          sx * uv_bw, (sx + 1) * uv_bw, qi0, dqu, deep);
        ld_quant_dc_block(v_ll, v_recon, uv_llw, sy * uv_bh, (sy + 1) * uv_bh,
                          sx * uv_bw, (sx + 1) * uv_bw, qi0, dqv, deep);

        int dc_bits_y = 0, dc_last_y = -1;
        for (int k = 0; k < dcs_y; k++) {
          dc_bits_y += sint_bits(dqy[k]);
          if (dqy[k]) dc_last_y = k;
        }
        int dc_bits_u = 0, dc_last_u = -1;
        int dc_bits_v = 0, dc_last_v = -1;
        for (int k = 0; k < dcs_uv; k++) {
          dc_bits_u += sint_bits(dqu[k]);
          if (dqu[k]) dc_last_u = k;
          dc_bits_v += sint_bits(dqv[k]);
          if (dqv[k]) dc_last_v = k;
        }

        int64_t ti = (int64_t)base * n_slices + si;
        int y_bits = dc_bits_y + y_bits_tab[ti];
        int ynl = y_last_tab[ti];
        int y_last = ynl >= 0 ? dcs_y + ynl : dc_last_y;
        int trail_y = (y_last >= 0) ? (Sy - 1 - y_last) : Sy;

        int u_bits = dc_bits_u + u_bits_tab[ti];
        int unl = u_last_tab[ti];
        int u_last = unl >= 0 ? dcs_uv + unl : dc_last_u;
        int trail_u = (u_last >= 0) ? (Suv - 1 - u_last) : Suv;
        int v_bits = dc_bits_v + v_bits_tab[ti];
        int vnl = v_last_tab[ti];
        int v_last = vnl >= 0 ? dcs_uv + vnl : dc_last_v;
        int trail_v = (v_last >= 0) ? (Suv - 1 - v_last) : Suv;
        int trail_uv = 2 * std::min(trail_u, trail_v);

        y_bits_f = y_bits;
        trail_y_f = trail_y;
        trail_uv_f = trail_uv;
        return 7 + length_bits + y_bits + u_bits + v_bits - trail_y - trail_uv;
      };

      int base;
      int n_est = estimate(0);
      if (n_est <= sbytes * 8) {
        base = 0;
      } else {
        int i = 0;
        for (int size = 32; size >= 1; size >>= 1) {
          n_est = estimate(i + size);
          if (n_est >= sbytes * 8) i += size;
        }
        estimate(i + 1);
        base = i + 1;
      }
      chosen_base_out[si] = base;

      // final quantise at the chosen base (single pass) for the emit
      for (int k = 0; k < dcs_y; k++) qy[k] = dqy[k];
      for (int seg = dcs_y; seg < Sy;) {
        int32_t qmo_v = y_qmo[seg];
        int seg_end = seg;
        while (seg_end < Sy && y_qmo[seg_end] == qmo_v) seg_end++;
        int qi = std::min(std::max(base - qmo_v, 0), 60);
        int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
        int64_t offset = qo - qf / 2;
        uint64_t M = QF_MAGIC[qi].M;
        int S = QF_MAGIC[qi].S;
        for (int k = seg; k < seg_end; k++) {
          int64_t v = yv[k];
          int64_t x = (v < 0 ? -v : v) << 2;
          int64_t mag = x < qo ? 0
              : (int64_t)(((__uint128_t)(uint64_t)(x - offset) * M) >> S);
          qy[k] = v < 0 ? -mag : mag;
        }
        seg = seg_end;
      }
      for (int k = 0; k < dcs_uv; k++) { qu[k] = dqu[k]; qv[k] = dqv[k]; }
      for (int seg = dcs_uv; seg < Suv;) {
        int32_t qmo_v = uv_qmo[seg];
        int seg_end = seg;
        while (seg_end < Suv && uv_qmo[seg_end] == qmo_v) seg_end++;
        int qi = std::min(std::max(base - qmo_v, 0), 60);
        int64_t qf = QUANT_FACTOR[qi], qo = QUANT_OFFSET_1_2[qi];
        int64_t offset = qo - qf / 2;
        uint64_t M = QF_MAGIC[qi].M;
        int S = QF_MAGIC[qi].S;
        for (int k = seg; k < seg_end; k++) {
          int64_t v1 = uv_[k];
          int64_t x1 = (v1 < 0 ? -v1 : v1) << 2;
          int64_t m1 = x1 < qo ? 0
              : (int64_t)(((__uint128_t)(uint64_t)(x1 - offset) * M) >> S);
          qu[k] = v1 < 0 ? -m1 : m1;
          int64_t v2 = vv[k];
          int64_t x2 = (v2 < 0 ? -v2 : v2) << 2;
          int64_t m2 = x2 < qo ? 0
              : (int64_t)(((__uint128_t)(uint64_t)(x2 - offset) * M) >> S);
          qv[k] = v2 < 0 ? -m2 : m2;
        }
        seg = seg_end;
      }

      int64_t start = bw.pos;
      bw.put_bits(7, base);
      int slice_y_length = y_bits_f - trail_y_f;
      bw.put_bits(length_bits, slice_y_length);
      int ny_coef = Sy - trail_y_f;
      for (int k = 0; k < ny_coef; k++) bw.put_sint(qy[k]);
      int nuv_pair = Suv - trail_uv_f / 2;
      for (int k = 0; k < nuv_pair; k++) {
        bw.put_sint(qu[k]);
        bw.put_sint(qv[k]);
      }
      int64_t used = bw.pos - start;
      int64_t cap_bits = (int64_t)sbytes * 8;
      if (used > cap_bits) {
        free(y_recon); free(u_recon); free(v_recon);
        free(dqy); free(dqu); free(dqv); free(qy); free(qu); free(qv);
        return -1;
      }
      while (bw.pos < start + cap_bits) bw.put_bit(1);
    }
  }

  free(y_recon); free(u_recon); free(v_recon);
  free(dqy); free(dqu); free(dqv); free(qy); free(qu); free(qv);
  return bw.pos / 8;
}

}  // extern "C"
