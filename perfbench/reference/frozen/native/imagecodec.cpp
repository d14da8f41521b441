// imagecodec — baseline JPEG decode/encode and PNG unfiltering on the host.
//
// The dataset store (img_store.grv) holds JPEG `body_image` and PNG
// `body_mask` records. This codec reads and writes them without an image
// library, and decodes as libjpeg-turbo's default decompression path does,
// so its pixels equal OpenCV's `imdecode`:
//   * the integer "islow" IDCT of jidctint.c, with its range-limit table;
//   * "fancy" triangle-filter chroma upsampling (jdsample.c
//     h2v1/h1v2/h2v2_fancy_upsample; box replication when the downsampled
//     width is 2 or less, as jinit_upsampler chooses);
//   * jdcolor.c's fixed-point YCbCr -> RGB tables.
// The encoder follows libjpeg-turbo's default compression path: jccolor.c's
// RGB -> YCbCr tables, h2v2_downsample's alternating bias (4:2:0, the
// sampling OpenCV writes by default), the islow FDCT of jfdctint.c, IJG
// quality scaling of the standard tables, the standard Huffman tables,
// dummy blocks as jccoefct.c makes them, and a JFIF APP0 header.
//
// Supported: SOF0/SOF1 with 8-bit samples, 1 or 3 components, 4:4:4, 4:2:2,
// 4:4:0 and 4:2:0, interleaved or not, restart intervals, any DHT/DQT.
// Refused with a message naming the marker: progressive, lossless,
// hierarchical and arithmetic-coded files, and other than 8-bit precision.
//
// PNG: the Python side inflates with zlib; `png_unfilter` undoes the five
// scanline filters. Every entry returns 0 on success, or writes a message
// into `err` and returns non-zero.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the end lands on 63, as in jpeg_natural_order
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

void put_err(const std::string& m, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", m.c_str());
  }
}

// ---------------------------------------------------------------- decoder

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t mincode[17], maxcode[18], valptr[17];
  // 9-bit lookahead: (length << 8) | value, or 0 for a longer code
  uint16_t look[512];

  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int lo = code << (9 - l);
        for (int j = 0; j < (1 << (9 - l)); ++j)
          look[lo + j] = static_cast<uint16_t>((l << 8) | vals[k]);
      }
      code <<= 1;
    }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks of the MCU-padded plane
  int dw = 0, dh = 0;          // downsampled width and height in samples
  bool seen = false;           // first scan started: quant table latched
  uint16_t q[64];              // latched quantization table, natural order
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int dc_pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  size_t pos() const { return pos_; }
  void seek(size_t pos) {
    pos_ = pos;
    reset();
  }
  void reset() {
    acc_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
  }
  // bytes up to 57 bits; past a marker or the end, zeros (as libjpeg fills)
  void fill() {
    while (nbits_ <= 56) {
      uint32_t b = 0;
      if (!hit_marker_ && pos_ < n_) {
        b = p_[pos_];
        if (b == 0xFF) {
          uint8_t nx = pos_ + 1 < n_ ? p_[pos_ + 1] : 0xD9;
          if (nx == 0x00) {
            pos_ += 2;
          } else {
            hit_marker_ = true;
            b = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ |= static_cast<uint64_t>(b) << (56 - nbits_);
      nbits_ += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits_ < n) fill();
    return static_cast<uint32_t>(acc_ >> (64 - n));
  }
  void skip(int n) {
    acc_ <<= n;
    nbits_ -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const HuffTable& t) {
    uint32_t lk = peek(9);
    uint16_t e = t.look[lk];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    uint32_t w = peek(16);
    for (int l = 10; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(w >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    int v = get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;
};

// jidctint.c: the accurate integer IDCT, with the post-IDCT range limit
// (`idct_limit`, sample_range_limit + CENTERJSAMPLE indexed & RANGE_MASK)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v) {
      // v is (sample - 128) & 1023: 0..127 -> 128..255; 128..511 -> 255;
      // 512..895 -> 0; 896..1023 -> 0..127
      int s;
      if (v < 128) s = v + 128;
      else if (v < 512) s = 255;
      else if (v < 896) s = 0;
      else s = v - 896;
      t[v] = static_cast<uint8_t>(s);
    }
  }
};
const RangeLimit kLimit;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = kLimit.t[descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kLimit.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kLimit.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kLimit.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kLimit.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kLimit.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kLimit.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kLimit.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kLimit.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int scale = 16;
    const int64_t half = int64_t(1) << (scale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> scale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> scale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart = 0;
  bool have_frame = false;
  Component comp[4];
  HuffTable dc[4], ac[4];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  int adobe_transform = -1;  // APP14 color transform, -1 when absent
  bool jfif = false;
};

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

const char* sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    default: return "SOF";
  }
}

void parse_sof(Jpeg& j, const uint8_t* s, int len, int marker) {
  if (len < 6) fail("corrupt JPEG: short SOF segment");
  int precision = s[0];
  if (precision != 8)
    fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples in SOF" +
         std::to_string(marker - 0xC0) + " (only 8-bit)");
  j.height = be16(s + 1);
  j.width = be16(s + 3);
  j.ncomp = s[5];
  if (j.width == 0 || j.height == 0) fail("unsupported JPEG: zero image size in SOF (DNL)");
  if (j.ncomp != 1 && j.ncomp != 3)
    fail("unsupported JPEG: " + std::to_string(j.ncomp) + " components (only 1 or 3)");
  if (len < 6 + 3 * j.ncomp) fail("corrupt JPEG: short SOF segment");
  j.hmax = j.vmax = 1;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
      fail("corrupt JPEG: bad component in SOF");
    j.hmax = std::max(j.hmax, k.h);
    j.vmax = std::max(j.vmax, k.v);
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (j.ncomp == 3) {
      bool ok = (j.hmax % k.h == 0) && (j.vmax % k.v == 0) &&
                (j.hmax / k.h <= 2) && (j.vmax / k.v <= 2);
      if (!ok)
        fail("unsupported JPEG: sampling factors " + std::to_string(k.h) + "x" +
             std::to_string(k.v) + " under " + std::to_string(j.hmax) + "x" +
             std::to_string(j.vmax));
    }
    k.bw = j.mcux * k.h;
    k.bh = j.mcuy * k.v;
    k.dw = static_cast<int>((int64_t(j.width) * k.h + j.hmax - 1) / j.hmax);
    k.dh = static_cast<int>((int64_t(j.height) * k.v + j.vmax - 1) / j.vmax);
    k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    k.seen = false;
  }
  j.have_frame = true;
}

void parse_dht(Jpeg& j, const uint8_t* s, int len) {
  int i = 0;
  while (i < len) {
    if (i + 17 > len) fail("corrupt JPEG: short DHT segment");
    int tc = s[i] >> 4, th = s[i] & 15;
    if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT table id");
    HuffTable& t = tc == 0 ? j.dc[th] : j.ac[th];
    int n = 0;
    t.bits[0] = 0;
    for (int l = 1; l <= 16; ++l) {
      t.bits[l] = s[i + l];
      n += t.bits[l];
    }
    if (n > 256 || i + 17 + n > len) fail("corrupt JPEG: bad DHT counts");
    std::memcpy(t.vals, s + i + 17, n);
    t.build();
    t.present = true;
    i += 17 + n;
  }
}

void parse_dqt(Jpeg& j, const uint8_t* s, int len) {
  int i = 0;
  while (i < len) {
    int pq = s[i] >> 4, tq = s[i] & 15;
    if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT table id");
    int need = 1 + 64 * (pq ? 2 : 1);
    if (i + need > len) fail("corrupt JPEG: short DQT segment");
    for (int k = 0; k < 64; ++k)
      j.qt[tq][kNatural[k]] = pq ? be16(s + i + 1 + 2 * k) : s[i + 1 + k];
    j.qt_present[tq] = true;
    i += need;
  }
}

void decode_block(BitReader& br, Component& k, const HuffTable& dc, const HuffTable& ac,
                  int16_t* blk) {
  int s = br.decode(dc);
  k.dc_pred += br.receive_extend(s);
  blk[0] = static_cast<int16_t>(k.dc_pred);
  for (int i = 1; i < 64;) {
    int rs = br.decode(ac);
    int r = rs >> 4, sz = rs & 15;
    if (sz == 0) {
      if (r != 15) break;  // EOB
      i += 16;
      continue;
    }
    i += r;
    blk[kNatural[i]] = static_cast<int16_t>(br.receive_extend(sz));
    ++i;
  }
}

// Finds the next marker at or after `pos` -> its position (at the 0xFF).
size_t next_marker(const uint8_t* p, size_t n, size_t pos) {
  while (pos + 1 < n) {
    if (p[pos] == 0xFF && p[pos + 1] != 0x00 && p[pos + 1] != 0xFF) return pos;
    ++pos;
  }
  return n;
}

size_t decode_scan(Jpeg& j, const uint8_t* p, size_t n, size_t pos, const uint8_t* s, int len) {
  if (!j.have_frame) fail("corrupt JPEG: SOS before SOF");
  int ns = s[0];
  if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) fail("corrupt JPEG: bad SOS");
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    int cid = s[1 + 2 * i];
    int c = 0;
    while (c < j.ncomp && j.comp[c].id != cid) ++c;
    if (c == j.ncomp) fail("corrupt JPEG: SOS names an unknown component");
    sc[i] = &j.comp[c];
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j.dc[sc[i]->td].present ||
        !j.ac[sc[i]->ta].present)
      fail("corrupt JPEG: SOS names a missing Huffman table");
    if (!sc[i]->seen) {
      // libjpeg latches a component's quantization table at its first scan
      if (!j.qt_present[sc[i]->tq]) fail("corrupt JPEG: missing quantization table");
      std::memcpy(sc[i]->q, j.qt[sc[i]->tq], sizeof(sc[i]->q));
      sc[i]->seen = true;
    }
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) fail("unsupported JPEG: spectral selection in a baseline scan");

  BitReader br(p, n);
  br.seek(pos);
  for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;

  int units_x, units_y;
  if (ns == 1) {
    Component& k = *sc[0];
    units_x = (k.dw + 7) / 8;
    units_y = (k.dh + 7) / 8;
  } else {
    units_x = j.mcux;
    units_y = j.mcuy;
  }
  const int total = units_x * units_y;
  int todo = j.restart;
  int next_rst = 0;
  for (int u = 0; u < total; ++u) {
    if (j.restart && todo == 0) {
      // byte-align, find the RSTn marker, reset the predictors
      size_t m = next_marker(p, n, br.pos());
      if (m + 1 >= n || p[m + 1] < 0xD0 || p[m + 1] > 0xD7)
        fail("corrupt JPEG: missing restart marker");
      if (p[m + 1] != 0xD0 + next_rst) fail("corrupt JPEG: restart marker out of order");
      next_rst = (next_rst + 1) & 7;
      br.seek(m + 2);
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      todo = j.restart;
    }
    int ux = u % units_x, uy = u / units_x;
    if (ns == 1) {
      Component& k = *sc[0];
      int16_t* blk = &k.coef[(static_cast<size_t>(uy) * k.bw + ux) * 64];
      decode_block(br, k, j.dc[k.td], j.ac[k.ta], blk);
    } else {
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        for (int by = 0; by < k.v; ++by)
          for (int bx = 0; bx < k.h; ++bx) {
            size_t b = static_cast<size_t>(uy * k.v + by) * k.bw + (ux * k.h + bx);
            decode_block(br, k, j.dc[k.td], j.ac[k.ta], &k.coef[b * 64]);
          }
      }
    }
    if (j.restart) --todo;
  }
  return next_marker(p, n, br.pos());
}

void parse(Jpeg& j, const uint8_t* p, size_t n, bool decode) {
  if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
  size_t pos = 2;
  bool scanned = false;
  while (true) {
    pos = next_marker(p, n, pos);
    if (pos + 1 >= n) break;
    int m = p[pos + 1];
    pos += 2;
    if (m == 0xD9) break;                  // EOI
    if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
    if (pos + 2 > n) fail("corrupt JPEG: truncated marker segment");
    int len = be16(p + pos) - 2;
    if (len < 0 || pos + 2 + len > n) fail("corrupt JPEG: truncated marker segment");
    const uint8_t* s = p + pos + 2;
    if (m == 0xC0 || m == 0xC1) {
      if (j.have_frame) fail("corrupt JPEG: two SOF markers");
      parse_sof(j, s, len, m);
      if (!decode) return;
    } else if ((m >= 0xC2 && m <= 0xC7 && m != 0xC4) || (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
      fail(std::string("unsupported JPEG: ") + sof_name(m) + " frame (only baseline SOF0/SOF1)");
    } else if (m == 0xCC) {
      fail("unsupported JPEG: DAC marker (arithmetic coding)");
    } else if (m == 0xC4) {
      parse_dht(j, s, len);
    } else if (m == 0xDB) {
      parse_dqt(j, s, len);
    } else if (m == 0xDD) {
      if (len < 2) fail("corrupt JPEG: short DRI segment");
      j.restart = be16(s);
    } else if (m == 0xDA) {
      pos = decode_scan(j, p, n, pos + 2 + len, s, len);
      scanned = true;
      continue;
    } else if (m == 0xE0) {
      if (len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j.jfif = true;
    } else if (m == 0xEE) {
      if (len >= 12 && std::memcmp(s, "Adobe", 5) == 0) j.adobe_transform = s[11];
    } else if (m == 0xDC) {
      fail("unsupported JPEG: DNL marker");
    }
    pos += 2 + len;
  }
  if (!j.have_frame) fail("corrupt JPEG: no SOF marker");
  if (decode && !scanned) fail("corrupt JPEG: no scan");
}

// One component's samples at full resolution, row `y` (0 <= y < height):
// upsampled as libjpeg-turbo's default (fancy) path does.
struct Plane {
  const uint8_t* s;  // IDCT output, stride `stride`
  int stride, dw, dh, hf, vf;  // hf, vf: upsampling factors (1 or 2)
  bool fancy_h;                // h2v1 / h2v2 fancy (downsampled width > 2)
};

void upsample_row(const Plane& pl, int y, int width, uint8_t* out) {
  if (pl.hf == 1 && pl.vf == 1) {
    std::memcpy(out, pl.s + static_cast<size_t>(y) * pl.stride, width);
    return;
  }
  auto row = [&](int r) {
    r = r < 0 ? 0 : (r >= pl.dh ? pl.dh - 1 : r);
    return pl.s + static_cast<size_t>(r) * pl.stride;
  };
  const int dw = pl.dw;
  if (pl.vf == 1) {  // h2v1
    const uint8_t* in = row(y);
    if (!pl.fancy_h) {
      for (int x = 0; x < width; ++x) out[x] = in[x >> 1];
      return;
    }
    for (int c = 0; c < dw; ++c) {
      int l = in[c > 0 ? c - 1 : 0], m = in[c], r = in[c + 1 < dw ? c + 1 : dw - 1];
      int o0 = (m * 3 + l + 1) >> 2, o1 = (m * 3 + r + 2) >> 2;
      if (2 * c < width) out[2 * c] = static_cast<uint8_t>(o0);
      if (2 * c + 1 < width) out[2 * c + 1] = static_cast<uint8_t>(o1);
    }
    return;
  }
  // vertical factor 2: the nearer input row and the next nearer one
  const int iy = y >> 1;
  const uint8_t* in0 = row(iy);
  const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
  if (pl.hf == 1) {  // h1v2 fancy
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < width; ++x) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (!pl.fancy_h) {  // h2v2 box
    for (int x = 0; x < width; ++x) out[x] = in0[x >> 1];
    return;
  }
  for (int c = 0; c < dw; ++c) {
    int cl = c > 0 ? c - 1 : 0, cr = c + 1 < dw ? c + 1 : dw - 1;
    int last = in0[cl] * 3 + in1[cl];
    int cur = in0[c] * 3 + in1[c];
    int nxt = in0[cr] * 3 + in1[cr];
    int o0 = (cur * 3 + last + 8) >> 4, o1 = (cur * 3 + nxt + 7) >> 4;
    if (2 * c < width) out[2 * c] = static_cast<uint8_t>(o0);
    if (2 * c + 1 < width) out[2 * c + 1] = static_cast<uint8_t>(o1);
  }
}

void render(Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  std::vector<std::vector<uint8_t>> planes(j.ncomp);
  std::vector<Plane> pl(j.ncomp);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    const int stride = k.bw * 8;
    planes[c].assign(static_cast<size_t>(stride) * k.bh * 8, 0);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64], k.q,
                   &planes[c][static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
    int hf = j.ncomp == 1 ? 1 : j.hmax / k.h, vf = j.ncomp == 1 ? 1 : j.vmax / k.v;
    pl[c] = Plane{planes[c].data(), stride, k.dw, k.dh, hf, vf, k.dw > 2};
  }
  if (j.ncomp == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + static_cast<size_t>(y) * W, pl[0].s + static_cast<size_t>(y) * pl[0].stride, W);
    return;
  }
  // three components: YCbCr unless an Adobe marker says RGB (transform 0)
  // and no JFIF marker says otherwise, as libjpeg's default_decompress_parms
  bool rgb = false;
  if (!j.jfif && j.adobe_transform == 0) rgb = true;
  if (!j.jfif && j.adobe_transform < 0 && j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
      j.comp[2].id == 'B')
    rgb = true;
  std::vector<uint8_t> r0(W + 1), r1(W + 1), r2(W + 1);
  for (int y = 0; y < H; ++y) {
    upsample_row(pl[0], y, W, r0.data());
    upsample_row(pl[1], y, W, r1.data());
    upsample_row(pl[2], y, W, r2.data());
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = r0[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

// ---------------------------------------------------------------- encoder

const uint8_t kStdLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// the standard tables of the JPEG specification, Annex K.3 (jstdhuff.c)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int code_ = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(code_++);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      code_ <<= 1;
    }
  }
};

class BitWriter {
 public:
  std::vector<uint8_t> out;
  void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((1u << n) - 1));
    nbits_ += n;
    while (nbits_ >= 8) {
      uint8_t b = static_cast<uint8_t>(acc_ >> (nbits_ - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      nbits_ -= 8;
    }
  }
  void flush() {  // pad with 1-bits, as libjpeg does
    if (nbits_ > 0) put(0x7F, 8 - nbits_);
    acc_ = 0;
    nbits_ = 0;
  }

 private:
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

// jfdctint.c: the accurate integer forward DCT (output scaled up by 8)
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + r * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits - kPass1Bits;
    p[2] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[6] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
  }
}

// jcparam.c: jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = static_cast<uint16_t>(t);
  }
}

struct EncComp {
  std::vector<uint8_t> plane;  // stride bw * 8, rows bh_plane * 8 (edge-replicated)
  int stride = 0;
  int wib = 0, hib = 0;  // blocks holding image samples (width/height_in_blocks)
  int h = 1, v = 1, tq = 0;
  int dc_pred = 0;
};

// quantize with rounding to nearest, halves away from zero (jcdctmgr.c)
void quantize(const int* d, const uint16_t* q, int* out) {
  for (int i = 0; i < 64; ++i) {
    int qv = q[i] << 3;
    int t = d[i];
    if (t < 0) {
      t = -t;
      t = (t + (qv >> 1)) / qv;
      t = -t;
    } else {
      t = (t + (qv >> 1)) / qv;
    }
    out[i] = t;
  }
}

int nbits_of(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int* coef, int& dc_pred, const EncTable& dc,
                  const EncTable& ac) {
  int diff = coef[0] - dc_pred;
  dc_pred = coef[0];
  int n = nbits_of(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(diff < 0 ? diff - 1 : diff, n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int s = nbits_of(v);
    int rs = (run << 4) | s;
    bw.put(ac.code[rs], ac.size[rs]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(static_cast<uint8_t>(id));
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < n; ++i) o.push_back(vals[i]);
}

// jccolor.c rgb_ycc_convert tables
struct RgbYccTables {
  int64_t t[8 * 256];
  RgbYccTables() {
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
    const int64_t half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
    for (int i = 0; i < 256; ++i) {
      t[i] = fix(0.29900) * i;
      t[i + 256] = fix(0.58700) * i;
      t[i + 512] = fix(0.11400) * i + half;
      t[i + 768] = -fix(0.16874) * i;
      t[i + 1024] = -fix(0.33126) * i;
      t[i + 1280] = fix(0.50000) * i + cbcr_off + half - 1;  // B->Cb and R->Cr
      t[i + 1536] = -fix(0.41869) * i;
      t[i + 1792] = -fix(0.08131) * i;
    }
  }
};
const RgbYccTables kRgbYcc;

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int nc, int quality) {
  if (W < 1 || H < 1 || W > 65535 || H > 65535) fail("JPEG size out of range");
  if (nc != 1 && nc != 3) fail("JPEG encode takes 1 or 3 channels");
  uint16_t qt[2][64];
  scaled_table(kStdLumQ, quality, qt[0]);
  scaled_table(kStdChrQ, quality, qt[1]);
  const int hmax = nc == 3 ? 2 : 1, vmax = hmax;
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);

  // color conversion into full-resolution planes
  std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>(static_cast<size_t>(W) * H));
  for (size_t i = 0; i < static_cast<size_t>(W) * H; ++i) {
    if (nc == 1) {
      full[0][i] = px[i];
      continue;
    }
    int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
    const int64_t* t = kRgbYcc.t;
    full[0][i] = static_cast<uint8_t>((t[r] + t[g + 256] + t[b + 512]) >> 16);
    full[1][i] = static_cast<uint8_t>((t[r + 768] + t[g + 1024] + t[b + 1280]) >> 16);
    full[2][i] = static_cast<uint8_t>((t[r + 1280] + t[g + 1536] + t[b + 1792]) >> 16);
  }
  auto at = [&](int c, int y, int x) {  // edge-replicated full-resolution sample
    y = y < H ? y : H - 1;
    x = x < W ? x : W - 1;
    return static_cast<int>(full[c][static_cast<size_t>(y) * W + x]);
  };

  std::vector<EncComp> comps(nc);
  for (int c = 0; c < nc; ++c) {
    EncComp& k = comps[c];
    k.h = c == 0 ? hmax : 1;
    k.v = c == 0 ? vmax : 1;
    k.tq = c == 0 ? 0 : 1;
    k.wib = static_cast<int>((int64_t(W) * k.h + 8 * hmax - 1) / (8 * hmax));
    k.hib = static_cast<int>((int64_t(H) * k.v + 8 * vmax - 1) / (8 * vmax));
    k.stride = k.wib * 8;
    const int rows = k.hib * 8;
    k.plane.assign(static_cast<size_t>(k.stride) * rows, 0);
    if (k.h == hmax) {  // full size: replicate the right column and the bottom row
      for (int y = 0; y < rows; ++y)
        for (int x = 0; x < k.stride; ++x) k.plane[static_cast<size_t>(y) * k.stride + x] = at(c, y, x);
    } else {  // h2v2_downsample with the bias 1, 2, 1, 2, ...; then the last
              // downsampled row replicated down to the iMCU height
      const int ds_rows = (H + 1) / 2;
      for (int y = 0; y < rows; ++y) {
        const int sy = y < ds_rows ? y : ds_rows - 1;
        int bias = 1;
        for (int x = 0; x < k.stride; ++x) {
          int s = at(c, 2 * sy, 2 * x) + at(c, 2 * sy, 2 * x + 1) + at(c, 2 * sy + 1, 2 * x) +
                  at(c, 2 * sy + 1, 2 * x + 1);
          k.plane[static_cast<size_t>(y) * k.stride + x] = static_cast<uint8_t>((s + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(W) * H * nc / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                          0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), app0, app0 + sizeof(app0));
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(qt[t][kNatural[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(static_cast<uint8_t>(nc));
  for (int c = 0; c < nc; ++c) {
    o.push_back(static_cast<uint8_t>(c + 1));
    o.push_back(static_cast<uint8_t>((comps[c].h << 4) | comps[c].v));
    o.push_back(static_cast<uint8_t>(comps[c].tq));
  }
  put_dht(o, 0x00, kDcLumBits, kDcVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  if (nc == 3) {
    put_dht(o, 0x01, kDcChrBits, kDcVals);
    put_dht(o, 0x11, kAcChrBits, kAcChrVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(static_cast<uint8_t>(nc));
  for (int c = 0; c < nc; ++c) {
    o.push_back(static_cast<uint8_t>(c + 1));
    o.push_back(c == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  const EncTable dc_l(kDcLumBits, kDcVals), ac_l(kAcLumBits, kAcLumVals);
  const EncTable dc_c(kDcChrBits, kDcVals), ac_c(kAcChrBits, kAcChrVals);
  BitWriter bw;
  bw.out.swap(o);
  int blk[64], q[64];
  // the MCU's quantized blocks, kept so a dummy block can copy a DC
  std::vector<std::vector<int>> mcu(static_cast<size_t>(hmax) * vmax + 2, std::vector<int>(64));
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < nc; ++c) {
        EncComp& k = comps[c];
        int bn = 0;
        for (int by = 0; by < k.v; ++by) {
          const int gy = my * k.v + by;
          for (int bx = 0; bx < k.h; ++bx, ++bn) {
            const int gx = mx * k.h + bx;
            std::vector<int>& dst = mcu[bn];
            if (gy < k.hib && gx < k.wib) {
              for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                  blk[y * 8 + x] =
                      static_cast<int>(k.plane[static_cast<size_t>(gy * 8 + y) * k.stride + gx * 8 + x]) - 128;
              fdct_islow(blk);
              quantize(blk, qt[k.tq], q);
              std::memcpy(dst.data(), q, sizeof(q));
            } else {
              // jccoefct.c dummy blocks: zero AC; the DC of the block to the
              // left, or (a row past the bottom) of the MCU's block before it
              std::fill(dst.begin(), dst.end(), 0);
              if (gy < k.hib) dst[0] = mcu[bn - 1][0];
              else dst[0] = mcu[by * k.h - 1][0];
            }
            encode_block(bw, dst.data(), k.dc_pred, c == 0 ? dc_l : dc_c, c == 0 ? ac_l : ac_c);
          }
        }
      }
    }
  }
  bw.flush();
  bw.out.push_back(0xFF);
  bw.out.push_back(0xD9);
  return std::move(bw.out);
}

}  // namespace

extern "C" {

// -> 0 and the image's width, height and component count
int ic_jpeg_info(const uint8_t* buf, uint64_t len, int* w, int* h, int* nc, char* err,
                 int errlen) {
  try {
    Jpeg j;
    parse(j, buf, len, false);
    *w = j.width;
    *h = j.height;
    *nc = j.ncomp;
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    put_err(e.what(), err, errlen);
    return 2;
  }
}

// Decodes into `out` (height x width x nc, RGB for three components);
// `out_len` must be exactly that size.
int ic_jpeg_decode(const uint8_t* buf, uint64_t len, uint8_t* out, uint64_t out_len, char* err,
                   int errlen) {
  try {
    Jpeg j;
    parse(j, buf, len, true);
    if (out_len != static_cast<uint64_t>(j.width) * j.height * j.ncomp)
      fail("output buffer size does not match the image");
    render(j, out);
    return 0;
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    put_err(e.what(), err, errlen);
    return 2;
  }
}

// Encodes height x width x nc (nc 1: gray, 3: RGB) at `quality`. Writes at
// most `cap` bytes into `out` and returns the file's size; when it is larger
// than `cap`, nothing is written and the call is to be repeated with at
// least that many bytes. Returns -1 on error.
int64_t ic_jpeg_encode(const uint8_t* px, int w, int h, int nc, int quality, uint8_t* out,
                       uint64_t cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> o = encode(px, w, h, nc, quality);
    if (o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return static_cast<int64_t>(o.size());
  } catch (const Error& e) {
    put_err(e.msg, err, errlen);
    return -1;
  } catch (const std::exception& e) {
    put_err(e.what(), err, errlen);
    return -1;
  }
}

// Undoes PNG filtering: `data` holds `height` scanlines of 1 filter byte and
// `width * bpp` bytes (the inflated IDAT stream, 8-bit samples, no
// interlace); `out` gets height x width * bpp bytes.
int ic_png_unfilter(const uint8_t* data, uint64_t len, int width, int height, int bpp,
                    uint8_t* out, char* err, int errlen) {
  const uint64_t row = static_cast<uint64_t>(width) * bpp;
  if (len < (row + 1) * height) {
    put_err("truncated PNG image data", err, errlen);
    return 1;
  }
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = data + y * (row + 1);
    const int ft = in[0];
    ++in;
    uint8_t* o = out + y * row;
    const uint8_t* up = y > 0 ? o - row : nullptr;
    for (uint64_t x = 0; x < row; ++x) {
      int a = x >= static_cast<uint64_t>(bpp) ? o[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= static_cast<uint64_t>(bpp)) ? up[x - bpp] : 0;
      int v;
      switch (ft) {
        case 0: v = in[x]; break;
        case 1: v = in[x] + a; break;
        case 2: v = in[x] + b; break;
        case 3: v = in[x] + ((a + b) >> 1); break;
        case 4: {
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          v = in[x] + pr;
          break;
        }
        default:
          put_err("corrupt PNG: filter type " + std::to_string(ft) + " on row " + std::to_string(y),
                  err, errlen);
          return 1;
      }
      o[x] = static_cast<uint8_t>(v);
    }
  }
  return 0;
}

}  // extern "C"
