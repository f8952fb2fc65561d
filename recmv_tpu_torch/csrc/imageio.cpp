// imageio: the host image decoding that the port's `data/image.imread`
// needs on machines without OpenCV, with a plain C ABI for ctypes.
//
//  - jpeg_decode: Huffman-coded 8-bit JPEG, baseline (SOF0), extended
//    sequential (SOF1) and progressive (SOF2), 1 or 3 components, any
//    sampling factors libjpeg accepts, restart intervals. It computes what
//    libjpeg-turbo computes under cv2.imread(IMREAD_COLOR): the integer
//    "islow" IDCT of jidctint.c with its descale and range limit, the fancy
//    (triangle) upsampling of jdsample.c for h2v1, h1v2 and h2v2 and plain
//    replication for other integral ratios, the fixed-point YCbCr->RGB of
//    jdcolor.c, and BGR output with gray repeated to three channels. All
//    arithmetic is integer, so compiler flags cannot change the bits.
//  - png_unfilter: the five PNG scanline filters of one (sub-)image.
//
// Every entry point returns 0 on success; on failure it writes a message
// into `err` and returns a nonzero code.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Zigzag index -> natural (row-major) index, with 16 guard entries so a
// corrupt run length cannot index past the block (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c: canonical codes, a 9-bit lookahead table and
// the maxcode walk for longer codes)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 = longer code

  void build(const uint8_t* bits, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int n = bits[l - 1];
      if (n) {
        valoffset[l] = p - code;
        for (int i = 0; i < n; i++, p++, code++) {
          if (code >= (1 << l)) fail("bad Huffman table");
          if (l <= kLookBits) {
            int shift = kLookBits - l;
            for (int f = 0; f < (1 << shift); f++)
              look[(code << shift) | f] = (uint16_t)((l << 8) | vals[p]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader: byte stuffing, fill bytes, and zeros once a
// marker is reached (jdhuff.c jpeg_fill_bit_buffer)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
            b = 0;
          }
        } else {
          p++;
        }
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (cnt < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  inline void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  inline int32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int32_t)v;
  }
  inline int decode(const Huffman& h) {
    uint32_t look = peek(kLookBits);
    uint16_t e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)peek(l);
    while (code > h.maxcode[l]) {
      l++;
      if (l > 16) fail("corrupt JPEG data: bad Huffman code");
      code = (int32_t)peek(l);
    }
    skip(l);
    return h.vals[code + h.valoffset[l]];
  }
  // The next marker's code, skipping whatever precedes it; p then points
  // past the marker.
  int next_marker() {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) {
        int m = p[1];
        p += 2;
        return m;
      }
      p++;
    }
    p = end;
    return -1;
  }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v + (int32_t)((-1u) << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// The islow IDCT (jidctint.c jpeg_idct_islow) and its range limit
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

// idct_limit[v & 1023] for the IDCT's output v (centred on 0): jdmaster.c
// prepare_range_limit_table seen from IDCT_range_limit.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v = i < 512 ? i : i - 1024;
      t[i] = (uint8_t)(v < -128 ? 0 : v > 127 ? 255 : v + 128);
    }
  }
};
const RangeLimit kLimit;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (int32_t)((uint32_t)((int32_t)in[0] * (int32_t)qt[0]) << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int32_t)in[16] * (int32_t)qt[16];
    z3 = (int32_t)in[48] * (int32_t)qt[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int32_t)in[0] * (int32_t)qt[0];
    z3 = (int32_t)in[32] * (int32_t)qt[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)in[56] * (int32_t)qt[56];
    tmp1 = (int32_t)in[40] * (int32_t)qt[40];
    tmp2 = (int32_t)in[24] * (int32_t)qt[24];
    tmp3 = (int32_t)in[8] * (int32_t)qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, s);
    w[56] = descale(tmp10 - tmp3, s);
    w[8] = descale(tmp11 + tmp2, s);
    w[48] = descale(tmp11 - tmp2, s);
    w[16] = descale(tmp12 + tmp1, s);
    w[40] = descale(tmp12 - tmp1, s);
    w[24] = descale(tmp13 + tmp0, s);
    w[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    constexpr int s = kConstBits + kPass1Bits + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kLimit.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = kLimit.t[descale(tmp10 + tmp3, s) & 1023];
    o[7] = kLimit.t[descale(tmp10 - tmp3, s) & 1023];
    o[1] = kLimit.t[descale(tmp11 + tmp2, s) & 1023];
    o[6] = kLimit.t[descale(tmp11 - tmp2, s) & 1023];
    o[2] = kLimit.t[descale(tmp12 + tmp1, s) & 1023];
    o[5] = kLimit.t[descale(tmp12 - tmp1, s) & 1023];
    o[3] = kLimit.t[descale(tmp13 + tmp0, s) & 1023];
    o[4] = kLimit.t[descale(tmp13 - tmp0, s) & 1023];
  }
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;         // blocks allocated (whole MCUs)
  int wblocks = 0, hblocks = 0;  // blocks holding image data
  int dw = 0, dh = 0;         // downsampled_width / _height
  bool latched = false;
  uint16_t q[64];             // natural order, latched at its first scan
  std::vector<int16_t> coef;  // (bh, bw, 64), natural order
  int dc_pred = 0;
  int coef_bits[64];          // progressive: the Al still owed (-1: none yet)
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, have_frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  Component comp[3];
  Huffman dc_tab[4], ac_tab[4];
  uint16_t qtab[4][64];
  bool qdef[4] = {false, false, false, false};
  int eobrun = 0;

  uint16_t be16(const uint8_t* p) const { return (uint16_t)((p[0] << 8) | p[1]); }

  void parse_sof(const uint8_t* p, int len, int marker) {
    if (have_frame) fail("JPEG with more than one frame");
    if (len < 6) fail("bad SOF segment");
    int precision = p[0];
    if (precision != 8) fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    height = be16(p + 1);
    width = be16(p + 3);
    ncomp = p[5];
    if (height == 0) fail("unsupported JPEG: height defined by a DNL marker");
    if (width == 0) fail("bad JPEG: zero width");
    if (ncomp == 4) fail("unsupported JPEG: CMYK/YCCK (4 components)");
    if (ncomp != 1 && ncomp != 3)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (len < 6 + 3 * ncomp) fail("bad SOF segment");
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad JPEG sampling factors or table index");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcux = (width + 8 * max_h - 1) / (8 * max_h);
    mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      if (max_h % c.h || max_v % c.v)
        fail("unsupported JPEG: fractional sampling factors");
    }
    have_frame = true;
  }

  void parse_dht(const uint8_t* p, int len) {
    while (len > 0) {
      if (len < 17) fail("bad DHT segment");
      int tc = p[0] >> 4, th = p[0] & 15;
      if (tc > 1 || th > 3) fail("bad DHT table index");
      int n = 0;
      for (int i = 0; i < 16; i++) n += p[1 + i];
      if (n > 256 || len < 17 + n) fail("bad DHT segment");
      (tc ? ac_tab : dc_tab)[th].build(p + 1, p + 17, n);
      p += 17 + n;
      len -= 17 + n;
    }
  }

  void parse_dqt(const uint8_t* p, int len) {
    while (len > 0) {
      int pq = p[0] >> 4, tq = p[0] & 15;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      int n = pq ? 128 : 64;
      if (len < 1 + n) fail("bad DQT segment");
      for (int k = 0; k < 64; k++)
        qtab[tq][kNatural[k]] = pq ? be16(p + 1 + 2 * k) : p[1 + k];
      qdef[tq] = true;
      p += 1 + n;
      len -= 1 + n;
    }
  }

  void parse_app(int marker, const uint8_t* p, int len) {
    if (marker == 0xE0 && len >= 14 && !std::memcmp(p, "JFIF\0", 5)) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(p, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
  }

  // One block of a sequential scan (jdhuff.c decode_mcu).
  void block_sequential(BitReader& br, Component& c, const Huffman& dc, const Huffman& ac,
                        int16_t* blk) {
    int s = br.decode(dc);
    if (s) {
      if (s > 15) fail("corrupt JPEG data: bad DC size");
      c.dc_pred += extend(br.get(s), s);
    }
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // Progressive scans (jdphuff.c decode_mcu_DC_first/_DC_refine/_AC_first/
  // _AC_refine).
  void block_dc_first(BitReader& br, Component& c, const Huffman& dc, int al, int16_t* blk) {
    int s = br.decode(dc);
    if (s) {
      if (s > 15) fail("corrupt JPEG data: bad DC size");
      c.dc_pred += extend(br.get(s), s);
    }
    blk[0] = (int16_t)((uint32_t)c.dc_pred << al);
  }

  void block_dc_refine(BitReader& br, int al, int16_t* blk) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void block_ac_first(BitReader& br, const Huffman& ac, int ss, int se, int al, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((uint32_t)extend(br.get(s), s) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void block_ac_refine(BitReader& br, const Huffman& ac, int ss, int se, int al, int16_t* blk) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* t = blk + kNatural[k];
          if (*t != 0) {
            if (br.get(1) && (*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = blk + kNatural[k];
        if (*t != 0 && br.get(1) && (*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
      }
      eobrun--;
    }
  }

  // Decodes the scan whose header is at p; returns where its entropy-coded
  // data ends (the next marker's 0xFF).
  const uint8_t* scan(const uint8_t* p, int len) {
    if (!have_frame) fail("bad JPEG: SOS before SOF");
    int ns = len > 0 ? p[0] : 0;
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) fail("bad SOS segment");
    int idx[3];
    int td[3], ta[3];
    for (int i = 0; i < ns; i++) {
      int cid = p[1 + 2 * i];
      idx[i] = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) idx[i] = j;
      if (idx[i] < 0) fail("bad SOS: unknown component");
      td[i] = p[2 + 2 * i] >> 4;
      ta[i] = p[2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3) fail("bad SOS table index");
    }
    const uint8_t* q = p + 1 + 2 * ns;
    int ss = q[0], se = q[1], ah = q[2] >> 4, al = q[2] & 15;
    enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } mode = SEQ;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (bad || al > 13 || (ah && ah - 1 != al)) fail("bad progressive JPEG scan parameters");
      mode = ss == 0 ? (ah ? DC_REFINE : DC_FIRST) : (ah ? AC_REFINE : AC_FIRST);
      for (int i = 0; i < ns; i++)
        for (int k = ss; k <= se; k++) comp[idx[i]].coef_bits[k] = al;
    }
    for (int i = 0; i < ns; i++) {
      Component& c = comp[idx[i]];
      if (!c.latched) {
        if (!qdef[c.tq]) fail("bad JPEG: quantization table not defined");
        std::memcpy(c.q, qtab[c.tq], sizeof(c.q));
        c.latched = true;
      }
      bool need_dc = mode == SEQ || mode == DC_FIRST;
      bool need_ac = mode == SEQ || mode == AC_FIRST || mode == AC_REFINE;
      if ((need_dc && !dc_tab[td[i]].defined) || (need_ac && !ac_tab[ta[i]].defined))
        fail("bad JPEG: Huffman table not defined");
      c.dc_pred = 0;
    }
    eobrun = 0;
    BitReader br{p + len, end};
    int restarts_left = restart_interval;
    auto restart = [&]() {
      int m = br.next_marker();
      if (m < 0xD0 || m > 0xD7) fail("corrupt JPEG data: missing restart marker");
      for (int i = 0; i < ns; i++) comp[idx[i]].dc_pred = 0;
      eobrun = 0;
      restarts_left = restart_interval;
    };
    auto block = [&](int ci, int16_t* blk) {
      Component& c = comp[idx[ci]];
      switch (mode) {
        case SEQ: block_sequential(br, c, dc_tab[td[ci]], ac_tab[ta[ci]], blk); break;
        case DC_FIRST: block_dc_first(br, c, dc_tab[td[ci]], al, blk); break;
        case DC_REFINE: block_dc_refine(br, al, blk); break;
        case AC_FIRST: block_ac_first(br, ac_tab[ta[ci]], ss, se, al, blk); break;
        case AC_REFINE: block_ac_refine(br, ac_tab[ta[ci]], ss, se, al, blk); break;
      }
    };
    if (ns == 1) {
      Component& c = comp[idx[0]];
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          block(0, &c.coef[((size_t)by * c.bw + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = comp[idx[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                block(i, &c.coef[((size_t)(my * c.v + v) * c.bw + mx * c.h + h) * 64]);
          }
        }
    }
    br.next_marker();
    return br.p == end ? end : br.p - 2;
  }

  void parse() {
    if (end - data < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    const uint8_t* p = data + 2;
    bool eoi = false;
    while (!eoi) {
      while (p < end && *p != 0xFF) p++;  // garbage between segments
      while (p < end && *p == 0xFF) p++;
      if (p >= end) break;
      int m = *p++;
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
      if (end - p < 2) fail("truncated JPEG");
      int len = be16(p);
      if (len < 2 || end - p < len) fail("truncated JPEG");
      const uint8_t* body = p + 2;
      int blen = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: parse_sof(body, blen, m); break;
        case 0xC3: fail("unsupported JPEG: lossless (SOF3)");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail("unsupported JPEG: hierarchical (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9: case 0xCA: case 0xCB: case 0xCC:
          fail("unsupported JPEG: arithmetic coding");
        case 0xC4: parse_dht(body, blen); break;
        case 0xDB: parse_dqt(body, blen); break;
        case 0xDD:
          if (blen < 2) fail("bad DRI segment");
          restart_interval = be16(body);
          break;
        case 0xDA: p = scan(body, blen); continue;
        default:
          if (m >= 0xE0 && m <= 0xEF) parse_app(m, body, blen);
          break;
      }
      p += len;
    }
    if (!have_frame) fail("bad JPEG: no frame");
  }

  // Whether libjpeg would smooth the blocks (jdcoefct.c smoothing_ok): a
  // progressive file whose scans leave one of the first nine AC
  // coefficients unsent or unrefined. Such files are refused.
  bool block_smoothing() const {
    if (!progressive) return false;
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      for (int pos : kQPos)
        if (comp[i].q[pos] == 0) return false;
      if (comp[i].coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++) useful |= comp[i].coef_bits[k] != 0;
    }
    return useful;
  }

  // IDCT of every block holding image data → (bh*8, bw*8) sample plane.
  std::vector<uint8_t> plane(const Component& c) const {
    int stride = c.bw * 8;
    std::vector<uint8_t> out((size_t)stride * c.bh * 8);
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                   &out[(size_t)by * 8 * stride + bx * 8], stride);
    return out;
  }

  // A component's samples at full size, rows 0..height-1, as libjpeg's
  // upsampler gives them (jdsample.c); `row` receives width samples.
  void upsample(const Component& c, const std::vector<uint8_t>& pl, std::vector<uint8_t>& out) {
    int stride = c.bw * 8;
    int hr = max_h / c.h, vr = max_v / c.v;
    out.resize((size_t)width * height);
    auto at = [&](int r, int x) -> int { return pl[(size_t)r * stride + x]; };
    int last_r = c.dh - 1, last_x = c.dw - 1;
    bool fancy_h2 = c.dw > 2;
    for (int y = 0; y < height; y++) {
      uint8_t* o = &out[(size_t)y * width];
      int r = y / vr;
      if (hr == 1 && vr == 1) {
        std::memcpy(o, &pl[(size_t)y * stride], width);
      } else if (hr == 2 && vr == 1 && fancy_h2) {  // h2v1_fancy_upsample
        for (int x = 0; x < width; x++) {
          int cx = x >> 1;
          int cur = at(r, cx) * 3;
          o[x] = (x & 1) ? (uint8_t)((cur + at(r, cx < last_x ? cx + 1 : last_x) + 2) >> 2)
                         : (uint8_t)((cur + at(r, cx > 0 ? cx - 1 : 0) + 1) >> 2);
        }
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        int far = (y & 1) ? (r < last_r ? r + 1 : last_r) : (r > 0 ? r - 1 : 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)((at(r, x) * 3 + at(far, x) + bias) >> 2);
      } else if (hr == 2 && vr == 2 && fancy_h2) {  // h2v2_fancy_upsample
        int far = (y & 1) ? (r < last_r ? r + 1 : last_r) : (r > 0 ? r - 1 : 0);
        auto colsum = [&](int cx) { return at(r, cx) * 3 + at(far, cx); };
        for (int x = 0; x < width; x++) {
          int cx = x >> 1;
          int cur = colsum(cx) * 3;
          o[x] = (x & 1) ? (uint8_t)((cur + colsum(cx < last_x ? cx + 1 : last_x) + 7) >> 4)
                         : (uint8_t)((cur + colsum(cx > 0 ? cx - 1 : 0) + 8) >> 4);
        }
      } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
        for (int x = 0; x < width; x++) o[x] = (uint8_t)at(r, x / hr);
      }
    }
  }

  void output(uint8_t* bgr) {
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].latched) fail("bad JPEG: a component has no scan");
    if (block_smoothing())
      fail("unsupported JPEG: progressive scans that leave low AC coefficients incomplete");
    std::vector<uint8_t> full[3];
    for (int i = 0; i < ncomp; i++) {
      upsample(comp[i], plane(comp[i]), full[i]);
    }
    size_t n = (size_t)width * height;
    if (ncomp == 1) {
      for (size_t i = 0; i < n; i++) bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = full[0][i];
      return;
    }
    bool rgb;  // jdapimin.c default_decompress_parms
    if (saw_jfif) rgb = false;
    else if (saw_adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    if (rgb) {
      for (size_t i = 0; i < n; i++) {
        bgr[3 * i] = full[2][i];
        bgr[3 * i + 1] = full[1][i];
        bgr[3 * i + 2] = full[0][i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return (int32_t)(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto limit = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t* Y = full[0].data();
    const uint8_t* Cb = full[1].data();
    const uint8_t* Cr = full[2].data();
    for (size_t i = 0; i < n; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      bgr[3 * i + 2] = limit(y + cr_r[cr]);
      bgr[3 * i + 1] = limit(y + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
      bgr[3 * i] = limit(y + cb_b[cb]);
    }
  }
};

}  // namespace

extern "C" {

// data: the whole file; out: (height, width, 3) uint8 BGR, where height and
// width must be the frame's (the caller reads them from the SOF segment).
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t height, int64_t width,
                char* err, int64_t errlen) {
  Decoder d;
  d.data = data;
  d.end = data + size;
  try {
    d.parse();
    if (d.width != width || d.height != height) fail("frame size differs from the caller's");
    d.output(out);
  } catch (const DecodeError& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, (size_t)errlen, "out of memory");
    return 2;
  }
  return 0;
}

// raw: h rows of (1 filter byte + rowbytes); out: (h, rowbytes). bpp is the
// filters' byte distance to the left neighbour (at least 1). Returns 0, or
// 1 + the row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t rowbytes,
                     int64_t bpp) {
  std::vector<uint8_t> zero((size_t)rowbytes, 0);
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* in = raw + y * (rowbytes + 1) + 1;
    int f = in[-1];
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : zero.data();
    int64_t i = 0;
    switch (f) {
      case 0:
        std::memcpy(cur, in, (size_t)rowbytes);
        break;
      case 1:
        for (; i < bpp && i < rowbytes; i++) cur[i] = in[i];
        for (; i < rowbytes; i++) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        break;
      case 2:
        for (; i < rowbytes; i++) cur[i] = (uint8_t)(in[i] + up[i]);
        break;
      case 3:
        for (; i < bpp && i < rowbytes; i++) cur[i] = (uint8_t)(in[i] + (up[i] >> 1));
        for (; i < rowbytes; i++) cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      case 4:
        for (; i < bpp && i < rowbytes; i++) cur[i] = (uint8_t)(in[i] + up[i]);
        for (; i < rowbytes; i++) {
          int a = cur[i - bpp], b = up[i], c = up[i - bpp];
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          cur[i] = (uint8_t)(in[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
