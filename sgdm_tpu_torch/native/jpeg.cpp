// A JPEG decoder that gives what libjpeg-turbo gives under its defaults,
// which is what PIL's ``Image.open(f).convert("RGB")`` (or ``"L"``) reads:
//
//   * markers SOI, APPn (JFIF APP0 and Adobe APP14 are read, the rest
//     skipped), COM, DQT (8- and 16-bit tables), DHT, DRI with RST0-7, SOS,
//     EOI; byte stuffing and fill bytes;
//   * frames SOF0 / SOF1 (sequential Huffman, 8-bit) and SOF2 (progressive
//     Huffman: DC first and refine, AC first and refine, EOB runs);
//   * 1 component (grey), 3 (YCbCr, or RGB under Adobe transform 0) and 4
//     (Adobe CMYK, or YCCK under transform 2), sampling factors 1 or 2;
//   * jidctint.c `jpeg_idct_islow` with its range-limit table;
//   * jdsample.c fancy upsampling (h2v1, h1v2, h2v2 with its +8/+7 bias;
//     plain replication where a row is 2 samples wide or less) over the
//     whole component plane, edge rows and columns replicated, which is what
//     jdmainct.c's context rows amount to;
//   * jdcolor.c `ycc_rgb_convert` (SCALEBITS 16 tables), `ycck_cmyk_convert`,
//     then PIL's inverted-CMYK unpack and `cmyk2rgb`; "L" is PIL's L24 of the
//     RGB (a grey file's samples as they are).
//
// A progressive file whose scans leave AC bits unsent makes libjpeg smooth
// its blocks (jdcoefct.c `smoothing_ok`); that, arithmetic coding, 12-bit,
// lossless and hierarchical frames, DNL, other sampling factors, other
// component counts and truncated or corrupt entropy data are refused with a
// message, never decoded differently.
//
// Interface (no global state: any number of threads may call at once):
//   int jpeg_header(data, n, info[4], err, errlen): width, height,
//       components, progressive;
//   int jpeg_decode(data, n, out, mode, err, errlen): mode 0 writes
//       [H, W, 3] RGB, mode 1 [H, W] grey, into the caller's C-contiguous
//       uint8 buffer.
// Both return 0, or -1 with a message in ``err``.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // past 63: libjpeg's guard

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // (length << 8) | value for codes of at most 9 bits; 0: longer

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    memcpy(vals, v, nvals);
    memset(look, 0, sizeof(look));
    int32_t code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      int n = bits[l];
      valoffset[l] = k - code;
      for (int i = 0; i < n; i++, k++, code++) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); j++)
            look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = n ? code - 1 : -1;
      if (code > (1 << l)) fail("bad Huffman table (code space overflow)");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;          // downsampled_width / height (samples)
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  bool latched = false;
  int16_t q[64];  // the table latched at the component's first scan, as libjpeg's
                  // ISLOW_MULT_TYPE (short) holds it
  int coef_bits[64];
  std::vector<int16_t> coef;   // bw * bh * 64
  std::unique_ptr<uint8_t[]> plane;  // bw * 8 by bh * 8 samples (the decoded blocks only)
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_def[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int W = 0, H = 0, nc = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, have_frame = false;
  Comp comp[4];

  // bit reader: ``nbits`` valid bits at the bottom of ``acc``, oldest first
  uint64_t acc = 0;
  int nbits = 0;
  int pad_bits = 0;       // zero bits appended past the segment's end
  bool at_marker = false; // pos is at the 0xFF of the marker that ended the segment
  bool at_eof = false;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  // ------------------------------------------------------------ bit reader
  void fill() {
    while (nbits <= 56) {
      if (at_marker || at_eof) {
        acc <<= 8;
        nbits += 8;
        pad_bits += 8;
        continue;
      }
      if (pos >= n) {
        at_eof = true;
        continue;
      }
      uint8_t b = d[pos];
      if (b == 0xFF) {
        size_t p = pos + 1;
        while (p < n && d[p] == 0xFF) p++;  // fill bytes before a marker
        if (p >= n) {
          at_eof = true;
          continue;
        }
        if (d[p] == 0x00) {
          pos = p + 1;
        } else {
          pos = p - 1;  // the last 0xFF before the marker code
          at_marker = true;
          continue;
        }
      } else {
        pos++;
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline int bits(int k) {  // k <= 16
    if (k == 0) return 0;
    if (nbits < k) fill();
    nbits -= k;
    return (int)((acc >> nbits) & ((1u << k) - 1));
  }

  inline int bit() { return bits(1); }

  inline int decode(const Huff& h) {
    if (nbits < 16) fill();
    int v = h.look[(acc >> (nbits - 9)) & 511];
    if (v) {
      nbits -= v >> 8;
      return v & 255;
    }
    for (int l = 10; l <= 16; l++) {
      int32_t code = (int32_t)((acc >> (nbits - l)) & ((1u << l) - 1));
      if (code <= h.maxcode[l]) {
        nbits -= l;
        return h.vals[(h.valoffset[l] + code) & 255];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }

  static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  // The segment ended: were bits past its end consumed?
  void check_segment() {
    if (pad_bits > nbits) {
      if (at_eof) fail("truncated JPEG file: entropy-coded data ends early");
      fail("corrupt JPEG data: a marker inside entropy-coded data");
    }
  }

  void reset_bits() {
    acc = 0;
    nbits = 0;
    pad_bits = 0;
    at_marker = false;
    at_eof = false;
  }

  // Position ``pos`` at the next marker's 0xFF (skipping what is not one).
  void seek_marker() {
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) return;
      pos++;
    }
    fail("truncated JPEG file: no EOI marker");
  }

  // --------------------------------------------------------------- markers
  int u8() {
    if (pos >= n) fail("truncated JPEG file");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // libjpeg's next_marker: skip anything up to 0xFF, then the fill bytes
    while (pos < n && d[pos] != 0xFF) pos++;
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) fail("truncated JPEG file: no EOI marker");
    return d[pos++];
  }

  void read_dqt() {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0 || end > n) fail("truncated JPEG file (DQT)");
    while (pos < end) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) fail("bad DQT table number");
      if (prec > 1) fail("bad DQT precision");
      for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      qt_def[tq] = true;
    }
    if (pos != end) fail("bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0 || end > n) fail("truncated JPEG file (DHT)");
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table class or number");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = (uint8_t)u8();
        total += counts[l];
      }
      if (total > 256 || pos + total > end) fail("bad DHT table");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = (uint8_t)u8();
      (tc ? ac[th] : dc[th]).build(counts, vals, total);
    }
    if (pos != end) fail("bad DHT length");
  }

  void read_app(int m) {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) fail("truncated JPEG file (APPn)");
    const uint8_t* p = d + pos;
    if (m == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) saw_jfif = true;
    if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos += len;
  }

  void skip_segment() {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) fail("truncated JPEG file (marker segment)");
    pos += len;
  }

  void read_sof(int m) {
    if (have_frame) fail("more than one frame (SOF) in the file");
    int len = u16();
    int prec = u8();
    H = u16();
    W = u16();
    nc = u8();
    if (len != 8 + 3 * nc) fail("bad SOF length");
    if (prec != 8) fail("only 8-bit JPEG is decoded, got " + std::to_string(prec) + "-bit");
    if (H == 0) fail("a height of 0 (defined by a DNL marker) is not supported");
    if (W == 0) fail("bad JPEG width 0");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG with " + std::to_string(nc) + " components is not supported");
    progressive = (m == 0xC2);
    hmax = vmax = 1;
    for (int i = 0; i < nc; i++) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 2 || comp[i].v < 1 || comp[i].v > 2)
        fail("sampling factors outside {1, 2} are not supported (component " +
             std::to_string(i) + ": " + std::to_string(comp[i].h) + "x" +
             std::to_string(comp[i].v) + ")");
      if (comp[i].tq > 3) fail("bad quantization table number");
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
        return;
      }
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) fail("lossless JPEG is not supported");
      if (m == 0xC5 || m == 0xC6) fail("hierarchical JPEG is not supported");
      if (m == 0xC9 || m == 0xCA || m == 0xCD || m == 0xCE || m == 0xCC)
        fail("arithmetic-coded JPEG is not supported");
      if (m == 0xD8) fail("bad JPEG: a second SOI");
      if (m == 0xD9) fail("JPEG file without a frame (EOI before SOF)");
      if (m == 0xDA) fail("bad JPEG: SOS before SOF");
      handle_misc(m);
    }
  }

  void handle_misc(int m) {
    if (m == 0xDB) read_dqt();
    else if (m == 0xC4) read_dht();
    else if (m == 0xDD) {
      int len = u16();
      if (len != 4) fail("bad DRI length");
      restart_interval = u16();
    } else if (m >= 0xE0 && m <= 0xEF) read_app(m);
    else if (m == 0xDC) fail("DNL markers are not supported");
    else if (m == 0xCC) fail("arithmetic-coded JPEG is not supported (DAC)");
    else if (m >= 0xD0 && m <= 0xD7) {
      // a stray RSTn between segments: libjpeg warns and goes on
    } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD) || m == 0xC8 || m == 0xDE || m == 0xDF)
      skip_segment();
    else if (m == 0x01) {
      // TEM has no length
    } else
      fail("unexpected JPEG marker 0xFF" + std::to_string(m));
  }

  // ---------------------------------------------------------------- scans
  int scomp[4];
  int ns = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;

  void read_sos() {
    int len = u16();
    ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("bad SOS");
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      int ci = -1;
      for (int j = 0; j < nc; j++)
        if (comp[j].id == id) ci = j;
      if (ci < 0) fail("SOS names a component the frame does not have");
      for (int j = 0; j < i; j++)
        if (scomp[j] == ci) fail("SOS names a component twice");
      scomp[i] = ci;
      comp[ci].dc_tbl = t >> 4;
      comp[ci].ac_tbl = t & 15;
      if (comp[ci].dc_tbl > 3 || comp[ci].ac_tbl > 3) fail("bad Huffman table number");
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    if (progressive) {
      bool bad;
      if (Ss == 0) bad = Se != 0;
      else bad = Se < Ss || Se > 63 || ns != 1;
      if (((Ah != 0) && (Al != Ah - 1)) || Al > 13) bad = true;
      if (bad) fail("bad progressive scan parameters");
      // an AC scan before its DC scan, or a refinement of unexpected bits:
      // libjpeg warns and decodes all the same
      for (int i = 0; i < ns; i++)
        for (int k = Ss; k <= Se; k++) comp[scomp[i]].coef_bits[k] = Al;
    } else {
      // Ss, Se, Ah and Al are ignored in sequential mode, as libjpeg does
      for (int i = 0; i < ns; i++)
        for (int k = 0; k < 64; k++) comp[scomp[i]].coef_bits[k] = 0;
    }
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[scomp[i]];
      if (!c.latched) {
        if (!qt_def[c.tq]) fail("a scan before its quantization table (DQT)");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive || Ss != 0;
      if (need_dc && !dc[c.dc_tbl].defined) fail("a scan uses an undefined DC Huffman table");
      if (need_ac && !ac[c.ac_tbl].defined) fail("a scan uses an undefined AC Huffman table");
    }
  }

  void block_sequential(Comp& c, int16_t* blk) {
    int s = decode(dc[c.dc_tbl]);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const Huff& t = ac[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      int rs = decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(Comp& c, int16_t* blk) {
    int s = decode(dc[c.dc_tbl]);
    int diff = s ? extend(bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)((unsigned)c.pred << Al);
  }

  void block_dc_refine(int16_t* blk) {
    if (bit()) blk[0] = (int16_t)(blk[0] | (1 << Al));
  }

  void block_ac_first(Comp& c, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& t = ac[c.ac_tbl];
    for (int k = Ss; k <= Se; k++) {
      int rs = decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((unsigned)extend(bits(s), s) << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          eobrun--;
          break;
        }
      }
    }
  }

  void block_ac_refine(Comp& c, int16_t* blk) {
    const int p1 = 1 << Al;
    const int m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      const Huff& t = ac[c.ac_tbl];
      for (; k <= Se; k++) {
        int rs = decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // s != 1 is corrupt data: libjpeg warns and reads the bit all the same
          s = bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (bit()) {
              if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (bit()) {
            if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  inline void decode_block(Comp& c, int16_t* blk) {
    if (!progressive) block_sequential(c, blk);
    else if (Ss == 0) {
      if (Ah == 0) block_dc_first(c, blk);
      else block_dc_refine(blk);
    } else if (Ah == 0) block_ac_first(c, blk);
    else block_ac_refine(c, blk);
  }

  void restart_reset() {
    for (int i = 0; i < nc; i++) comp[i].pred = 0;
    eobrun = 0;
  }

  void scan() {
    read_sos();
    reset_bits();
    restart_reset();
    int64_t total;
    int sbw = 0, sbh = 0;
    if (ns == 1) {  // non-interleaved: one block an MCU, the component's own block grid
      Comp& c = comp[scomp[0]];
      sbw = (c.dw + 7) / 8;
      sbh = (c.dh + 7) / 8;
      total = (int64_t)sbw * sbh;
    } else {
      total = (int64_t)mcux * mcuy;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        check_segment();
        if (!at_marker) seek_marker();
        if (pos + 1 >= n || d[pos + 1] != 0xD0 + next_rst)
          fail("corrupt JPEG data: expected RST" + std::to_string(next_rst));
        pos += 2;
        next_rst = (next_rst + 1) & 7;
        reset_bits();
        restart_reset();
      }
      if (ns == 1) {
        Comp& c = comp[scomp[0]];
        int bx = (int)(m % sbw), by = (int)(m / sbw);
        decode_block(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
      } else {
        int mx = (int)(m % mcux), my = (int)(m / mcux);
        for (int i = 0; i < ns; i++) {
          Comp& c = comp[scomp[i]];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++) {
              size_t bx = (size_t)mx * c.h + x, by = (size_t)my * c.v + y;
              decode_block(c, &c.coef[(by * c.bw + bx) * 64]);
            }
        }
      }
    }
    check_segment();
    if (!at_marker) seek_marker();
    reset_bits();
  }

  void decode_all() {
    header();
    bool any_scan = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {  // a sequential file too may have a scan per component
        scan();
        any_scan = true;
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || (m >= 0xC5 && m <= 0xC7) ||
                 (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
        fail("more than one frame (SOF) in the file");
      } else if (m == 0xD8) {
        fail("bad JPEG: a second SOI");
      } else {
        handle_misc(m);
      }
    }
    if (!any_scan) fail("JPEG file without image data (no SOS)");
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      if (c.coef.empty()) fail("a component without any scan");
      if (progressive) {
        // jdcoefct.c smoothing_ok: DC must be known, and libjpeg smooths the
        // blocks when coefficient 1-9 lacks bits; this decoder does not
        if (c.coef_bits[0] < 0) fail("progressive JPEG whose DC scans are missing");
        for (int k = 1; k < 10; k++)
          if (c.coef_bits[k] != 0)
            fail("progressive JPEG whose scans leave AC bits unsent (libjpeg smooths its "
                 "blocks); not supported");
      }
    }
  }
};

// ------------------------------------------------------------------- IDCT

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

inline uint8_t range_limit(int64_t x) {
  // libjpeg's post-IDCT table: the index masked to 10 bits, then centred and clamped
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const int16_t* qp = q + col;
    int* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
      for (int i = 0; i < 8; i++) wp[8 * i] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + row * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = range_limit(descale(wp[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

void idct_component(Comp& c) {
  size_t stride = (size_t)c.bw * 8;
  c.plane.reset(new uint8_t[stride * c.bh * 8]);
  int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
  for (int by = 0; by < nby; by++)
    for (int bx = 0; bx < nbx; bx++)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                 c.plane.get() + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
}

// ------------------------------------------------------------ upsampling

// Row ``y`` of one component at the output size (jdsample.c), into ``buf``
// (2 * bw * 8 samples); returns the row, which for a full-size component is
// the plane's own.
const uint8_t* upsample_row(const Comp& c, int hmax, int vmax, int y, uint8_t* buf) {
  const size_t stride = (size_t)c.bw * 8;
  const uint8_t* p = c.plane.get();
  const int hx = hmax / c.h, vx = vmax / c.v;
  const int dw = c.dw;
  if (vx == 1) {
    const uint8_t* in = p + y * stride;
    if (hx == 1) return in;
    if (dw <= 2) {  // h2v1_upsample: replication
      for (int i = 0; i < dw; i++) buf[2 * i] = buf[2 * i + 1] = in[i];
      return buf;
    }
    // h2v1_fancy_upsample: edges replicate, so out[0] = in[0], out[2dw-1] = in[dw-1]
    buf[0] = in[0];
    buf[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; i++) {
      int v = in[i] * 3;
      buf[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
      buf[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
    }
    buf[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    buf[2 * dw - 1] = in[dw - 1];
    return buf;
  }
  // vertical 2: the nearer input row and the one above (even rows) or below
  // (odd rows), the image's first and last rows replicated past its edges
  const int i = y >> 1;
  const int nb = (y & 1) ? (i + 1 < c.dh ? i + 1 : i) : (i > 0 ? i - 1 : 0);
  const uint8_t* in0 = p + i * stride;
  const uint8_t* in1 = p + nb * stride;
  if (hx == 1) {  // h1v2_fancy_upsample
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < dw; x++) buf[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    return buf;
  }
  if (dw <= 2) {  // h2v2_upsample: replication of the nearer row
    for (int x = 0; x < dw; x++) buf[2 * x] = buf[2 * x + 1] = in0[x];
    return buf;
  }
  // h2v2_fancy_upsample: column sums 3 * near + far, then +8 / +7 biases
  int last = in0[0] * 3 + in1[0], cur = last;
  for (int x = 0; x < dw; x++) {
    int next = x + 1 < dw ? in0[x + 1] * 3 + in1[x + 1] : cur;
    buf[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
    buf[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
  }
  return buf;
}

// ---------------------------------------------------------------- colour

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline uint8_t l24(int r, int g, int b) {
  return (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

void decode_to(const uint8_t* data, size_t n, uint8_t* out, int mode) {
  Decoder dec(data, n);
  dec.decode_all();
  const int W = dec.W, H = dec.H, nc = dec.nc;
  size_t buf_len = 0;
  for (int i = 0; i < nc; i++) {
    idct_component(dec.comp[i]);
    std::vector<int16_t>().swap(dec.comp[i].coef);
    buf_len += (size_t)dec.comp[i].bw * 16;
  }
  std::unique_ptr<uint8_t[]> bufs(new uint8_t[buf_len]);
  uint8_t* buf[4];
  buf[0] = bufs.get();
  for (int i = 1; i < nc; i++) buf[i] = buf[i - 1] + (size_t)dec.comp[i - 1].bw * 16;
  static const YccTables T;
  // jdapimin.c default_decompress_parms: for 3 components JFIF means YCbCr;
  // else Adobe's transform; else the component ids 'R', 'G', 'B' mean RGB.
  // For 4, libjpeg gives CMYK (YCCK converted by ycck_cmyk_convert) and PIL
  // unpacks it inverted ("CMYK;I", Adobe's convention), then cmyk2rgb.
  bool rgb = false, ycck = false;
  if (nc == 3) {
    if (dec.saw_jfif) rgb = false;
    else if (dec.saw_adobe) rgb = dec.adobe_transform == 0;
    else rgb = dec.comp[0].id == 82 && dec.comp[1].id == 71 && dec.comp[2].id == 66;
  } else if (nc == 4) {
    ycck = dec.saw_adobe && dec.adobe_transform != 0;
  }
  const uint8_t* row[4];
  for (int y = 0; y < H; y++) {
    for (int i = 0; i < nc; i++) row[i] = upsample_row(dec.comp[i], dec.hmax, dec.vmax, y, buf[i]);
    uint8_t* o = out + (size_t)y * W * (mode == 1 ? 1 : 3);
    if (nc == 1) {
      if (mode == 1) memcpy(o, row[0], W);
      else
        for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
      continue;
    }
    for (int x = 0; x < W; x++) {
      int r, g, bl;
      if (nc == 3) {
        if (rgb) {
          r = row[0][x];
          g = row[1][x];
          bl = row[2][x];
        } else {
          int yy = row[0][x], cb = row[1][x], cr = row[2][x];
          r = clamp8(yy + T.cr_r[cr]);
          g = clamp8(yy + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16));
          bl = clamp8(yy + T.cb_b[cb]);
        }
      } else {
        int c0 = row[0][x], c1 = row[1][x], c2 = row[2][x], k = row[3][x];
        if (ycck) {
          int yy = c0, cb = c1, cr = c2;
          c0 = clamp8(255 - (yy + T.cr_r[cr]));
          c1 = clamp8(255 - (yy + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16)));
          c2 = clamp8(255 - (yy + T.cb_b[cb]));
        }
        c0 = 255 - c0;
        c1 = 255 - c1;
        c2 = 255 - c2;
        k = 255 - k;
        int nk = 255 - k;
        r = clamp8(nk - muldiv255(c0, nk));
        g = clamp8(nk - muldiv255(c1, nk));
        bl = clamp8(nk - muldiv255(c2, nk));
      }
      if (mode == 1) {
        o[x] = l24(r, g, bl);
      } else {
        o[3 * x] = (uint8_t)r;
        o[3 * x + 1] = (uint8_t)g;
        o[3 * x + 2] = (uint8_t)bl;
      }
    }
  }
}

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.header();
    info[0] = dec.W;
    info[1] = dec.H;
    info[2] = dec.nc;
    info[3] = dec.progressive ? 1 : 0;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return -1;
}

int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int mode, char* err, int errlen) {
  try {
    decode_to(data, (size_t)n, out, mode);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
