// jsvx native bitstream front-end: slice/macroblock/block VLC parsing.
//
// The serial Huffman walk is the one stage of JSV decode that cannot run on
// the TPU (SURVEY.md section 7 "hard parts"); the reference runs it in
// JavaScript (decoders/jsv.js:683-1525).  This is the optimized host
// implementation: LUT-driven multi-bit decode into caller-provided dense
// planes, one call per picture.  The Python parser in
// jsvx/bitstream/parser.py is the executable specification; outputs must be
// bit-identical (tests/test_native_parser.py fuzzes the equivalence).
//
// VLC lookup tables are passed in from Python at session creation so the
// code tables live in exactly one place (jsvx/coding/tables.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Two-level VLC lookup.  A flat 2^max_len table (up to 2^16 for
// DCT_COEFF) spreads each short code over thousands of slots — every
// lookup is a cache miss.  Instead: a <=10-bit primary table (4 KB,
// L1-resident) resolves short codes directly; the few long-code prefixes
// chain to small secondary tables.  Entries pack (value << 8) | len;
// len 0 = invalid, len 0xFF = extended (value = secondary base index).
struct Lut {
  std::vector<uint32_t> prim;
  std::vector<uint32_t> sub;
  int bits = 0;     // full code length bound (secondary lookup width)
  int bits1 = 0;    // primary lookup width

  void set(const int32_t* v, const uint8_t* l, int b) {
    bits = b;
    bits1 = b < 10 ? b : 10;
    int rest = bits - bits1;
    prim.assign(size_t(1) << bits1, 0);
    sub.clear();
    for (size_t p = 0; p < prim.size(); ++p) {
      size_t base = p << rest;
      uint8_t len0 = l[base];
      if (len0 != 0 && len0 <= bits1) {
        prim[p] = (uint32_t(v[base]) << 8) | len0;
        continue;
      }
      // check whether ANY entry under this prefix is a (long) code
      bool any = false;
      for (size_t i = 0; i < (size_t(1) << rest); ++i)
        if (l[base + i]) { any = true; break; }
      if (!any) continue;                  // invalid prefix: len 0
      uint32_t sub_base = (uint32_t)sub.size();
      for (size_t i = 0; i < (size_t(1) << rest); ++i)
        sub.push_back((uint32_t(v[base + i]) << 8) | l[base + i]);
      prim[p] = (sub_base << 8) | 0xFF;
    }
  }
};

constexpr int kErrStall = -1;      // ran past end of picture span
constexpr int kErrBadCode = -2;    // invalid VLC code
constexpr int kErrOverrun = -3;    // macroblock address out of range

// Bit reader with a cached 64-bit big-endian window: consecutive short
// reads (the VLC walk averages ~5 bits/symbol) hit the register cache and
// only reload one aligned 8-byte word when fewer than 57 valid bits
// remain.  This is the hot structure of the whole host front-end (the
// analog of the reference's readCode/getBits walk, jsv.js:1593-1599).
struct BitReader {
  const uint8_t* data;
  int64_t n_bits;
  int64_t pos = 0;
  bool bad = false;
  uint64_t cache = 0;
  int64_t cache_pos = INT64_MIN / 2;   // bit pos of cache's first bit

  BitReader(const uint8_t* d, int64_t n_bytes)
      : data(d), n_bits(n_bytes * 8) {}

  inline void refill() {
    int64_t byte = pos >> 3;
    uint64_t w;
    if (byte + 8 <= (n_bits >> 3)) {
      std::memcpy(&w, data + byte, 8);
      w = __builtin_bswap64(w);
    } else {
      w = 0;
      int64_t avail = (n_bits >> 3) - byte;
      for (int64_t i = 0; i < avail; ++i)
        w |= uint64_t(data[byte + i]) << (56 - 8 * i);
    }
    cache = w;
    cache_pos = byte << 3;
  }

  // 57+ bits valid from pos (zero-padded past the end).
  inline uint64_t window() {
    if (pos - cache_pos > 7) refill();
    return cache << (pos - cache_pos);
  }

  inline uint32_t peek(int bits) {
    return uint32_t(window() >> (64 - bits));
  }

  inline uint32_t get(int bits) {
    if (pos + bits > n_bits) { bad = true; return 0; }
    uint32_t v = peek(bits);
    pos += bits;
    return v;
  }

  inline void skip(int bits) { pos += bits; if (pos > n_bits) bad = true; }

  // Decode one code; returns the packed (value<<8)|len entry (0 on a
  // bad code, with `bad` set) WITHOUT consuming bits.
  inline uint32_t vlc_entry(const Lut& t) {
    uint64_t w = window();
    uint32_t e = t.prim[uint32_t(w >> (64 - t.bits1))];
    if ((e & 0xFF) == 0xFF) {
      uint32_t rest = uint32_t(w >> (64 - t.bits))
                      & ((1u << (t.bits - t.bits1)) - 1);
      e = t.sub[(e >> 8) + rest];
    }
    return e;
  }

  inline int32_t vlc(const Lut& t) {
    uint32_t e = vlc_entry(t);
    uint32_t len = e & 0xFF;
    if (len == 0 || pos + (int64_t)len > n_bits) { bad = true; return 0; }
    pos += len;
    return int32_t(e) >> 8;
  }
};

// Sign-folded coefficient table: one lookup yields the SIGNED level, the
// run, the total bit length (code + marker/sign bits), and a flag — so
// the per-coefficient hot loop has no data-dependent branches (the sign
// bit and the mid-block '1'-prefix EOB/one disambiguation are baked into
// the table).  Entry: [7:0] total_len, [13:8] run, [15:14] flag
// (0 normal / 1 EOB / 2 escape / 3 extended), [31:16] level int16
// (extended: sub-table base).
struct CoeffTab {
  static constexpr int B1 = 11;
  int bits = 0;                    // original flat-table width (16)
  std::vector<uint32_t> prim;      // 2^11 * 4 B = 8 KB, L1-resident
  std::vector<uint32_t> sub;

  static uint32_t pack(int level, int run, int flag, int len) {
    return (uint32_t(uint16_t(int16_t(level))) << 16)
           | (uint32_t(flag) << 14) | (uint32_t(run) << 8)
           | uint32_t(len);
  }

  void build(const int32_t* v, const uint8_t* l, int b) {
    bits = b;
    prim.assign(size_t(1) << B1, 0);
    sub.clear();
    const int pad = b - B1;                // flat-index pad bits (5)
    const int rb = b + 1 - B1;             // sub lookup width (6)
    for (uint32_t p = 0; p < (1u << B1); ++p) {
      uint32_t idx = p << pad;
      uint8_t len = l[idx];
      int32_t val = v[idx];
      if (len != 0 && val == 0xFFFF) {     // escape prefix (6 bits)
        prim[p] = pack(0, 0, 2, len);
      } else if (len != 0 && val == 0x0001) {
        // '1' prefix mid-block: marker bit 0 = EOB, 1 = (0,1) + sign
        uint32_t marker = (p >> (B1 - 1 - len)) & 1;
        if (!marker) prim[p] = pack(0, 0, 1, len + 1);
        else {
          uint32_t sign = (p >> (B1 - 2 - len)) & 1;
          prim[p] = pack(sign ? -1 : 1, 0, 0, len + 2);
        }
      } else if (len != 0 && len <= B1 - 1) {
        uint32_t sign = (p >> (B1 - 1 - len)) & 1;
        int lv = val & 0xFF;
        prim[p] = pack(sign ? -lv : lv, val >> 8, 0, len + 1);
      } else {
        // invalid or long code: scan the prefix's flat range
        bool any = false;
        for (uint32_t i = 0; i < (1u << pad); ++i)
          if (l[idx + i]) { any = true; break; }
        if (!any) { prim[p] = 0; continue; }
        uint32_t base = (uint32_t)sub.size();
        for (uint32_t s2 = 0; s2 < (1u << rb); ++s2) {
          uint64_t idx17 = ((uint64_t)p << rb) | s2;   // b+1 bits
          uint32_t idx16 = uint32_t(idx17 >> 1);
          uint8_t ln = l[idx16];
          int32_t vv = v[idx16];
          if (ln == 0 || vv == 0xFFFF || vv == 0x0001) {
            sub.push_back(0);              // cannot be long codes
            continue;
          }
          uint32_t sign = uint32_t(idx17 >> (b - ln)) & 1;
          int lv = vv & 0xFF;
          sub.push_back(pack(sign ? -lv : lv, vv >> 8, 0, ln + 1));
        }
        prim[p] = (base << 16) | (3u << 14);
      }
    }
  }
};

struct Parser {
  Lut addr, type_i, type_p, cbp, motion, dc_lum, dc_chrom, coeff;
  CoeffTab coeff2;
  uint8_t zigzag[64];
  uint8_t zigzag_inv[64];   // spatial position -> scan index
};

struct SliceState {
  int32_t quantizer_scale = 0;
  int32_t dc_y = 128, dc_cb = 128, dc_cr = 128, dc_a = 128;
  int32_t motion_h = 0, motion_v = 0;
  int32_t motion_h_prev = 0, motion_v_prev = 0;

  void reset_dc() { dc_y = dc_cb = dc_cr = dc_a = 128; }
  void reset_mv() { motion_h = motion_v = motion_h_prev = motion_v_prev = 0; }
};

struct PictureOut {
  // per-component coefficient planes; [3] = alpha (YUVA, full-res)
  int16_t* levels[4] = {nullptr, nullptr, nullptr, nullptr};
  // per-component last-non-zero: Y/A at (2*mbH, 2*mbW), chroma (mbH, mbW)
  uint8_t* lnz[4] = {nullptr, nullptr, nullptr, nullptr};
  uint8_t* mb_quant;
  uint8_t* mb_intra;
  int16_t* mb_mv;     // (mbH, mbW, 2) = (vy, vx)
  uint8_t* mb_rep_add;
  // optional device-ready per-pixel dequant sideband (may be null):
  //   mult  = quantizer_scale * quant_matrix value at this position
  //   flags = bit0 non-intra, bit1 inside coded scan range, bit2 intra DC
  int16_t* mult[4] = {nullptr, nullptr, nullptr, nullptr};
  uint8_t* flags[4] = {nullptr, nullptr, nullptr, nullptr};
  const uint8_t* intra_q = nullptr;      // 64, spatial order
  const uint8_t* non_intra_q = nullptr;
};

struct PictureCtx {
  int32_t mb_w, mb_h, coded_w;
  int32_t picture_type;    // 1 = I, 2 = P
  int32_t full_pel, f_code;
  int32_t yuva;            // 4th alpha component (4 extra blocks per MB)
};

// --- block-output policies -------------------------------------------------
//
// parse_block/parse_macroblock are templated on an Emit policy so the
// dense path (scatter into caller plane buffers, the round-1/2 wire
// format) and the compact path (append (scan_pos, level) entries — the
// host->device wire format that ships coded coefficients only) share
// one copy of the VLC hot loop.

struct DenseEmit {
  PictureOut* o;
  const Parser* p;
  const PictureCtx* c;

  inline void hint(int64_t) {}
  // per-block state
  int16_t* dst = nullptr;
  int stride = 0;
  int comp = 0, by = 0, bx = 0;

  inline void begin(int comp_, int by_, int bx_) {
    comp = comp_; by = by_; bx = bx_;
    stride = (comp == 0 || comp == 3) ? c->coded_w : (c->coded_w >> 1);
    dst = o->levels[comp] + (int64_t)by * 8 * stride + bx * 8;
    for (int i = 0; i < 8; ++i)
      std::memset(dst + (int64_t)i * stride, 0, 16);
  }
  // intra DC (scan position 0), raw unclamped predictor value
  inline void dc(int32_t v) { dst[0] = (int16_t)v; }
  inline void coef(int n, int32_t level) {
    uint32_t zz = p->zigzag[n];
    dst[(zz >> 3) * stride + (zz & 7)] = (int16_t)level;
  }
  inline void end(int n, bool intra, const SliceState& s) {
    if (o->mult[comp] != nullptr) {
      // emit the per-pixel dequant sideband in the same pass
      const uint8_t* m = intra ? o->intra_q : o->non_intra_q;
      const int32_t q = s.quantizer_scale;
      int16_t* md = o->mult[comp] + (int64_t)by * 8 * stride + bx * 8;
      uint8_t* fd = o->flags[comp] + (int64_t)by * 8 * stride + bx * 8;
      for (int i = 0; i < 8; ++i) {
        for (int j = 0; j < 8; ++j) {
          int pos = i * 8 + j;
          md[j] = (int16_t)(q * m[pos]);
          uint8_t f = intra ? 0 : 1;
          if (p->zigzag_inv[pos] < n) f |= 2;
          if (pos == 0 && intra) f |= 4;
          fd[j] = f;
        }
        md += stride;
        fd += stride;
      }
    }
    uint8_t lnz = (uint8_t)(n > 255 ? 255 : n);
    int lnz_stride = (comp == 0 || comp == 3) ? c->mb_w * 2 : c->mb_w;
    o->lnz[comp][(int64_t)by * lnz_stride + bx] = lnz;
  }
};

// Compact wire format, one uint16 per coded coefficient:
//   (spatial_pos:6 << 10) | (level + 512)
// The zig-zag undo happens HERE (one table lookup in the parse hot
// loop) so the device expansion needs no 64-way gather per entry.
// Levels always fit [-512, 511]: AC/escape levels are <= +-255
// (jsv.js:1465-1480) and the intra-DC level is clamped to +-256 here,
// which is output-invariant because dequantisation computes 8*dc and
// clamps to [-2048, 2047] (shader COL_INT_3 semantics) — every |dc| >=
// 256 saturates to the same value.  Per-block entry counts (uint8,
// <= 64) in (mb_raster * 4 + block) order for Y/alpha and mb_raster
// order for chroma give each entry its block identity on device.
struct CompactEmit {
  std::vector<uint16_t> vec[4];
  uint8_t* counts[4] = {nullptr, nullptr, nullptr, nullptr};
  const Parser* p = nullptr;
  const PictureCtx* c;
  int64_t first_blk[4] = {-1, -1, -1, -1};
  int64_t last_blk[4] = {-1, -1, -1, -1};
  bool dirty = false;          // duplicate emission (overlapping slices)
  // per-block state
  int comp = 0;
  int64_t blk = 0;
  size_t base = 0;

  inline void hint(int64_t span_bytes) {
    // entries average well under 8 bits each in dense content; one
    // up-front reserve per slice kills push_back realloc churn in the
    // per-coefficient hot loop (Y gets most of the coefficients)
    vec[0].reserve((size_t)span_bytes + (size_t)span_bytes / 2);
    for (int k = 1; k < 4; ++k)
      if (counts[k]) vec[k].reserve((size_t)span_bytes / 2);
  }

  inline void begin(int comp_, int by, int bx) {
    comp = comp_;
    if (comp == 0 || comp == 3) {
      int row = by >> 1, col = bx >> 1;
      int b = ((by & 1) << 1) | (bx & 1);
      blk = ((int64_t)row * c->mb_w + col) * 4 + b;
    } else {
      blk = (int64_t)by * c->mb_w + bx;
    }
    base = vec[comp].size();
  }
  inline void dc(int32_t v) {
    if (v > 256) v = 256;
    else if (v < -256) v = -256;
    vec[comp].push_back((uint16_t)(v + 512));    // spatial pos 0
  }
  inline void coef(int n, int32_t level) {
    vec[comp].push_back(
        (uint16_t)(((uint32_t)p->zigzag[n] << 10) | (level + 512)));
  }
  inline void end(int n, bool, const SliceState&) {
    (void)n;
    size_t cnt = vec[comp].size() - base;
    if (counts[comp][blk]) dirty = true;
    counts[comp][blk] = (uint8_t)cnt;
    if (first_blk[comp] < 0) first_blk[comp] = blk;
    last_blk[comp] = blk;
  }
};

inline int32_t decode_motion_component(BitReader& r, const Parser& p,
                                       const PictureCtx& c, int32_t& prev,
                                       bool full_pel) {
  int r_size = c.f_code - 1;
  int F = 1 << r_size;
  int32_t code = r.vlc(p.motion);
  int32_t d;
  if (code != 0 && F != 1) {
    int32_t residual = int32_t(r.get(r_size));
    d = (((code < 0 ? -code : code) - 1) << r_size) + residual + 1;
    if (code < 0) d = -d;
  } else {
    d = code;
  }
  prev += d;
  if (prev > (F << 4) - 1) prev -= F << 5;
  else if (prev < -(F << 4)) prev += F << 5;
  return full_pel ? (prev << 1) : prev;
}

// Decode one 8x8 block into its plane position; mirrors
// jsvx/bitstream/parser.py::_parse_block (spec: jsv.js:1338-1525).
template <class Emit>
inline int parse_block(BitReader& r, const Parser& p, const PictureCtx& c,
                       Emit& em, SliceState& s, int row, int col,
                       int block, bool intra) {
  // Resolve the destination block up front; coefficients go straight to
  // their final representation — no staging buffer, no 64-value copy.
  int comp, by, bx;
  if (block < 4 || block >= 6) {
    comp = (block < 4) ? 0 : 3;
    int b = (block < 4) ? block : block - 6;
    by = row * 2 + ((b & 2) ? 1 : 0);
    bx = col * 2 + ((b & 1) ? 1 : 0);
  } else {
    comp = (block == 4) ? 1 : 2;
    by = row;
    bx = col;
  }
  em.begin(comp, by, bx);

  int n = 0;
  if (intra) {
    int32_t predictor, size;
    if (block < 4) {
      predictor = s.dc_y;
      size = r.vlc(p.dc_lum);
    } else if (block >= 6) {       // alpha: own predictor, luminance table
      predictor = s.dc_a;
      size = r.vlc(p.dc_lum);
    } else {
      predictor = (block == 4) ? s.dc_cb : s.dc_cr;
      size = r.vlc(p.dc_chrom);
    }
    int32_t dc;
    if (size > 0) {
      int32_t diff = int32_t(r.get(size));
      if (diff & (1 << (size - 1))) dc = predictor + diff;
      else dc = predictor + ((-1 << size) | (diff + 1));
    } else {
      dc = predictor;
    }
    em.dc(dc);
    if (block < 4) s.dc_y = dc;
    else if (block >= 6) s.dc_a = dc;
    else if (block == 4) s.dc_cb = dc;
    else s.dc_cr = dc;
    n = 1;
  }

  // First coefficient of a non-intra block (n == 0): the '1' code is
  // 1 bit + sign with NO end-of-block/marker ambiguity (jsv.js:1405),
  // so it cannot use the sign-folded table below.  Generic decode:
  if (!intra) {
    int32_t code = r.vlc(p.coeff);
    if (r.bad) return kErrStall;
    int32_t level;
    if (code == 0xFFFF) {        // escape
      int32_t run = int32_t(r.get(6));
      level = int32_t(r.get(8));
      if (level == 0) level = int32_t(r.get(8));
      else if (level == 128) level = int32_t(r.get(8)) - 256;
      else if (level > 128) level -= 256;
      n = run;
    } else {
      level = code & 0xFF;
      if (r.get(1)) level = -level;
      n = code >> 8;
    }
    if (r.bad) return kErrStall;
    if (n <= 63) em.coef(n, level);
    ++n;
  }

  // Coefficient loop — THE hot loop of the decoder (the analog of
  // jsv.js:1400-1443).  One sign-folded table hit per coefficient:
  // signed level, run, and total bit length come from a single 8 KB
  // L1-resident lookup; only escapes and end-of-block branch out.
  const CoeffTab& ct = p.coeff2;
  for (;;) {
    uint64_t w = r.window();
    uint32_t e = ct.prim[uint32_t(w >> (64 - CoeffTab::B1))];
    if ((e & 0xC000u) == 0xC000u) {        // extended: long codes
      uint32_t rest = uint32_t(w >> (64 - (ct.bits + 1)))
                      & ((1u << (ct.bits + 1 - CoeffTab::B1)) - 1);
      e = ct.sub[(e >> 16) + rest];
    }
    uint32_t len = e & 0xFF;
    uint32_t flag = (e >> 14) & 3;
    r.pos += len;
    if (r.pos > r.n_bits) return kErrStall;
    if (flag) {
      if (flag == 1) break;                // end_of_block ('10')
      if (len == 0) {
        if (r.pos >= r.n_bits) return kErrStall;
        return kErrBadCode;
      }
      // escape: 6-bit run + 8/16-bit level from the same window
      uint32_t run = uint32_t(w >> (58 - len)) & 63;
      uint32_t lv8 = uint32_t(w >> (50 - len)) & 255;
      int32_t level;
      int consumed = 14;
      if (lv8 == 0) {
        level = int32_t(uint32_t(w >> (42 - len)) & 255);
        consumed += 8;
      } else if (lv8 == 128) {
        level = int32_t(uint32_t(w >> (42 - len)) & 255) - 256;
        consumed += 8;
      } else if (lv8 > 128) {
        level = int32_t(lv8) - 256;
      } else {
        level = int32_t(lv8);
      }
      r.pos += consumed;
      if (r.pos > r.n_bits) return kErrStall;
      n += (int)run;
      if (n > 63) break;                   // corrupt stream guard
      em.coef(n, level);
      ++n;
      continue;
    }
    if (len == 0) {
      if (r.pos >= r.n_bits) return kErrStall;
      return kErrBadCode;
    }
    n += (e >> 8) & 63;                    // run
    if (n > 63) break;                     // corrupt stream guard
    em.coef(n, (int32_t)(int16_t)(e >> 16));
    ++n;
  }

  em.end(n, intra, s);
  return 0;
}

// Mirrors jsvx/bitstream/parser.py::_parse_macroblock (jsv.js:725-828).
template <class Emit>
inline int parse_macroblock(BitReader& r, const Parser& p,
                            const PictureCtx& c, PictureOut& o,
                            Emit& em, SliceState& s, int32_t& mb_address,
                            bool slice_begin) {
  const int32_t mb_size = c.mb_w * c.mb_h;
  int32_t increment = 0;
  int32_t t = r.vlc(p.addr);
  if (r.bad) return kErrStall;
  while (t == 34) { t = r.vlc(p.addr); if (r.bad) return kErrStall; }
  while (t == 35) { increment += 33; t = r.vlc(p.addr);
                    if (r.bad) return kErrStall; }
  increment += t;

  if (slice_begin) {
    mb_address += increment;
  } else {
    if (mb_address + increment >= mb_size) {
      mb_address = mb_size;              // illegal increment: drop
      return 0;
    }
    if (increment > 1) {
      s.reset_dc();
      if (c.picture_type == 2) s.reset_mv();
    }
    while (increment > 1) {
      ++mb_address;
      int row = mb_address / c.mb_w, col = mb_address % c.mb_w;
      o.mb_mv[((int64_t)row * c.mb_w + col) * 2 + 0] = (int16_t)s.motion_v;
      o.mb_mv[((int64_t)row * c.mb_w + col) * 2 + 1] = (int16_t)s.motion_h;
      o.mb_quant[(int64_t)row * c.mb_w + col] =
          (uint8_t)s.quantizer_scale;
      --increment;
    }
    ++mb_address;
  }
  if (mb_address >= mb_size) return kErrOverrun;
  int row = mb_address / c.mb_w, col = mb_address % c.mb_w;

  int32_t mb_type = r.vlc(c.picture_type == 1 ? p.type_i : p.type_p);
  if (r.bad) return kErrBadCode;
  bool intra = mb_type & 0x01;
  bool motion_fw = mb_type & 0x08;
  if (mb_type & 0x10) s.quantizer_scale = int32_t(r.get(5));

  o.mb_quant[(int64_t)row * c.mb_w + col] = (uint8_t)s.quantizer_scale;
  o.mb_intra[(int64_t)row * c.mb_w + col] = intra ? 1 : 0;

  if (intra) {
    s.reset_mv();
    if (c.picture_type == 2)
      o.mb_rep_add[(int64_t)row * c.mb_w + col] = 1;
  } else {
    s.reset_dc();
    if (motion_fw) {
      s.motion_h = decode_motion_component(r, p, c, s.motion_h_prev,
                                           c.full_pel);
      s.motion_v = decode_motion_component(r, p, c, s.motion_v_prev,
                                           c.full_pel);
    } else if (c.picture_type == 2) {
      s.reset_mv();
    }
    o.mb_mv[((int64_t)row * c.mb_w + col) * 2 + 0] = (int16_t)s.motion_v;
    o.mb_mv[((int64_t)row * c.mb_w + col) * 2 + 1] = (int16_t)s.motion_h;
  }

  int32_t cbp = 0, acbp = 0;
  if (mb_type & 0x02) {
    cbp = r.vlc(p.cbp);
    if (r.bad) return kErrBadCode;
    if (c.yuva) acbp = int32_t(r.get(4));
  } else if (intra) {
    cbp = 0x3F;
    if (c.yuva) acbp = 0xF;
  }

  for (int block = 0; block < 6; ++block) {
    if (cbp & (0x20 >> block)) {
      int rc = parse_block(r, p, c, em, s, row, col, block, intra);
      if (rc < 0) return rc;
    }
  }
  for (int ab = 0; ab < 4; ++ab) {       // alpha blocks 6..9 (YUVA)
    if (acbp & (0x8 >> ab)) {
      int rc = parse_block(r, p, c, em, s, row, col, 6 + ab, intra);
      if (rc < 0) return rc;
    }
  }
  return 0;
}

// Find the next 00 00 01 start code at/after byte `from`; returns the
// offset of the 00 00 01 prefix or -1.
inline int64_t find_start(const uint8_t* d, int64_t n, int64_t from) {
  for (int64_t i = from; i + 3 < n; ++i) {
    if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) return i;
    // skip ahead over nonzero bytes quickly
    if (d[i + 2] > 1) i += 2;
    else if (d[i + 1] != 0) i += 1;
  }
  return -1;
}

struct Span { int64_t begin; int64_t end; int code; };

// Collect the picture's slice spans (slices are independently parseable:
// own start code, own quantiser, per-slice predictor resets —
// jsv.js:683-706).  Returns the byte offset of the first non-slice start
// code (picture end) in `picture_end`.
inline std::vector<Span> collect_spans(const uint8_t* data, int64_t n_bytes,
                                       int64_t start_bit,
                                       int64_t& picture_end) {
  std::vector<Span> spans;
  int64_t cursor = (start_bit + 7) >> 3;
  picture_end = n_bytes;
  for (;;) {
    int64_t off = find_start(data, n_bytes, cursor);
    if (off < 0) break;                      // end of stream = picture end
    int code = data[off + 3];
    if (code >= 0x01 && code <= 0xAF) {
      if (!spans.empty() && spans.back().end > off)
        spans.back().end = off;
      spans.push_back({off + 4, n_bytes, code});
      cursor = off + 4;
    } else if (code == 0xB5 || code == 0xB2) {
      if (!spans.empty() && spans.back().end > off)
        spans.back().end = off;
      cursor = off + 4;                      // extension / user data
    } else {
      if (!spans.empty() && spans.back().end > off)
        spans.back().end = off;
      picture_end = off;
      break;
    }
  }
  return spans;
}

template <class Emit>
inline int parse_slice(const uint8_t* data, int64_t n_bytes, const Span& sp,
                       const Parser& p, const PictureCtx& c, PictureOut& o,
                       Emit& em) {
  BitReader r(data, n_bytes);
  r.pos = sp.begin * 8;
  em.hint(sp.end - sp.begin);
  SliceState s;
  int32_t mb_address = (sp.code - 1) * c.mb_w - 1;
  s.quantizer_scale = int32_t(r.get(5));
  while (r.get(1)) r.skip(8);                // extra slice information

  bool slice_begin = true;
  while (((r.pos + 7) >> 3) < sp.end) {
    int rc = parse_macroblock(r, p, c, o, em, s, mb_address, slice_begin);
    slice_begin = false;
    if (rc == kErrOverrun) break;
    if (rc < 0) return rc;
    if (r.bad) return kErrStall;
    if (mb_address >= c.mb_w * c.mb_h) break;
  }
  return 0;
}

// Fan the slices of one picture out over `emits` (one Emit per slice;
// slices write disjoint plane rows / MB-grid rows, so they need no
// synchronisation beyond the error word).
template <class Emit>
inline int run_slices(const uint8_t* data, int64_t n_bytes,
                      const std::vector<Span>& spans, const Parser& p,
                      const PictureCtx& c, PictureOut& o,
                      std::vector<Emit>& emits, int32_t n_threads) {
  if (n_threads > 1 && spans.size() > 1) {
    int nt = n_threads < (int32_t)spans.size() ? n_threads
                                               : (int32_t)spans.size();
    std::atomic<int> rc_word{0};
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= spans.size() || rc_word.load(std::memory_order_relaxed))
          return;
        int rc = parse_slice(data, n_bytes, spans[i], p, c, o, emits[i]);
        if (rc < 0) rc_word.store(rc);
      }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    if (int rc = rc_word.load()) return rc;
  } else {
    for (size_t i = 0; i < spans.size(); ++i) {
      int rc = parse_slice(data, n_bytes, spans[i], p, c, o, emits[i]);
      if (rc < 0) return rc;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void* jsv_parser_new(
    const int32_t* addr_v, const uint8_t* addr_l, int addr_b,
    const int32_t* ti_v, const uint8_t* ti_l, int ti_b,
    const int32_t* tp_v, const uint8_t* tp_l, int tp_b,
    const int32_t* cbp_v, const uint8_t* cbp_l, int cbp_b,
    const int32_t* mot_v, const uint8_t* mot_l, int mot_b,
    const int32_t* dcl_v, const uint8_t* dcl_l, int dcl_b,
    const int32_t* dcc_v, const uint8_t* dcc_l, int dcc_b,
    const int32_t* coef_v, const uint8_t* coef_l, int coef_b,
    const uint8_t* zigzag) {
  Parser* p = new Parser();
  p->addr.set(addr_v, addr_l, addr_b);
  p->type_i.set(ti_v, ti_l, ti_b);
  p->type_p.set(tp_v, tp_l, tp_b);
  p->cbp.set(cbp_v, cbp_l, cbp_b);
  p->motion.set(mot_v, mot_l, mot_b);
  p->dc_lum.set(dcl_v, dcl_l, dcl_b);
  p->dc_chrom.set(dcc_v, dcc_l, dcc_b);
  p->coeff.set(coef_v, coef_l, coef_b);
  p->coeff2.build(coef_v, coef_l, coef_b);
  std::memcpy(p->zigzag, zigzag, 64);
  for (int i = 0; i < 64; ++i) p->zigzag_inv[zigzag[i]] = (uint8_t)i;
  return p;
}

void jsv_parser_free(void* handle) { delete (Parser*)handle; }

// Parse all slices of one picture.  `start_byte` points at the first
// byte after the picture header's last bit (byte-aligned caller-side is
// not required: pass the bit offset).  Returns the byte offset of the
// first non-slice start code found (picture end) or a negative error.
int64_t jsv_parse_picture_slices(
    void* handle, const uint8_t* data, int64_t n_bytes, int64_t start_bit,
    int32_t mb_w, int32_t mb_h, int32_t picture_type, int32_t full_pel,
    int32_t f_code, int32_t yuva,
    int16_t* levels_y, int16_t* levels_cb, int16_t* levels_cr,
    int16_t* levels_a,
    uint8_t* lnz_y, uint8_t* lnz_cb, uint8_t* lnz_cr, uint8_t* lnz_a,
    uint8_t* mb_quant, uint8_t* mb_intra, int16_t* mb_mv,
    uint8_t* mb_rep_add,
    // optional (may all be null): per-pixel dequant sideband emission
    const uint8_t* intra_q, const uint8_t* non_intra_q,
    int16_t* mult_y, int16_t* mult_cb, int16_t* mult_cr, int16_t* mult_a,
    uint8_t* flags_y, uint8_t* flags_cb, uint8_t* flags_cr,
    uint8_t* flags_a,
    // slice-level fan-out (1 = serial; safe: slices write disjoint rows)
    int32_t n_threads) {
  Parser& p = *(Parser*)handle;
  PictureCtx c{mb_w, mb_h, mb_w * 16, picture_type, full_pel, f_code, yuva};
  PictureOut o;
  o.levels[0] = levels_y; o.levels[1] = levels_cb;
  o.levels[2] = levels_cr; o.levels[3] = levels_a;
  o.lnz[0] = lnz_y; o.lnz[1] = lnz_cb; o.lnz[2] = lnz_cr; o.lnz[3] = lnz_a;
  o.mb_quant = mb_quant; o.mb_intra = mb_intra;
  o.mb_mv = mb_mv; o.mb_rep_add = mb_rep_add;
  if (mult_y != nullptr && intra_q != nullptr) {
    o.mult[0] = mult_y; o.mult[1] = mult_cb; o.mult[2] = mult_cr;
    o.mult[3] = mult_a;
    o.flags[0] = flags_y; o.flags[1] = flags_cb; o.flags[2] = flags_cr;
    o.flags[3] = flags_a;
    o.intra_q = intra_q;
    o.non_intra_q = non_intra_q;
  }

  int64_t picture_end;
  std::vector<Span> spans = collect_spans(data, n_bytes, start_bit,
                                          picture_end);
  std::vector<DenseEmit> emits(spans.size());
  for (auto& em : emits) { em.o = &o; em.p = &p; em.c = &c; }
  int rc = run_slices(data, n_bytes, spans, p, c, o, emits, n_threads);
  if (rc < 0) return rc;
  return picture_end;
}

// Compact-wire variant: coded coefficients are emitted as one uint16
// per coefficient (see CompactEmit) instead of scattered into dense
// planes — the host->device transfer then scales with the *coded*
// content (like the bitstream itself, jsv.js:1206-1243 uploads dense
// textures; this beats it) and the dense planes are reconstituted on
// device by one scatter.  Outputs:
//   cpk_*   per-component packed entry buffers (caller-sized; the safe
//           capacity is n_blocks(comp) * 64 entries)
//   n_out   int64[4]: entries written per component
//   counts_* per-block entry counts, uint8, zeroed by the caller;
//           Y/alpha indexed (mb*4 + block), chroma indexed mb
//   dirty_out int32: 1 if a block was emitted twice or slices were
//           emitted out of MB order (overlapping/corrupt streams) —
//           the caller must re-parse densely; never set by valid
//           streams.
// Returns the picture-end byte offset or a negative error code.
int64_t jsv_parse_picture_slices_compact(
    void* handle, const uint8_t* data, int64_t n_bytes, int64_t start_bit,
    int32_t mb_w, int32_t mb_h, int32_t picture_type, int32_t full_pel,
    int32_t f_code, int32_t yuva,
    uint16_t* cpk_y, uint16_t* cpk_cb, uint16_t* cpk_cr, uint16_t* cpk_a,
    const int64_t* cpk_caps, int64_t* n_out,
    uint8_t* counts_y, uint8_t* counts_cb, uint8_t* counts_cr,
    uint8_t* counts_a,
    uint8_t* mb_quant, uint8_t* mb_intra, int16_t* mb_mv,
    uint8_t* mb_rep_add, int32_t* dirty_out, int32_t n_threads) {
  Parser& p = *(Parser*)handle;
  PictureCtx c{mb_w, mb_h, mb_w * 16, picture_type, full_pel, f_code, yuva};
  PictureOut o;
  o.mb_quant = mb_quant; o.mb_intra = mb_intra;
  o.mb_mv = mb_mv; o.mb_rep_add = mb_rep_add;

  int64_t picture_end;
  std::vector<Span> spans = collect_spans(data, n_bytes, start_bit,
                                          picture_end);
  std::vector<CompactEmit> emits(spans.size());
  uint8_t* counts[4] = {counts_y, counts_cb, counts_cr, counts_a};
  for (auto& em : emits) {
    em.p = &p;
    em.c = &c;
    for (int k = 0; k < 4; ++k) em.counts[k] = counts[k];
  }
  int rc = run_slices(data, n_bytes, spans, p, c, o, emits, n_threads);
  if (rc < 0) return rc;

  // Concatenate per-component entries in slice order; flag duplicate or
  // out-of-order block emission (the device expansion maps entry order
  // to cumulative per-block counts, which requires strictly increasing
  // block indices across the picture).
  uint16_t* cpk[4] = {cpk_y, cpk_cb, cpk_cr, cpk_a};
  int64_t n_written[4] = {0, 0, 0, 0};
  bool dirty = false;
  int64_t prev_last[4] = {-1, -1, -1, -1};
  for (auto& em : emits) {
    if (em.dirty) dirty = true;
    for (int k = 0; k < 4; ++k) {
      if (em.vec[k].empty()) continue;
      if (em.first_blk[k] <= prev_last[k]) dirty = true;
      prev_last[k] = em.last_blk[k];
      int64_t cnt = (int64_t)em.vec[k].size();
      if (n_written[k] + cnt > cpk_caps[k]) return kErrOverrun;
      std::memcpy(cpk[k] + n_written[k], em.vec[k].data(),
                  (size_t)cnt * 2);
      n_written[k] += cnt;
    }
  }
  for (int k = 0; k < 4; ++k) n_out[k] = n_written[k];
  *dirty_out = dirty ? 1 : 0;
  return picture_end;
}

}  // extern "C"
