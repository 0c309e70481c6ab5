// The serial entropy loops of the port's WebP decoder: host C++, built by
// g++ at first use (ops/_build.py `compile_host`) and called through
// ctypes from rustic_tpu_torch/utils/vp8.py and utils/webp.py.
//
// - vp8_macroblocks: a VP8 key frame's per-macroblock data after its
//   header: the segment, skip flag and intra modes of every macroblock
//   (the first partition, from where the Python header parse left its
//   boolean decoder) and the dequantised coefficient tokens (the token
//   partition), as libwebp 1.6.0's VP8ParseIntraModeRow and ParseResiduals
//   read them. Coefficients are stored as libwebp stores them, int16.
// - vp8l_pixels: the LZ77 / Huffman / colour-cache pixel loop of one VP8L
//   entropy-coded image (libwebp's DecodeImageData), its Huffman tables
//   built by the caller.
//
// - qoi_pixels: the op loop of a QOI image (INDEX, DIFF, LUMA, RUN, RGB,
//   RGBA), as Pillow 12.1.0's QoiImagePlugin.QoiDecoder runs it.
// - fli_frame, sun_rle, icns_rle and msp_rows: the run-length loops of
//   the legacy formats' decoders (utils/fli.py, sun.py, icns.py, msp.py),
//   as Pillow 12.1.0's FliDecode.c, SunRleDecode.c, IcnsImagePlugin
//   read_32 and MspImagePlugin.MspDecoder run them; im_bits: the n-bit
//   samples of an IM image (utils/im.py), as its BitDecode.c reads them.
// - jpeg_scan and jpeg_lossless_scan: the entropy decode of one JPEG scan
//   (utils/jpeg.py) as libjpeg-turbo 3.1.3 runs it under Pillow 12.1.0:
//   Huffman (jdhuff.c, jdphuff.c, jdlhuff.c) and arithmetic (jdarith.c)
//   coding, with libjpeg's recovery from corrupt data, fed 64 KiB at a
//   time as Pillow's ImageFile.load feeds it.
// - ccitt_rows: the rows of one TIFF strip or tile of CCITT modified
//   Huffman (compression 2), T.4 one- and two-dimensional (3) and T.6 (4)
//   data, as libtiff 4.7.1's tif_fax3.c decodes it under Pillow 12.1.0:
//   its 7-, 12- and 13-bit lookup tables built from the ITU-T T.4 code
//   lists (mkg3states' FillTable), its bit reader padding zeros while any
//   bit is left, its repair of a bad row (CLEANUP_RUNS, then the runs cut
//   at the row's end as _TIFFFax3fillruns cuts them, in place, so that
//   the repaired runs are the next row's reference).
// - bmp_rle: the run loop of Pillow's Python BmpRleDecoder (RLE8, RLE4).
//
// Everything else of the decoders (headers, tables, transforms,
// prediction, filtering, colour) stays in NumPy.

#include <cstdint>
#include <algorithm>
#include <cstring>
#include <memory>
#include <vector>

namespace {

// ---- VP8: the boolean decoder (RFC 6386 section 7, in libwebp's form) --------------------------

struct Bool {
  const uint8_t* data;
  int64_t size, pos;
  uint64_t value;  // the window; `bits` bits of it lie below the 8 that are compared
  int bits;
  int range;  // the true range, 128..255 between calls
  bool eof;   // a decision needed bits past the end (libwebp's eof_)

  int bit(int prob) {
    if (bits < 0) {
      uint64_t chunk = 0;
      for (int i = 0; i < 7; ++i) {
        chunk = (chunk << 8) | (pos < size ? data[pos] : 0);
        ++pos;
      }
      value = (value << 56) | chunk;
      bits += 56;
    }
    if (8 * pos - bits > 8 * size) eof = true;  // the bits consumed so far, past the end
    const int split = ((range - 1) * prob) >> 8;  // one less than the RFC's split
    int out, r;
    if (static_cast<int>(value >> bits) > split) {
      r = range - split - 1;
      value -= static_cast<uint64_t>(split + 1) << bits;
      out = 1;
    } else {
      r = split + 1;
      out = 0;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    range = r << shift;
    bits -= shift;
    return out;
  }
};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's kYModesIntra4, its 4x4 modes numbered DC TM VE HE RD VR LD VL HD HU
const int kBModeTree[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { DC = 0, TM = 1, VE = 2, HE = 3 };

int large_value(Bool& br, const uint8_t* p) {
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// probs: [4 types][8 bands][3 contexts][11]; the tokens of one block from position n
int coeffs(Bool& br, const uint8_t* probs, int type, int ctx, int dq0, int dq1, int n,
           int16_t* out) {
  const uint8_t* base = probs + type * 8 * 3 * 11;
  const uint8_t* p = base + (kBands[n] * 3 + ctx) * 11;
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;  // end of block
    while (!br.bit(p[1])) {  // a zero
      ++n;
      if (n == 16) return 16;
      p = base + (kBands[n] * 3 + 0) * 11;
    }
    const uint8_t* next = base + kBands[n + 1] * 3 * 11;
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next + 11;
    } else {
      v = large_value(br, p);
      p = next + 22;
    }
    const int sign = br.bit(128);
    out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * (n > 0 ? dq1 : dq0));
  }
  return 16;
}

// ---- VP8L: the pixel loop ----------------------------------------------------------------------

struct Bits {
  const uint8_t* data;  // padded with 32 zero bytes
  int64_t pos;          // in bits
  uint32_t peek(int n) const {
    uint64_t w;
    std::memcpy(&w, data + (pos >> 3), 8);  // little-endian host
    return static_cast<uint32_t>((w >> (pos & 7)) & ((1ull << n) - 1));
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos += n;
    return v;
  }
};

// one table: `bits` index bits, entries length << 16 | symbol
inline int symbol(Bits& br, const int32_t* table, int bits) {
  const int32_t e = table[bits ? br.peek(bits) : 0];
  br.pos += e >> 16;
  return e & 0xFFFF;
}

inline int prefix_value(Bits& br, int sym) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

}  // namespace

extern "C" {

// The macroblock loop of a VP8 key frame. part0 from byte `pos` with the
// boolean decoder's state (value, bits, range) where the header parse
// stopped; tokens: the token partitions, partition p at bytes
// [part_start[p], part_start[p + 1]), macroblock row y reading partition
// y % n_parts (n_parts 1, 2, 4 or 8). seg_probs[3], probs[4*8*3*11],
// quant[4 segments * 6] (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac),
// bmode_probs[10*10*9]. Outputs per macroblock k (raster order): segment,
// skip, is_i4, ymode, uvmode, bmodes[16 k..], coef[384 k..] (24 blocks of
// 16 in raster order), y2[16 k..]. Returns 0, or -1 if a partition ended early.
int vp8_macroblocks(const uint8_t* part0, int64_t size0, int64_t pos, uint64_t value, int bits,
                    int range, const uint8_t* tokens, const int64_t* part_start, int n_parts,
                    int mbw, int mbh,
                    int update_map, const uint8_t* seg_probs, int use_skip, int skip_prob,
                    const uint8_t* probs, const int32_t* quant, const uint8_t* bmode_probs,
                    int32_t* segment, int32_t* skip, int32_t* is_i4, int32_t* ymode,
                    int32_t* uvmode, int32_t* bmodes, int16_t* coef, int16_t* y2) {
  Bool br{part0, size0, pos, value, bits, range, false};
  std::vector<Bool> parts;
  for (int p = 0; p < n_parts; ++p)
    parts.push_back(Bool{tokens + part_start[p], part_start[p + 1] - part_start[p], 0, 0, -8, 255,
                         false});
  std::vector<uint8_t> intra_t(4 * mbw, DC), top_nz(mbw, 0), top_dc(mbw, 0);
  for (int my = 0; my < mbh; ++my) {
    Bool& tk = parts[my & (n_parts - 1)];
    uint8_t intra_l[4] = {DC, DC, DC, DC};
    uint8_t left_nz = 0, left_dc = 0;
    for (int mx = 0; mx < mbw; ++mx) {
      const int64_t k = static_cast<int64_t>(my) * mbw + mx;
      // the macroblock header (libwebp's ParseIntraMode)
      int seg = 0;
      if (update_map)
        seg = !br.bit(seg_probs[0]) ? br.bit(seg_probs[1]) : br.bit(seg_probs[2]) + 2;
      segment[k] = seg;
      skip[k] = use_skip ? br.bit(skip_prob) : 0;
      is_i4[k] = !br.bit(145);
      if (!is_i4[k]) {
        const int mode = br.bit(156) ? (br.bit(128) ? TM : HE) : (br.bit(163) ? VE : DC);
        ymode[k] = mode;
        std::memset(&intra_t[4 * mx], mode, 4);
        std::memset(intra_l, mode, 4);
      } else {
        for (int by = 0; by < 4; ++by) {
          int left = intra_l[by];
          for (int bx = 0; bx < 4; ++bx) {
            const uint8_t* prob = bmode_probs + (intra_t[4 * mx + bx] * 10 + left) * 9;
            int i = kBModeTree[br.bit(prob[0])];
            while (i > 0) i = kBModeTree[2 * i + br.bit(prob[i])];
            left = -i;
            intra_t[4 * mx + bx] = static_cast<uint8_t>(left);
            bmodes[16 * k + 4 * by + bx] = left;
          }
          intra_l[by] = static_cast<uint8_t>(left);
        }
      }
      uvmode[k] = !br.bit(142) ? DC : !br.bit(114) ? VE : br.bit(183) ? TM : HE;
      // its residuals (libwebp's ParseResiduals)
      if (skip[k]) {
        top_nz[mx] = left_nz = 0;
        if (!is_i4[k]) top_dc[mx] = left_dc = 0;
        continue;
      }
      const int32_t* q = quant + 6 * seg;
      int16_t* dst = coef + 384 * k;
      int first, ac_type;
      if (!is_i4[k]) {
        const int nz = coeffs(tk, probs, 1, top_dc[mx] + left_dc, q[2], q[3], 0, y2 + 16 * k);
        top_dc[mx] = left_dc = nz > 0;
        first = 1;
        ac_type = 0;
      } else {
        first = 0;
        ac_type = 3;
      }
      uint8_t tnz = top_nz[mx] & 0x0F;
      uint8_t lnz = left_nz & 0x0F;
      for (int by = 0; by < 4; ++by) {
        int l = lnz & 1;
        for (int bx = 0; bx < 4; ++bx) {
          const int nz = coeffs(tk, probs, ac_type, l + (tnz & 1), q[0], q[1], first,
                                dst + 16 * (4 * by + bx));
          l = nz > first;
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        }
        tnz >>= 4;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      }
      uint8_t out_t = tnz, out_l = lnz >> 4;
      for (int ch = 0; ch < 4; ch += 2) {
        tnz = top_nz[mx] >> (4 + ch);
        lnz = left_nz >> (4 + ch);
        for (int by = 0; by < 2; ++by) {
          int l = lnz & 1;
          for (int bx = 0; bx < 2; ++bx) {
            const int nz = coeffs(tk, probs, 2, l + (tnz & 1), q[4], q[5], 0,
                                  dst + 16 * (16 + 2 * ch + 2 * by + bx));
            l = nz > 0;
            tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          }
          tnz >>= 2;
          lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
        }
        out_t |= static_cast<uint8_t>((tnz << 4) << ch);
        out_l |= static_cast<uint8_t>((lnz & 0xF0) << ch);
      }
      top_nz[mx] = out_t;
      left_nz = out_l;
    }
  }
  bool eof = br.eof;
  for (const Bool& p : parts) eof = eof || p.eof;
  return eof ? -1 : 0;
}

// The pixels of one VP8L entropy-coded image. data: the stream of `size`
// bytes, padded with 32 zero bytes; pos: its bit position. Huffman groups: for group g and code c
// (green + length + cache, red, blue, alpha, distance) its index bits
// code_bits[5 g + c] and its table at tables + code_offsets[5 g + c]. meta:
// the entropy image's group of each block of 2^meta_bits pixels (meta_w
// blocks a row), or null. Writes width * height ARGB pixels; returns the
// bit position after them, or -1 for a back-reference outside the image,
// -2 for a cache code without a cache, -3 where the stream ends first.
int64_t vp8l_pixels(const uint8_t* data, int64_t size, int64_t pos, int width, int height,
                    const int32_t* code_bits, const int64_t* code_offsets, const int32_t* tables,
                    const int32_t* meta, int meta_bits, int meta_w, int cache_bits,
                    uint32_t* out) {
  Bits br{data, pos};
  const int64_t total = static_cast<int64_t>(width) * height;
  std::vector<uint32_t> cache(cache_bits ? (1u << cache_bits) : 0, 0);
  int64_t n = 0, cached = 0;
  int x = 0, y = 0;
  while (n < total) {
    if (br.pos > 8 * size) return -3;  // a pixel reads at most 10 bytes: within the padding
    const int g = meta ? meta[(y >> meta_bits) * meta_w + (x >> meta_bits)] : 0;
    const int32_t* cb = code_bits + 5 * g;
    const int64_t* co = code_offsets + 5 * g;
    const int code = symbol(br, tables + co[0], cb[0]);
    if (code < 256) {
      const uint32_t red = symbol(br, tables + co[1], cb[1]);
      const uint32_t blue = symbol(br, tables + co[2], cb[2]);
      const uint32_t alpha = symbol(br, tables + co[3], cb[3]);
      out[n++] = alpha << 24 | red << 16 | static_cast<uint32_t>(code) << 8 | blue;
      if (++x == width) {
        x = 0;
        ++y;
      }
    } else if (code < 280) {
      const int length = prefix_value(br, code - 256);
      const int dist_sym = symbol(br, tables + co[4], cb[4]);
      int dist = prefix_value(br, dist_sym);
      if (dist > 120) {
        dist -= 120;
      } else {
        dist = kPlane[dist - 1][0] + kPlane[dist - 1][1] * width;
        if (dist < 1) dist = 1;
      }
      if (dist > n || n + length > total) return -1;
      for (int i = 0; i < length; ++i, ++n) out[n] = out[n - dist];
      x += length;
      while (x >= width) {
        x -= width;
        ++y;
      }
    } else {
      if (cache.empty()) return -2;
      for (; cached < n; ++cached)
        cache[(out[cached] * 0x1E35A7BDu) >> (32 - cache_bits)] = out[cached];
      out[n++] = cache[code - 280];
      if (++x == width) {
        x = 0;
        ++y;
      }
    }
  }
  return br.pos;
}

// The pixels of a QOI image from `pos`: `n_pixels` pixels of `bands` (3
// or 4) bytes into `out`, as Pillow's QoiDecoder reads them. The previous
// pixel starts as (0, 0, 0, 255); the table of 64 seen pixels starts
// empty, an INDEX of an empty slot reads (0, 0, 0, 0), and a RUN repeats
// the previous pixel without touching the table (so the starting pixel is
// never in it); a RUN that overshoots the image is cut. Returns the
// position after the last op read, or -1 where the ops run past the end.
int64_t qoi_pixels(const uint8_t* data, int64_t size, int64_t pos, int64_t n_pixels, int bands,
                   uint8_t* out) {
  uint8_t seen[64][4];
  bool have[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t done = 0;
  while (done < n_pixels) {
    if (pos >= size) return -1;
    const int op = data[pos++];
    uint8_t px[4];
    if (op == 0xFE || op == 0xFF) {  // RGB, RGBA
      const int n = op == 0xFE ? 3 : 4;
      if (pos + n > size) return -1;
      for (int c = 0; c < 4; ++c) px[c] = c < n ? data[pos + c] : prev[3];
      pos += n;
    } else if (op >> 6 == 0) {  // INDEX
      const int i = op & 63;
      for (int c = 0; c < 4; ++c) px[c] = have[i] ? seen[i][c] : 0;
    } else if (op >> 6 == 1) {  // DIFF
      px[0] = uint8_t(prev[0] + ((op >> 4) & 3) - 2);
      px[1] = uint8_t(prev[1] + ((op >> 2) & 3) - 2);
      px[2] = uint8_t(prev[2] + (op & 3) - 2);
      px[3] = prev[3];
    } else if (op >> 6 == 2) {  // LUMA
      if (pos >= size) return -1;
      const int second = data[pos++];
      const int dg = (op & 63) - 32;
      px[0] = uint8_t(prev[0] + dg + (second >> 4) - 8);
      px[1] = uint8_t(prev[1] + dg);
      px[2] = uint8_t(prev[2] + dg + (second & 15) - 8);
      px[3] = prev[3];
    } else {  // RUN
      for (int64_t k = (op & 63) + 1; k > 0 && done < n_pixels; --k, ++done)
        std::memcpy(out + done * bands, prev, bands);
      continue;
    }
    std::memcpy(prev, px, 4);
    const int h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
    std::memcpy(seen[h], px, 4);
    have[h] = true;
    std::memcpy(out + done * bands, px, bands);
    ++done;
  }
  return pos;
}

// One FLI/FLC frame (`bytes` bytes from its size field) onto the 8-bit
// image `im` (xsize x ysize, row-major), as FliDecode.c: COLOR (4, 11) and
// PSTAMP (18) chunks are skipped, SS2 (7) word deltas, LC (12) byte
// deltas, BLACK (13), BRUN (15) byte runs and COPY (16) are drawn. Returns
// 0 at the frame's end; 1 where the buffer holds less than the frame (the
// file is truncated); 2 where a chunk overruns its data or the image
// (IMAGING_CODEC_OVERRUN); 3 for a chunk that is not a frame or of an
// unknown type (IMAGING_CODEC_UNKNOWN); 4 for a chunk of size 0
// (IMAGING_CODEC_BROKEN).
int fli_frame(const uint8_t* buf, int64_t bytes, int xsize, int ysize, uint8_t* im) {
  auto i16 = [](const uint8_t* p) { return int(p[0]) | int(p[1]) << 8; };
  auto i32 = [](const uint8_t* p) {
    return int32_t(uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                   uint32_t(p[3]) << 24);
  };
  if (bytes < 4) return 1;
  const uint8_t* ptr = buf;
  const int64_t framesize = i32(ptr);
  if (bytes + (bytes % 2) < framesize) return 1;
  if (bytes < 8) return 2;
  if (i16(ptr + 4) != 0xF1FA) return 3;
  const int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
#define OOB(offset) \
  if ((data + (offset)) > ptr + bytes) return 2;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return 2;
    const uint8_t* data = ptr + 6;
    int x, y, i;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = i16(data);
        data += 2;
        int l;
        for (l = y = 0; l < lines && y < ysize; ++l, ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          OOB(2)
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return 2;
              row = im + int64_t(y) * xsize;
            } else {
              row[xsize - 1] = uint8_t(packets);
            }
            OOB(2)
            packets = i16(data);
            data += 2;
          }
          int p;
          for (p = x = 0; p < packets; ++p) {
            OOB(2)
            x += data[0];
            if (data[1] >= 128) {
              OOB(4)
              i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int j = 0; j < i; ++j) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * int(data[1]);
              if (x + i > xsize) break;
              OOB(2 + i)
              std::memcpy(row + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return 2;
        break;
      }
      case 12: {  // LC
        y = i16(data);
        const int ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          OOB(1)
          const int packets = *data++;
          int p;
          for (p = x = 0; p < packets; ++p, x += i) {
            OOB(2)
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              OOB(3)
              std::memset(row + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              OOB(2 + i)
              std::memcpy(row + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return 2;
        break;
      }
      case 13:  // BLACK
        std::memset(im, 0, int64_t(xsize) * ysize);
        break;
      case 15:  // BRUN
        for (y = 0; y < ysize; ++y) {
          uint8_t* row = im + int64_t(y) * xsize;
          data += 1;  // the packet count, ignored
          for (x = 0; x < xsize; x += i) {
            OOB(2)
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              OOB(i + 1)
              std::memcpy(row + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(row + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) return 2;
        }
        break;
      case 16:  // COPY
        if (data + int64_t(xsize) * ysize > ptr + bytes) return 1;
        std::memcpy(im, data, int64_t(xsize) * ysize);
        break;
      default:
        return 3;
    }
    const int64_t advance = i32(ptr);
    if (advance == 0) return 4;
    if (advance < 0 || advance > bytes) return 2;
    ptr += advance;
    bytes -= advance;
  }
#undef OOB
  return 0;
}

// Sun raster RLE (SunRleDecode.c) into `rows` lines of `line` bytes: 0x80
// 0x00 is a literal 0x80, 0x80 n v a run of n + 1 bytes v (which carries
// on into the next lines), any other byte itself. Returns 0, or -1 where
// the data ends first.
int sun_rle(const uint8_t* data, int64_t size, int64_t line, int64_t rows, uint8_t* out) {
  const int64_t total = line * rows;
  int64_t pos = 0, done = 0;
  while (done < total) {
    if (pos >= size) return -1;
    if (data[pos] == 0x80) {
      if (pos + 2 > size) return -1;
      if (data[pos + 1] == 0) {
        out[done++] = 0x80;
        pos += 2;
      } else {
        if (pos + 3 > size) return -1;
        const int64_t n = std::min<int64_t>(int64_t(data[pos + 1]) + 1, total - done);
        std::memset(out + done, data[pos + 2], n);
        done += n;
        pos += 3;
      }
    } else {
      out[done++] = data[pos++];
    }
  }
  return 0;
}

// The three run-length channels of an ICNS 32-bit icon (read_32): from
// `pos`, each channel's `n` bytes as runs (a byte b >= 0x80: b - 125
// copies of the next byte; else b + 1 literal bytes), written to out[c * n
// ...]. Pillow joins what it read, so a run or literal cut by the file's
// end is short: `got[c]` counts the bytes a channel received. Returns the
// position after the last channel, or -1 where a channel's counts do not
// add up to n (Pillow's "Error reading channel").
int64_t icns_rle(const uint8_t* data, int64_t size, int64_t pos, int64_t n, uint8_t* out,
                 int64_t* got) {
  for (int c = 0; c < 3; ++c) {
    int64_t left = n, k = 0;
    uint8_t* o = out + c * n;
    while (left > 0) {
      if (pos >= size) break;
      const int b = data[pos++];
      int64_t count;
      if (b & 0x80) {
        count = b - 125;
        if (pos < size) {
          const int64_t m = std::min(count, n - k);
          std::memset(o + k, data[pos], std::max<int64_t>(m, 0));
          k += count;
          ++pos;
        }
      } else {
        count = b + 1;
        const int64_t avail = std::min(count, size - pos);
        const int64_t m = std::min(avail, n - k);
        if (m > 0) std::memcpy(o + k, data + pos, m);
        k += avail;
        pos += avail;
      }
      left -= count;
      if (left <= 0) break;
    }
    if (left != 0) return -1;
    got[c] = k;
  }
  return pos;
}

// The RLE rows of an MSP version 2 image (MspDecoder): for each of `rows`
// rows, `rowlen[y]` bytes from `pos` (0: a blank row of `stride` 0xFF
// bytes), each a run (0, count, value) or a literal (count, then count
// bytes). Rows are joined as they come, whatever their length; the first
// `cap` bytes are written to `out`. Returns the bytes the rows made, -1
// where a row is cut short by the file's end, -2 where a run lacks its
// count or value (Pillow's "Corrupted MSP file").
int64_t msp_rows(const uint8_t* data, int64_t size, int64_t pos, const uint16_t* rowlen,
                 int64_t rows, int64_t stride, uint8_t* out, int64_t cap) {
  int64_t made = 0;
  auto put = [&](const uint8_t* src, int64_t n, int fill) {
    const int64_t m = std::min(n, cap - made);
    if (m > 0) {
      if (src)
        std::memcpy(out + made, src, m);
      else
        std::memset(out + made, fill, m);
    }
    made += n;
  };
  for (int64_t y = 0; y < rows; ++y) {
    const int64_t len = rowlen[y];
    if (len == 0) {
      put(nullptr, stride, 0xFF);
      continue;
    }
    if (pos + len > size) return -1;
    const uint8_t* row = data + pos;
    pos += len;
    int64_t idx = 0;
    while (idx < len) {
      const int type = row[idx++];
      if (type == 0) {
        if (idx + 2 > len) return -2;
        put(nullptr, row[idx], row[idx + 1]);
        idx += 2;
      } else {
        put(row + idx, std::min<int64_t>(type, len - idx), 0);
        idx += type;
      }
    }
  }
  return made;
}

// The n-bit samples (1 <= bits < 32) of an IM "L*n" image, as Pillow's
// BitDecode.c reads them with the plugin's arguments (pad 8, fill 3, no
// sign, bottom-up): bytes enter a 64-bit buffer above the bits it holds,
// samples leave from its low end; at each row's end the count of held
// bits is reset but the buffer is not, so its leftover bits are OR-ed
// into the next row's first byte (the decoder's own quirk). `out` is the
// float32 image, row-major; rows are filled from the bottom. Returns 0, or
// -1 where the data ends first.
int im_bits(const uint8_t* data, int64_t size, int bits, int xsize, int ysize, float* out) {
  const unsigned long mask = (1ul << bits) - 1;
  unsigned long buffer = 0;
  int count = 0, x = 0, y = ysize - 1;
  for (int64_t pos = 0; pos < size; ++pos) {
    const uint8_t byte = data[pos];
    buffer |= static_cast<unsigned long>(byte) << count;
    count += 8;
    while (count >= bits) {
      const unsigned long v = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      out[int64_t(y) * xsize + x] = static_cast<float>(v);
      if (++x >= xsize) {
        if (--y < 0) return 0;
        x = 0;
        count = 0;
      }
    }
  }
  return -1;
}

}  // extern "C"

// ---- JPEG: libjpeg-turbo 3.1.3's entropy decoders, fed as Pillow feeds them ----------------
//
// Pillow hands libjpeg the file 64 KiB at a time (ImageFile.MAXBLOCK): a
// decoder that needs a byte past what it was given suspends, and Pillow
// gives it the next 64 KiB; at the end of the file that is the error
// "image file is truncated". The arithmetic decoder cannot suspend
// (jdarith.c get_byte), so a byte it needs past what Pillow has given is
// an error ("broken data stream"). The Huffman decoder of a sequential
// scan without restart interval runs its fast path (decode_mcu_fast) where
// 512 bytes a block of the MCU are buffered and no marker is pending; it
// decodes what the slow path decodes but reads the stream ahead in other
// steps, which only shows where a file ends without a marker.

namespace {

constexpr int64_t kFeed = 65536;  // Pillow's ImageFile.MAXBLOCK
constexpr int kMinGetBits = 57;   // jdhuff.h MIN_GET_BITS, a 64-bit bit buffer
constexpr int kTableInts = 256 + 18 + 18 + 256;  // lookup, maxcode, valoffset, huffval

enum JpegStatus { kTruncated = -1, kCannotSuspend = -2 };

struct JpegStop {
  int code;
};

// jpeg_source_mgr as Pillow's JpegDecode.c fills it, with libjpeg's unread_marker
struct Source {
  const uint8_t* d;
  int64_t size, pos, fed;
  int marker = 0;
  bool can_suspend = true;
  bool suspended = false;  // a suspension happened since it was last cleared

  int byte() {
    if (pos >= fed) {
      if (!can_suspend) throw JpegStop{kCannotSuspend};
      if (fed >= size) throw JpegStop{kTruncated};
      fed = std::min(size, fed + kFeed);
      suspended = true;
    }
    return d[pos++];
  }

  // jdmarker.c next_marker: skip to the next FF xx (xx not 0, not FF)
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }

  // jdmarker.c read_restart_marker with jpeg_resync_to_restart
  void read_restart_marker(int& next_restart_num) {
    if (marker == 0) next_marker();
    if (marker == 0xD0 + next_restart_num) {
      marker = 0;
    } else {
      const int desired = next_restart_num;
      for (;;) {
        int action;
        if (marker < 0xC0)
          action = 2;
        else if (marker < 0xD0 || marker > 0xD7)
          action = 3;
        else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
          action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }
};

struct Table {  // jdhuff.c d_derived_tbl, built by utils/jpeg.py
  const int32_t* lookup;  // [256] nb << 8 | symbol, nb 9 where the code is longer
  const int32_t* maxcode;  // [18]
  const int32_t* valoffset;  // [18]
  const int32_t* huffval;  // [256]
  explicit Table(const int32_t* t)
      : lookup(t), maxcode(t + 256), valoffset(t + 274), huffval(t + 292) {}
  int symbol(int64_t code, int l) const { return huffval[int(code + valoffset[l]) & 0xFF]; }
};

// the slow path's bit reader (jdhuff.c jpeg_fill_bit_buffer, HUFF_DECODE)
struct HuffBits {
  Source* src;
  uint64_t buf = 0;
  int left = 0;
  bool insufficient = false;

  void fill(int nbits) {
    if (src->marker == 0) {
      while (left < kMinGetBits) {
        int c = src->byte();
        if (c == 0xFF) {
          do c = src->byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            src->marker = c;
            goto no_more;
          }
        }
        buf = (buf << 8) | uint64_t(c);
        left += 8;
      }
      return;
    }
  no_more:
    if (nbits > left) {  // past the data: zero bits, and the segment is out of data
      insufficient = true;
      buf <<= kMinGetBits - left;
      left = kMinGetBits;
    }
  }

  int get(int n) {  // CHECK_BIT_BUFFER then GET_BITS
    if (left < n) fill(n);
    left -= n;
    return int((buf >> left) & ((uint64_t(1) << n) - 1));
  }

  int decode(const Table& t) {
    int nb;
    if (left < 8) {
      fill(0);
      if (left < 8) {
        nb = 1;
        goto slow;
      }
    }
    {
      const int e = t.lookup[(buf >> (left - 8)) & 0xFF];
      nb = e >> 8;
      if (nb <= 8) {
        left -= nb;
        return e & 0xFF;
      }
    }
  slow: {  // jpeg_huff_decode
    int l = nb;
    int64_t code = get(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // a code not in the table: a zero, 16 bits read
    return t.symbol(code, l);
  }
  }
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

inline int natural(int k) { return k < 64 ? k : 63; }  // jpeg_natural_order's 16 extra 63s

struct Scan {
  int kind, restart, ss, se, ah, al, blocks, n_mcu, ncomp;
  int dc_tbl[4], ac_tbl[4];
  int dc_l[16], dc_u[16], ac_k[16];  // arithmetic conditioning of each table id
};

// ---- Huffman, sequential ---------------------------------------------------------------------

struct Saved {
  int64_t pos;
  uint64_t buf;
  int left, marker;
  bool insufficient;
  int last_dc[4];
};

// decode_mcu_fast: 1 where it decoded the MCU, 0 where it met a marker (the slow path redoes it)
int huff_mcu_fast(const Scan& s, Source& src, HuffBits& br, int* last_dc, const int32_t* comp,
                  const int64_t* offs, int16_t* coef, const Table* dc, const Table* ac) {
  const uint8_t* d = src.d;
  int64_t pos = src.pos;
  uint64_t buf = br.buf;
  int left = br.left;
  int hit = 0;
  int dcv[4];
  for (int c = 0; c < s.ncomp; ++c) dcv[c] = last_dc[c];
  auto get_byte = [&]() {
    const int c0 = pos < src.size ? d[pos] : 0;
    ++pos;
    const int c1 = pos < src.size ? d[pos] : 0;
    buf = (buf << 8) | uint64_t(c0);
    left += 8;
    if (c0 == 0xFF) {
      ++pos;
      if (c1 != 0) {
        hit = c1;
        pos -= 2;
        buf &= ~uint64_t(0xFF);
      }
    }
  };
  auto fill = [&]() {
    if (left <= 16)
      for (int i = 0; i < 6; ++i) get_byte();
  };
  auto get = [&](int n) {
    left -= n;
    return int((buf >> left) & ((uint64_t(1) << n) - 1));
  };
  auto decode = [&](const Table& t) {
    fill();
    const int e = t.lookup[(buf >> (left - 8)) & 0xFF];
    int nb = e >> 8;
    left -= nb;
    int v = e & 0xFF;
    if (nb > 8) {
      int64_t code = int64_t((buf >> left) & ((uint64_t(1) << nb) - 1));
      while (code > t.maxcode[nb]) {
        code = (code << 1) | get(1);
        ++nb;
      }
      v = nb > 16 ? 0 : t.symbol(code, nb);
    }
    return v;
  };
  for (int b = 0; b < s.blocks; ++b) {
    const int ci = comp[b];
    int16_t* blk = coef + offs[b];
    int v = decode(dc[ci]);
    if (v) {
      fill();
      v = extend(get(v), v);
    }
    dcv[ci] = int(unsigned(dcv[ci]) + unsigned(v));
    blk[0] = int16_t(dcv[ci]);
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ac[ci]);
      const int r = rs >> 4;
      int sz = rs & 15;
      if (sz) {
        k += r;
        fill();
        blk[natural(k)] = int16_t(extend(get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
  if (hit) return 0;
  src.pos = pos;
  br.buf = buf;
  br.left = left;
  for (int c = 0; c < s.ncomp; ++c) last_dc[c] = dcv[c];
  return 1;
}

void huff_mcu_slow(const Scan& s, HuffBits& br, int* last_dc, const int32_t* comp,
                   const int64_t* offs, int16_t* coef, const Table* dc, const Table* ac) {
  for (int b = 0; b < s.blocks; ++b) {
    const int ci = comp[b];
    int16_t* blk = coef + offs[b];
    int v = br.decode(dc[ci]);
    if (v) v = extend(br.get(v), v);
    last_dc[ci] = int(unsigned(last_dc[ci]) + unsigned(v));
    blk[0] = int16_t(last_dc[ci]);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac[ci]);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[natural(k)] = int16_t(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
}

// ---- Huffman, progressive (jdphuff.c) ----------------------------------------------------------

void dc_first(const Scan& s, HuffBits& br, int* last_dc, const int32_t* comp, const int64_t* offs,
              int16_t* coef, const Table* dc) {
  for (int b = 0; b < s.blocks; ++b) {
    const int ci = comp[b];
    int v = br.decode(dc[ci]);
    if (v) v = extend(br.get(v), v);
    last_dc[ci] = int(unsigned(last_dc[ci]) + unsigned(v));
    coef[offs[b]] = int16_t(unsigned(last_dc[ci]) << s.al);
  }
}

void dc_refine(const Scan& s, HuffBits& br, const int64_t* offs, int16_t* coef) {
  for (int b = 0; b < s.blocks; ++b)
    if (br.get(1)) coef[offs[b]] = int16_t(coef[offs[b]] | (1 << s.al));
}

void ac_first(const Scan& s, HuffBits& br, int& eobrun, int16_t* blk, const Table& ac) {
  if (eobrun > 0) {
    --eobrun;
    return;
  }
  for (int k = s.ss; k <= s.se; ++k) {
    const int rs = br.decode(ac);
    int r = rs >> 4;
    const int sz = rs & 15;
    if (sz) {
      k += r;
      blk[natural(k)] = int16_t(unsigned(extend(br.get(sz), sz)) << s.al);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = 1 << r;
      if (r) eobrun += br.get(r);
      --eobrun;
      break;
    }
  }
}

void ac_refine(const Scan& s, HuffBits& br, int& eobrun, int16_t* blk, const Table& ac) {
  const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
  int k = s.ss;
  auto correct = [&](int16_t* c) {
    if (br.get(1) && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
  };
  if (eobrun == 0) {
    for (; k <= s.se; ++k) {
      const int rs = br.decode(ac);
      int r = rs >> 4, v = rs & 15;
      if (v) {
        v = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        break;
      }
      do {
        int16_t* c = blk + k;
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= s.se);
      if (v) blk[natural(k)] = int16_t(v);
    }
  }
  if (eobrun > 0) {
    for (; k <= s.se; ++k)
      if (blk[k] != 0) correct(blk + k);
    --eobrun;
  }
}

// ---- arithmetic (jdarith.c) ----------------------------------------------------------------------

#define V(i, a, b, c, d) ((int64_t(a) << 16) | (int64_t(c) << 8) | (int64_t(d) << 7) | (b))
// T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; the last entry the fixed 0.5
const int64_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),      V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),      V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),      V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),     V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),    V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),    V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),    V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),    V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),    V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),    V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),    V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),    V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),    V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),    V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),    V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),    V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),    V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),    V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),   V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0),  V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct Arith {
  Source* src;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read; -1: a bad code stopped the interval
  uint8_t dc_stats[16][64];  // by table id: libjpeg's NUM_ARITH_TBLS is 16
  uint8_t ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};

  int decode(uint8_t* st) {  // arith_decode
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (src->marker == 0) {
          data = src->byte();
          if (data == 0xFF) {
            do data = src->byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {  // a marker ends the data: zeros from here
              src->marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void reset(const Scan& s, bool progressive) {  // start_pass / process_restart
    for (int ci = 0; ci < s.ncomp; ++ci) {
      if (!progressive || (s.ss == 0 && s.ah == 0)) {
        std::memset(dc_stats[s.dc_tbl[ci]], 0, 64);
        last_dc[ci] = 0;
        dc_context[ci] = 0;
      }
      if (!progressive || s.ss) std::memset(ac_stats[s.ac_tbl[ci]], 0, 256);
    }
    c = 0;
    a = 0;
    ct = -16;
  }

  // Figures F.19-F.24: a DC difference into last_dc[ci]; false on a magnitude overflow
  bool dc_diff(const Scan& s, int ci) {
    const int tbl = s.dc_tbl[ci];
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    const int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << s.dc_l[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > int((1L << s.dc_u[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
    return true;
  }

  // an AC value after its nonzero flag (sign, category, bits); false on an overflow
  bool ac_value(uint8_t* st, uint8_t* stats, int k, int kx, int& value) {
    const int sign = decode(fixed_bin);
    st += 2;
    int m = decode(st);
    if (m != 0) {
      if (decode(st)) {
        m <<= 1;
        st = stats + (k <= kx ? 189 : 217);
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ct = -1;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    value = sign ? -v : v;
    return true;
  }
};

void arith_sequential(const Scan& s, Arith& ar, const int32_t* comp, const int64_t* offs,
                      int16_t* coef) {
  for (int b = 0; b < s.blocks; ++b) {
    const int ci = comp[b];
    int16_t* blk = coef + offs[b];
    if (!ar.dc_diff(s, ci)) return;
    blk[0] = int16_t(ar.last_dc[ci]);
    const int tbl = s.ac_tbl[ci];
    int k = 0;
    do {
      uint8_t* st = ar.ac_stats[tbl] + 3 * k;
      if (ar.decode(st)) break;  // EOB
      for (;;) {
        ++k;
        if (ar.decode(st + 1)) break;
        st += 3;
        if (k >= 63) {
          ar.ct = -1;
          return;
        }
      }
      int v;
      if (!ar.ac_value(st, ar.ac_stats[tbl], k, s.ac_k[tbl], v)) return;
      blk[k] = int16_t(v);
    } while (k < 63);
  }
}

void arith_progressive(const Scan& s, Arith& ar, const int32_t* comp, const int64_t* offs,
                       int16_t* coef) {
  if (s.ss == 0 && s.ah == 0) {  // DC first
    for (int b = 0; b < s.blocks; ++b) {
      const int ci = comp[b];
      if (!ar.dc_diff(s, ci)) return;
      coef[offs[b]] = int16_t(unsigned(ar.last_dc[ci]) << s.al);
    }
    return;
  }
  if (s.ss == 0) {  // DC refine: no check of a stopped interval
    for (int b = 0; b < s.blocks; ++b)
      if (ar.decode(ar.fixed_bin)) coef[offs[b]] = int16_t(coef[offs[b]] | (1 << s.al));
    return;
  }
  const int tbl = s.ac_tbl[0];
  int16_t* blk = coef + offs[0];
  if (s.ah == 0) {  // AC first
    for (int k = s.ss; k <= s.se; ++k) {
      uint8_t* st = ar.ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > s.se) {
          ar.ct = -1;
          return;
        }
      }
      int v;
      if (!ar.ac_value(st, ar.ac_stats[tbl], k, s.ac_k[tbl], v)) return;
      blk[k] = int16_t(unsigned(v) << s.al);
    }
    return;
  }
  const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);  // AC refine
  int kex = s.se;
  for (; kex > 0; --kex)
    if (blk[kex]) break;
  for (int k = s.ss; k <= s.se; ++k) {
    uint8_t* st = ar.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex)
      if (ar.decode(st)) break;
    for (;;) {
      int16_t* c = blk + k;
      if (*c) {
        if (ar.decode(st + 2)) *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
        break;
      }
      if (ar.decode(st + 1)) {
        *c = int16_t(ar.decode(ar.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > s.se) {
        ar.ct = -1;
        return;
      }
    }
  }
}

Scan read_scan(const int32_t* p) {
  Scan s;
  s.kind = p[0];
  s.restart = p[1];
  s.ss = p[2];
  s.se = p[3];
  s.ah = p[4];
  s.al = p[5];
  s.blocks = p[6];
  s.n_mcu = p[7];
  s.ncomp = p[8];
  for (int i = 0; i < 4; ++i) {
    s.dc_tbl[i] = p[9 + i];
    s.ac_tbl[i] = p[13 + i];
  }
  for (int i = 0; i < 16; ++i) {
    s.dc_l[i] = p[17 + i];
    s.dc_u[i] = p[33 + i];
    s.ac_k[i] = p[49 + i];
  }
  return s;
}


// ---- CCITT fax (libtiff tif_fax3.c / tif_fax3.h) ------------------------------------------------

namespace fax {

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
       S_MakeUp, S_EOL };

struct Ent {
  uint8_t state, width;
  uint32_t param;
};

struct Code {
  const char* bits;  // in the order they are sent
  uint32_t param;
};

// ITU-T T.4 tables 2 and 3 (terminating and make-up codes), table 4 (2-D modes)
const char* const kTermW[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* const kTermB[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kMakeW[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kMakeB[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kMakeX[13] = {  // 1792-2560, white and black alike
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states' FillTable: every entry whose low `width` bits (the first bits sent, read
// least significant first) are the code
void fill(Ent* t, int size, const char* bits, int state, uint32_t param) {
  const int w = int(std::strlen(bits));
  uint32_t code = 0;
  for (int i = 0; i < w; ++i) code |= uint32_t(bits[i] - '0') << i;
  for (uint32_t hi = 0; hi < (1u << (size - w)); ++hi) {
    Ent& e = t[(hi << w) | code];
    e.state = uint8_t(state);
    e.width = uint8_t(w);
    e.param = param;
  }
}

struct Tables {
  Ent main[128], white[4096], black[8192];
  Tables() {
    std::memset(this, 0, sizeof(*this));
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fill(white, 12, kMakeW[i], S_MakeUpW, 64u * (i + 1));
    for (int i = 0; i < 13; ++i) fill(white, 12, kMakeX[i], S_MakeUp, 1792u + 64u * i);
    for (int i = 0; i < 64; ++i) fill(white, 12, kTermW[i], S_TermW, uint32_t(i));
    fill(white, 12, "00000000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fill(black, 13, kMakeB[i], S_MakeUpB, 64u * (i + 1));
    for (int i = 0; i < 13; ++i) fill(black, 13, kMakeX[i], S_MakeUp, 1792u + 64u * i);
    for (int i = 0; i < 64; ++i) fill(black, 13, kTermB[i], S_TermB, uint32_t(i));
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Eof {};       // the data ran out with no bit left (prematureEOF)
struct Overflow {};  // more runs than the run arrays hold (libtiff: "Buffer overflow")

struct Bits {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;
  void need(int n) {  // NeedBits8 / NeedBits16: zeros pad while any bit is left
    while (avail < n) {
      if (cp >= ep) {
        if (avail == 0) throw Eof();
        avail = n;
        return;
      }
      uint8_t b = *cp++, r = 0;  // FillOrder 1: reversed, so the first bit is the lowest
      for (int i = 0; i < 8; ++i) r |= uint8_t(((b >> i) & 1) << (7 - i));
      acc |= uint32_t(r) << avail;
      avail += 8;
    }
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  const Ent& look(const Ent* t, int n) {
    need(n);
    const Ent& e = t[get(n)];
    clr(e.width);
    return e;
  }
};

// _TIFFFax3fillruns: the runs from white, each cut (in place) at the row's end
void fill_row(uint8_t* row, uint32_t* runs, uint32_t* erun, int64_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  int64_t x = 0;
  for (uint32_t* r = runs; r < erun; r += 2) {
    for (int k = 0; k < 2; ++k) {
      int64_t run = r[k];
      if (x + run > lastx || run > lastx) run = r[k] = uint32_t(lastx - x);
      if (run) {
        for (int64_t i = x; i < x + run; ++i) {
          if (k) row[i >> 3] |= uint8_t(0x80 >> (i & 7));
          else row[i >> 3] &= uint8_t(~(0x80 >> (i & 7)));
        }
        x += r[k];
      }
    }
  }
}

struct Row {
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* limit;
  int64_t a0 = 0, run_length = 0, lastx;
  void set(int64_t x) {  // SETVALUE
    if (pa >= limit) throw Overflow();
    *pa++ = uint32_t(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup() {  // CLEANUP_RUNS
    if (run_length) set(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) set(0);
        set(lastx - a0);
      } else if (a0 > lastx) {
        set(lastx);
        set(0);
      }
    }
  }
};

struct Decoder {
  Bits b;
  const Tables& t = tables();
  int eol = 0;  // EOLcnt

  // SYNC_EOL -> false where the data ends while the zeros before an EOL's 1 are skipped:
  // libtiff then reads the strip again from its start with no EOL before a row
  bool sync_eol() {
    if (eol == 0) {
      for (;;) {
        b.need(11);
        if (b.get(11) == 0) break;
        b.clr(1);
      }
    }
    for (;;) {
      try {
        b.need(8);
      } catch (const Eof&) {
        return false;
      }
      if (b.get(8)) break;
      b.clr(8);
    }
    while (b.get(1) == 0) b.clr(1);
    b.clr(1);
    eol = 0;
    return true;
  }

  // one colour's run (make-up codes then a terminating code) -> false on a bad code
  bool run(Row& r, bool black, bool& is_eol) {
    for (;;) {
      const Ent& e = black ? b.look(t.black, 13) : b.look(t.white, 12);
      if (e.state == S_EOL) {
        is_eol = true;
        return true;
      }
      if (e.state == (black ? S_TermB : S_TermW)) {
        r.set(e.param);
        return true;
      }
      if (e.state == (black ? S_MakeUpB : S_MakeUpW) || e.state == S_MakeUp) {
        r.a0 += e.param;
        r.run_length += e.param;
        continue;
      }
      return false;
    }
  }

  void expand_1d(Row& r) {  // EXPAND1D; Eof propagates after the row's cleanup
    try {
      for (;;) {
        bool is_eol = false;
        if (!run(r, false, is_eol) || is_eol) {
          if (is_eol) eol = 1;
          break;
        }
        if (r.a0 >= r.lastx) break;
        if (!run(r, true, is_eol) || is_eol) {
          if (is_eol) eol = 1;
          break;
        }
        if (r.a0 >= r.lastx) break;
        if (r.pa - r.thisrun >= 2 && r.pa[-1] == 0 && r.pa[-2] == 0) r.pa -= 2;
      }
    } catch (const Eof&) {
      r.cleanup();
      throw;
    }
    r.cleanup();
  }

  void expand_2d(Row& r, uint32_t* pb, uint32_t* ref_limit) {  // EXPAND2D
    int64_t b1 = *pb++;
    auto check_b1 = [&]() {
      if (r.pa != r.thisrun)
        while (b1 <= r.a0 && b1 < r.lastx) {
          if (pb + 1 >= ref_limit) throw Overflow();
          b1 += int64_t(pb[0]) + pb[1];
          pb += 2;
        }
    };
    try {
      bool bad = false;
      while (r.a0 < r.lastx) {
        if (r.pa >= r.limit) throw Overflow();
        const Ent& e = b.look(t.main, 7);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb >= ref_limit) throw Overflow();
            b1 += *pb++;
            r.run_length += b1 - r.a0;
            r.a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz: {
            const bool black_first = (r.pa - r.thisrun) & 1;
            bool is_eol = false;
            if (!run(r, black_first, is_eol) || is_eol || !run(r, !black_first, is_eol) ||
                is_eol) {
              bad = true;  // an EOL in a run's table is a bad code here
              break;
            }
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            r.set(b1 - r.a0);
            if (pb >= ref_limit) throw Overflow();
            b1 += *pb++;
            break;
          case S_VR:
            check_b1();
            r.set(b1 - r.a0 + e.param);
            if (pb >= ref_limit) throw Overflow();
            b1 += *pb++;
            break;
          case S_VL:
            check_b1();
            if (b1 < r.a0 + int64_t(e.param)) {
              bad = true;
              break;
            }
            r.set(b1 - r.a0 - e.param);
            b1 -= *--pb;
            break;
          case S_Ext:
            *r.pa++ = uint32_t(r.lastx - r.a0);
            bad = true;
            break;
          case S_EOL:
            *r.pa++ = uint32_t(r.lastx - r.a0);
            b.need(4);
            b.clr(4);
            eol = 1;
            bad = true;
            break;
          default:
            bad = true;
        }
        if (bad) break;
      }
      if (!bad && r.run_length) {
        if (r.run_length + r.a0 < r.lastx) {  // a final V0 is expected
          b.need(1);
          if (!b.get(1)) bad = true;
          else b.clr(1);
        }
        if (!bad) r.set(0);
      }
    } catch (const Eof&) {
      r.cleanup();
      throw;
    }
    r.cleanup();
  }
};

}  // namespace fax

}  // namespace

extern "C" {

// One DCT scan's entropy decode from `pos` (after its SOS segment) into the
// zigzag-ordered int16 coefficient blocks `coef`: `offsets` holds, for each
// of the scan's MCUs, the offset of each of its blocks; `block_comp` the
// scan component of each block of an MCU. `p` holds the scan (see
// read_scan: kind 0 Huffman sequential, 1 Huffman progressive, 2 arithmetic
// sequential, 3 arithmetic progressive; restart interval; Ss, Se, Ah, Al;
// blocks an MCU; MCUs; components; their DC and AC table ids; the
// arithmetic conditioning L, U and Kx of each table id) and `tables` the
// eight Huffman tables (DC 0-3, AC 0-3) as utils/jpeg.py builds them. io[0]
// is the bytes Pillow has fed on entry and on return; io[1] returns the
// marker the decoder read (0 if none), io[2] the last MCU begun while the
// segment had data (libjpeg's last_good_iMCU_row, as an MCU). Returns the
// position where libjpeg's marker reader goes on, -1 where the file ends
// without a marker (Pillow: truncated), -2 where the arithmetic decoder
// needs a byte Pillow has not fed.
int64_t jpeg_scan(const uint8_t* data, int64_t size, int64_t pos, int64_t* io, const int32_t* p,
                  const int32_t* block_comp, const int64_t* offsets, int16_t* coef,
                  const int32_t* tables) {
  const Scan s = read_scan(p);
  Source src{data, size, pos, io[0]};
  int64_t last_good = -1;
  try {
    if (s.kind >= 2) {
      src.can_suspend = false;
      Arith ar;
      ar.src = &src;
      ar.reset(s, s.kind == 3);
      int restarts_to_go = s.restart, next_restart_num = 0;
      for (int64_t m = 0; m < s.n_mcu; ++m) {
        last_good = m;
        if (s.restart) {
          if (restarts_to_go == 0) {
            src.read_restart_marker(next_restart_num);
            ar.reset(s, s.kind == 3);
            restarts_to_go = s.restart;
          }
          --restarts_to_go;
        }
        const int64_t* offs = offsets + m * s.blocks;
        if (s.kind == 3 && s.ss == 0 && s.ah != 0)
          arith_progressive(s, ar, block_comp, offs, coef);
        else if (ar.ct != -1)
          (s.kind == 2 ? arith_sequential : arith_progressive)(s, ar, block_comp, offs, coef);
      }
    } else {
      std::vector<Table> dc, ac;
      for (int i = 0; i < 4; ++i) {
        dc.emplace_back(tables + kTableInts * (s.dc_tbl[i] & 3));
        ac.emplace_back(tables + kTableInts * (4 + (s.ac_tbl[i] & 3)));
      }
      HuffBits br;
      br.src = &src;
      int last_dc[4] = {0, 0, 0, 0};
      int eobrun = 0, restarts_to_go = s.restart, next_restart_num = 0;
      const int usefast_bytes = 512 * s.blocks;
      for (int64_t m = 0; m < s.n_mcu; ++m) {
        const int64_t* offs = offsets + m * s.blocks;
        if (!br.insufficient) last_good = m;
        Saved sv{src.pos, br.buf, br.left, src.marker, br.insufficient,
                 {last_dc[0], last_dc[1], last_dc[2], last_dc[3]}};
        for (;;) {  // an MCU, again from its start where libjpeg suspended within it
          src.suspended = false;
          if (s.restart && restarts_to_go == 0) {
            br.left = 0;
            src.read_restart_marker(next_restart_num);
            for (int c = 0; c < 4; ++c) last_dc[c] = 0;
            eobrun = 0;
            restarts_to_go = s.restart;
            if (src.marker == 0) br.insufficient = false;
          }
          if (s.kind == 0) {
            const bool usefast = !s.restart && src.fed - src.pos >= usefast_bytes &&
                                 src.marker == 0;
            if (!br.insufficient &&
                !(usefast && huff_mcu_fast(s, src, br, last_dc, block_comp, offs, coef,
                                           dc.data(), ac.data())))
              huff_mcu_slow(s, br, last_dc, block_comp, offs, coef, dc.data(), ac.data());
          } else if (s.ss == 0 && s.ah == 0) {
            if (!br.insufficient) dc_first(s, br, last_dc, block_comp, offs, coef, dc.data());
          } else if (s.ss == 0) {
            dc_refine(s, br, offs, coef);
          } else if (!br.insufficient) {
            (s.ah ? ac_refine : ac_first)(s, br, eobrun, coef + offs[0], ac[0]);
          }
          if (!src.suspended || s.kind != 0 || s.restart) break;
          src.pos = sv.pos;  // the fast path may take the retried MCU
          br.buf = sv.buf;
          br.left = sv.left;
          src.marker = sv.marker;
          br.insufficient = sv.insufficient;
          for (int c = 0; c < 4; ++c) last_dc[c] = sv.last_dc[c];
        }
        if (s.restart) --restarts_to_go;
      }
    }
  } catch (const JpegStop& e) {
    io[0] = src.fed;
    return e.code;
  }
  io[0] = src.fed;
  io[1] = src.marker;
  io[2] = last_good;
  return src.pos;
}

// One lossless (SOF3) scan's Huffman decode and undifferencing from `pos`,
// as jdlhuff.c, jddiffct.c and jdlossls.c: `p` is [restart interval, the
// predictor (Ss), Se, Ah, the point transform (Al), components, MCUs a
// row, iMCU rows, interleaved, the DC table id of each component]; `geom`
// for each scan component [h, v, samples wide, samples high, rows of the
// last iMCU row, offset of its plane in `planes`, the plane's row
// stride]. A restart or a row begun out of data starts the predictors
// again at the next iMCU row's first row, as libjpeg's undifferencer
// does. Samples are written as uint8 (the value << Pt). io and the
// return value as jpeg_scan's.
int64_t jpeg_lossless_scan(const uint8_t* data, int64_t size, int64_t pos, int64_t* io,
                           const int32_t* p, const int64_t* geom, const int32_t* tables,
                           uint8_t* planes) {
  const int restart = p[0], psv = p[1], pt = p[4], ncomp = p[5], mcus_per_row = p[6];
  const int imcu_rows = p[7], interleaved = p[8];
  Source src{data, size, pos, io[0]};
  std::vector<Table> dc;
  for (int i = 0; i < ncomp; ++i) dc.emplace_back(tables + kTableInts * p[9 + i]);
  struct Comp {
    int h, v, w, ht, last_rows;
    int64_t off, stride;
    std::vector<int> diff, prev, cur;  // diffs of an iMCU row; undifferenced rows
    bool first = true;
  };
  std::vector<Comp> comps(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* g = geom + 7 * c;
    Comp& k = comps[c];
    k.h = int(g[0]);
    k.v = int(g[1]);
    k.w = int(g[2]);
    k.ht = int(g[3]);
    k.last_rows = int(g[4]);
    k.off = g[5];
    k.stride = g[6];
    const int row_len = interleaved ? mcus_per_row * k.h : k.w;
    k.diff.assign(size_t(row_len) * k.v, 0);
    k.prev.assign(k.w, 0);
    k.cur.assign(k.w, 0);
  }
  HuffBits br;
  br.src = &src;
  int rows_to_go = restart ? restart / mcus_per_row : 0, next_restart_num = 0;
  auto reset = [&]() {
    for (Comp& k : comps) k.first = true;
  };
  try {
    for (int r = 0; r < imcu_rows; ++r) {
      const bool last = r == imcu_rows - 1;
      const int mcu_rows = interleaved ? 1 : (last ? comps[0].last_rows : comps[0].v);
      for (Comp& k : comps) std::fill(k.diff.begin(), k.diff.end(), 0);
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart) {
          if (rows_to_go == 0) {
            br.left = 0;
            src.read_restart_marker(next_restart_num);
            if (src.marker == 0) br.insufficient = false;
            reset();
            rows_to_go = restart / mcus_per_row;
          }
        }
        if (br.insufficient) {
          reset();  // the row's differences stay zero
        } else {
          for (int m = 0; m < mcus_per_row; ++m) {
            for (int c = 0; c < ncomp; ++c) {
              Comp& k = comps[c];
              const int row_len = interleaved ? mcus_per_row * k.h : k.w;
              for (int dy = 0; dy < (interleaved ? k.v : 1); ++dy)
                for (int dx = 0; dx < (interleaved ? k.h : 1); ++dx) {
                  int s = br.decode(dc[c]);
                  if (s) s = s == 16 ? 32768 : extend(br.get(s), s);
                  const int row = interleaved ? dy : y;
                  const int col = interleaved ? m * k.h + dx : m;
                  k.diff[size_t(row) * row_len + col] = s;
                }
            }
          }
        }
        if (restart) --rows_to_go;
      }
      for (Comp& k : comps) {  // undifference and scale the iMCU row's rows
        const int row_len = interleaved ? mcus_per_row * k.h : k.w;
        const int rows = last ? k.last_rows : k.v;
        for (int row = 0; row < rows; ++row) {
          const int* d = k.diff.data() + size_t(row) * row_len;
          int* u = k.cur.data();
          const int* b = k.prev.data();
          if (k.first) {
            int ra = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < k.w; ++x) u[x] = ra = (d[x] + ra) & 0xFFFF;
            k.first = false;
          } else {
            int rb = b[0], ra = (d[0] + rb) & 0xFFFF, rc;
            u[0] = ra;
            for (int x = 1; x < k.w; ++x) {
              rc = rb;
              rb = b[x];
              int pred;
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              u[x] = ra = (d[x] + pred) & 0xFFFF;
            }
          }
          const int64_t yy = int64_t(r) * k.v + row;
          uint8_t* out = planes + k.off + yy * k.stride;
          for (int x = 0; x < k.w; ++x) out[x] = uint8_t(u[x] << pt);
          std::swap(k.prev, k.cur);
        }
      }
    }
  } catch (const JpegStop& e) {
    io[0] = src.fed;
    return e.code;
  }
  io[0] = src.fed;
  io[1] = src.marker;
  io[2] = -1;
  return src.pos;
}

// Fax3SetupState's run array length (each of the current and the reference row's)
int64_t ccitt_nruns(int32_t width, int32_t ref) {
  return (int64_t(width) + 1 + 31) / 32 * 32 * (ref ? 2 : 1);
}

// One strip or tile of `rows` rows of `width` pixels -> packed rows (MSB first, black 1) in
// `out`, whose rows the caller keeps from the strip before (libtiff leaves a row it does not
// reach as it was). kind: 2 modified Huffman (rows byte-aligned), 3 T.4 (`two_d`: Group3Options
// bit 0), 4 T.6. `no_eol` is libtiff's mode bit for T.4 data without EOLs and `runs` its run
// arrays (2 x ccitt_nruns + 2, zeroed once), both kept by the caller from strip to strip, as
// libtiff keeps them: a pass code past the reference row's end reads what an earlier row left
// there. Returns the rows written (fewer where T.6 data ends or meets an EOL after its first
// row: libtiff leaves the rest as they were), or -1 where libtiff's decode fails (data that
// ends with no bit left in a kind that fails on it, a first T.6 row cut by an EOL, too many
// runs).
int ccitt_rows(const uint8_t* data, int64_t size, int32_t width, int32_t rows, int32_t kind,
               int32_t two_d, uint8_t* out, int32_t* no_eol, uint32_t* runs) {
  using namespace fax;
  const int64_t rowbytes = (int64_t(width) + 7) >> 3;
  const bool ref = kind == 4 || (kind == 3 && two_d);
  const int64_t nruns = ccitt_nruns(width, ref);
  uint32_t* cur = runs;  // Fax3PreDecode: the arrays at their places, their contents as they were
  uint32_t* refr = ref ? runs + nruns : nullptr;
  if (ref) {
    refr[0] = uint32_t(width);
    refr[1] = 0;
  }
  Decoder d;
  d.b.cp = data;
  d.b.ep = data + size;
  int line = 0;
  for (int32_t y = 0; y < rows; ++y) {
    uint8_t* row = out + y * rowbytes;
    Row r;
    r.thisrun = r.pa = cur;
    r.limit = cur + nruns;
    r.lastx = width;
    try {
      if (kind == 2) {
        d.expand_1d(r);
      } else if (kind == 3) {
        bool is1d = true;
        try {
          if (!*no_eol && !d.sync_eol()) {  // Fax3Decode1D/2D: the state cached at the call
            *no_eol = 1;                     // again, the strip's first bit; the flag stays set
            d.b = fax::Bits{data, data + size};
            d.eol = 0;
          }
          if (two_d) {
            d.b.need(1);
            is1d = d.b.get(1);
            d.b.clr(1);
          }
        } catch (const Eof&) {
          r.cleanup();
          throw;
        }
        if (is1d) d.expand_1d(r);
        else d.expand_2d(r, refr, refr + nruns);
      } else {
        d.expand_2d(r, refr, refr + nruns);
        if (d.eol) {  // an EOL (EOFB) ends the strip: Fax4Decode's EOFG4
          fill_row(row, r.thisrun, r.pa, width);
          return line ? line + 1 : -1;
        }
      }
    } catch (const Eof&) {
      fill_row(row, r.thisrun, r.pa, width);
      return kind == 4 && line ? line + 1 : -1;  // Fax4Decode: "don't error on badly-terminated strips"
    } catch (const Overflow&) {
      return -1;
    }
    fill_row(row, r.thisrun, r.pa, width);
    if (kind == 2) {  // FAXMODE_BYTEALIGN: the rest of the byte dropped
      d.b.clr(d.b.avail & 7);
    }
    if (ref) {
      if (r.pa < r.thisrun + nruns) r.set(0);  // the imaginary change for the reference
      std::swap(cur, refr);
    }
    ++line;
  }
  return rows;
}

// Pillow's BmpRleDecoder from byte `pos` of the whole file (`size` bytes) -> the first
// `room` of its samples in `out` (zeroed by the caller). Returns the samples it made, at
// least `want` unless the stream ended first, or -1 where a delta's (right, up) is cut short
// (Pillow's ValueError).
int64_t bmp_rle(const uint8_t* raw, int64_t size, int64_t pos, int64_t width, int64_t want,
                int32_t rle4, uint8_t* out, int64_t room) {
  int64_t n = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (n < room) out[n] = v;
    ++n;
  };
  while (n < want) {
    if (pos + 2 > size) break;
    int count = raw[pos], byte = raw[pos + 1];
    pos += 2;
    if (count) {
      int64_t c = std::max<int64_t>(0, std::min<int64_t>(count, width - x));
      for (int64_t i = 0; i < c; ++i)
        put(rle4 ? uint8_t(i & 1 ? byte & 15 : byte >> 4) : uint8_t(byte));
      x += c;
    } else if (byte == 0) {
      while (n % width) put(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (pos + 2 > size) break;
      pos += 2;
      if (pos + 2 > size) return -1;
      n += raw[pos] + int64_t(raw[pos + 1]) * width;  // zeros: `out` starts zeroed
      pos += 2;
      x = n % width;
    } else {
      const int64_t m = rle4 ? byte / 2 : byte;
      const int64_t got = std::min(m, size - pos);
      for (int64_t i = 0; i < got; ++i) {
        const uint8_t v = raw[pos + i];
        if (rle4) {
          put(v >> 4);
          put(v & 15);
        } else {
          put(v);
        }
      }
      pos += got;
      if (got < m) break;
      x += byte;
      pos += pos & 1;
    }
  }
  return n;
}

}  // extern "C"

// ---- xz_strip: one .xz stream of a TIFF LZMA strip (compression 34925) ---------------------
//
// libtiff 4.7.1's LZMADecode hands liblzma the strip's bytes and an output buffer of the
// strip's size in one lzma_code loop, and keeps what liblzma wrote there when it stops: a
// strip whose bytes all came out decodes, whatever liblzma finds after them (a bad check,
// junk after the stream); one it stops short of fails. liblzma copies what its LZMA decoder
// wrote to the dictionary out before it reports an error, so the strip holds every byte
// decoded before the error. This decoder is written from the .xz and LZMA2 formats and
// liblzma's checks: the stream header (magic, flags, CRC32), one block header (CRC32, flags,
// sizes, the LZMA2 filter and its dictionary size), LZMA2 chunks (control bytes, dictionary,
// state and property resets, uncompressed chunks), and in each LZMA chunk the range decoder
// (first byte 0, normalised before each bit), the literal, match and rep coders, a distance
// past what the dictionary holds, a match cut by the chunk's end and, at the chunk's end, the
// range decoder finished and the chunk's compressed size used up. Where the block ends, the
// stream ends short of the strip: what follows it (padding, check, index, footer) is not read.

namespace xz {

uint32_t crc32(const uint8_t* p, int64_t n) {
  static uint32_t table[256];
  static bool made = false;
  if (!made) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    made = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

// a variable-length integer of the .xz format (at most 9 bytes, no trailing zero byte)
bool vli(const uint8_t* p, int64_t end, int64_t& pos, uint64_t& v) {
  v = 0;
  for (int i = 0; i < 9; ++i) {
    if (pos >= end) return false;
    const uint8_t b = p[pos++];
    v |= uint64_t(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return !(b == 0 && i > 0);
  }
  return false;
}

struct Stop {};  // liblzma stopped: an error, or the input ran out

struct Decoder {
  const uint8_t* in;
  int64_t n, pos = 0;
  uint8_t* out;
  int64_t size, got = 0;
  int64_t dict_start = 0;  // where the dictionary was last reset
  uint64_t dict_size = 0;  // liblzma's buffer: at least 4 KiB, a multiple of 16
  // the LZMA state
  uint32_t range = 0, code = 0;
  int lc = 0, lp = 0, pb = 0;
  uint32_t state = 0, rep[4] = {0, 0, 0, 0};
  std::vector<uint16_t> literal;
  uint16_t is_match[12 << 4], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
      is_rep0_long[12 << 4], dist_slot[4][64], dist_special[115], dist_align[16];
  struct Len {
    uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  } len_dec, rep_len_dec;

  uint8_t byte() {
    if (pos >= n) throw Stop();
    return in[pos++];
  }
  int64_t full() const {
    const int64_t f = got - dict_start;
    return f < int64_t(dict_size) ? f : int64_t(dict_size);
  }
  void normalize() {
    if (range < (1u << 24)) {
      range <<= 8;
      code = code << 8 | byte();
    }
  }
  int bit(uint16_t& p) {
    normalize();
    const uint32_t bound = (range >> 11) * p;
    if (code < bound) {
      range = bound;
      p += (2048 - p) >> 5;
      return 0;
    }
    range -= bound;
    code -= bound;
    p -= p >> 5;
    return 1;
  }
  uint32_t tree(uint16_t* p, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) m = m << 1 | bit(p[m]);
    return m - (1u << bits);
  }
  uint32_t reverse(uint16_t* p, int bits) {
    uint32_t m = 1, v = 0;
    for (int i = 0; i < bits; ++i) {
      const int b = bit(p[m]);
      m = m << 1 | b;
      v |= uint32_t(b) << i;
    }
    return v;
  }
  uint32_t direct(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      normalize();
      range >>= 1;
      const uint32_t b = code >= range;
      if (b) code -= range;
      v = v << 1 | b;
    }
    return v;
  }
  uint32_t length(Len& l, uint32_t ps) {
    if (!bit(l.choice)) return 2 + tree(l.low[ps], 3);
    if (!bit(l.choice2)) return 10 + tree(l.mid[ps], 3);
    return 18 + tree(l.high, 8);
  }
  void reset_state() {
    auto init = [](uint16_t* p, size_t k) { std::fill(p, p + k, uint16_t(1024)); };
    literal.assign(size_t(0x300) << (lc + lp), 1024);
    init(is_match, sizeof(is_match) / 2);
    init(is_rep, 12);
    init(is_rep0, 12);
    init(is_rep1, 12);
    init(is_rep2, 12);
    init(is_rep0_long, sizeof(is_rep0_long) / 2);
    init(&dist_slot[0][0], sizeof(dist_slot) / 2);
    init(dist_special, 115);
    init(dist_align, 16);
    init(reinterpret_cast<uint16_t*>(&len_dec), sizeof(Len) / 2);
    init(reinterpret_cast<uint16_t*>(&rep_len_dec), sizeof(Len) / 2);
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
  }
  // writes one byte; false once the strip is full
  bool put(uint8_t v) {
    out[got++] = v;
    return got < size;
  }
  // one LZMA chunk of `usize` bytes from `csize` bytes of input -> false once the strip is full
  bool lzma_chunk(uint32_t usize, uint32_t csize) {
    const int64_t in_start = pos, end = got + usize;
    if (byte() != 0) throw Stop();  // liblzma: the range decoder's first byte must be 0
    range = 0xFFFFFFFFu;
    code = 0;
    for (int i = 0; i < 4; ++i) code = code << 8 | byte();
    const uint32_t pb_mask = (1u << pb) - 1, lp_mask = (1u << lp) - 1;
    while (got < end) {
      const uint32_t at = uint32_t(got - dict_start), ps = at & pb_mask;
      if (!bit(is_match[state << 4 | ps])) {  // a literal
        const uint8_t prev = got > dict_start ? out[got - 1] : 0;
        uint16_t* p = &literal[0x300 * (((at & lp_mask) << lc) + (prev >> (8 - lc)))];
        uint32_t sym = 1;
        if (state >= 7) {  // matched: the byte at rep0 steers the first bits
          uint32_t match = out[got - rep[0] - 1];
          while (sym < 0x100) {
            const uint32_t mb = (match >> 7) & 1;
            match <<= 1;
            const int b = bit(p[0x100 + (mb << 8) + sym]);
            sym = sym << 1 | b;
            if (mb != uint32_t(b)) break;
          }
        }
        while (sym < 0x100) sym = sym << 1 | bit(p[sym]);
        state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
        if (!put(uint8_t(sym))) return false;
        continue;
      }
      uint32_t len;
      if (bit(is_rep[state])) {
        if (full() == 0) throw Stop();
        if (!bit(is_rep0[state])) {
          if (!bit(is_rep0_long[state << 4 | ps])) {  // a short rep: one byte at rep0
            state = state < 7 ? 9 : 11;
            if (!put(out[got - rep[0] - 1])) return false;
            continue;
          }
        } else {
          uint32_t d;
          if (!bit(is_rep1[state])) {
            d = rep[1];
          } else {
            if (!bit(is_rep2[state])) {
              d = rep[2];
            } else {
              d = rep[3];
              rep[3] = rep[2];
            }
            rep[2] = rep[1];
          }
          rep[1] = rep[0];
          rep[0] = d;
        }
        len = length(rep_len_dec, ps);
        state = state < 7 ? 8 : 11;
      } else {
        rep[3] = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        len = length(len_dec, ps);
        state = state < 7 ? 7 : 10;
        const uint32_t slot = tree(dist_slot[len < 6 ? len - 2 : 3], 6);
        uint32_t dist;
        if (slot < 4) {
          dist = slot;
        } else {
          const int bits = int(slot >> 1) - 1;
          dist = (2 | (slot & 1)) << bits;
          if (slot < 14) {
            dist += reverse(dist_special + dist - slot, bits);
          } else {
            dist += direct(bits - 4) << 4;
            dist += reverse(dist_align, 4);
          }
        }
        rep[0] = dist;
        if (dist == 0xFFFFFFFFu) throw Stop();  // an end marker: LZMA2 has none
      }
      if (int64_t(rep[0]) >= full()) throw Stop();  // past what the dictionary holds
      for (uint32_t i = 0; i < len; ++i) {
        if (got == end) throw Stop();  // the match runs past the chunk
        if (!put(out[got - rep[0] - 1])) return false;
      }
    }
    if (code != 0 || pos - in_start != int64_t(csize)) throw Stop();
    return true;
  }
  // the LZMA2 chunks of the block -> false once the strip is full
  bool lzma2() {
    bool need_dict = true, need_props = true;
    while (true) {
      const uint8_t c = byte();
      if (c == 0) return true;  // the end of the block's data
      if (c >= 0xE0 || c == 1) {  // a dictionary reset, which wants new properties
        need_props = true;
        need_dict = false;
        dict_start = got;
      } else if (need_dict) {
        throw Stop();
      }
      if (c >= 0x80) {
        uint32_t usize = uint32_t(c & 0x1F) << 16;
        usize += uint32_t(byte()) << 8;
        usize += byte() + 1u;
        uint32_t csize = uint32_t(byte()) << 8;
        csize += byte() + 1u;
        if (c >= 0xC0) {
          uint32_t d = byte();
          if (d > (4 * 5 + 4) * 9 + 8) throw Stop();
          lc = int(d % 9);
          d /= 9;
          lp = int(d % 5);
          pb = int(d / 5);
          if (lc + lp > 4) throw Stop();
          need_props = false;
          reset_state();
        } else if (need_props) {
          throw Stop();
        } else if (c >= 0xA0) {
          reset_state();
        }
        if (!lzma_chunk(usize, csize)) return false;
      } else {
        if (c > 2) throw Stop();
        uint32_t csize = uint32_t(byte()) << 8;
        csize += byte() + 1u;
        for (uint32_t i = 0; i < csize; ++i)
          if (!put(byte())) return false;
      }
    }
  }
};

}  // namespace xz

extern "C" {

// One .xz stream (`n` bytes) -> at most `size` bytes into `out`. Returns the bytes written:
// `size` where the strip came out whole, fewer where liblzma would have stopped first.
int64_t xz_strip(const uint8_t* in, int64_t n, uint8_t* out, int64_t size) {
  if (size <= 0) return 0;
  auto dec = std::make_unique<xz::Decoder>();
  dec->in = in;
  dec->n = n;
  dec->out = out;
  dec->size = size;
  static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (n < 12 || std::memcmp(in, magic, 6) != 0 || xz::crc32(in + 6, 2) != xz::le32(in + 8) ||
      in[6] != 0 || (in[7] & 0xF0))
    return 0;
  int64_t pos = 12;
  if (pos >= n || in[pos] == 0) return 0;  // no block: the index
  const int64_t head = (int64_t(in[pos]) + 1) * 4, end = pos + head;
  if (end > n || xz::crc32(in + pos, head - 4) != xz::le32(in + end - 4)) return 0;
  const uint8_t flags = in[pos + 1];
  if (flags & 0x3C) return 0;
  int64_t p = pos + 2;
  uint64_t v, id, psize;
  if ((flags & 0x40) && (!xz::vli(in, end - 4, p, v) || v == 0)) return 0;
  if ((flags & 0x80) && !xz::vli(in, end - 4, p, v)) return 0;
  if ((flags & 3) != 0) return 0;  // a filter before LZMA2: none is written here
  if (!xz::vli(in, end - 4, p, id) || !xz::vli(in, end - 4, p, psize) || id != 0x21 ||
      psize != 1 || p >= end - 4 || in[p] > 40)
    return 0;
  const uint32_t bits = in[p++];
  uint64_t dict = bits == 40 ? 0xFFFFFFFFull : uint64_t(2 | (bits & 1)) << (bits / 2 + 11);
  dict = std::max<uint64_t>(dict, 4096);
  dec->dict_size = (dict + 15) & ~uint64_t(15);
  for (; p < end - 4; ++p)
    if (in[p]) return 0;
  dec->pos = end;
  try {
    dec->lzma2();
  } catch (const xz::Stop&) {
  }
  return dec->got;
}

}  // extern "C"
