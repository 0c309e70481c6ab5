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
//
// Everything else of the decoders (headers, tables, transforms,
// prediction, filtering, colour) stays in NumPy.

#include <cstdint>
#include <algorithm>
#include <cstring>
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
