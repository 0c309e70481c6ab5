// The BC6H and BC7 block decoders of the port's DDS decoder, and the
// PackBits rows of its PSD decoder: host C++, built by g++ at first use
// (ops/_build.py `compile_host`) and called through ctypes from
// rustic_tpu_torch/utils/dds.py and psd.py.
//
// - bcn_blocks: 16-byte BC6H (unsigned or signed) or BC7 blocks, each to
//   16 RGBA pixels in the block's row order, as Pillow 12.1.0's
//   BcnDecode.c decodes them. BC7: the 8 modes, the 2- and 3-subset
//   partitions with their anchor indices, p-bits, endpoints widened by bit
//   replication, the rotation and the index-selection bit; a first byte of
//   0 (the reserved mode) gives opaque black. BC6H: the 14 modes and their
//   endpoint bit layouts; a signed block's base endpoint and every delta
//   sign-extended, each delta added to the base modulo 2^bits and the sum
//   kept as it is (BcnDecode.c does not sign-extend it again: below 16 bits
//   a negative sum stays a large positive value, at 16 bits it is read as
//   int16); unquantisation, the weighted sum cut toward zero by a shift of
//   6 (no rounding term), times 31/64 (31/32 signed) to a half float,
//   clamped to [0, 1] and cut toward zero after times 255; alpha 255; the
//   four reserved modes give black.
// - packbits_rows: Pillow's PackDecode.c on one channel of a PSD: rows of
//   `row_bytes`, a run or literal that passes a row's end cut there (the
//   rest of it dropped), 0x80 skipped.
//
// BC1-BC5 and everything else of the two formats stay in NumPy.

#include <cstdint>
#include <cstring>

namespace {

// ---- bits, LSB first -------------------------------------------------------------------------

inline int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

inline int get_bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= get_bit(src, bit + i) << i;
  return v;
}

// ---- BC7 --------------------------------------------------------------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

// subsets, partition bits, rotation bits, index-selection bits, colour
// bits, alpha bits, p-bit an endpoint, p-bit a subset, index bits, second
// index bits
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},
};

// the two-subset partitions: bit i = the subset of pixel i
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800,
    0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc,
    0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718,
    0xccf0, 0x0fcc, 0x7744, 0xee22,
};

// the three-subset partitions: bits 2i, 2i+1 = the subset of pixel i
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};

// anchor pixels: the second subset of two, and the second and third of three
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15,  2,  8,  2,  2,  8,  8, 15,  2,  8,  2,  2,  8,  8,  2,  2,
    15, 15,  6,  8,  2,  8, 15, 15,  2,  8,  2,  2,  2, 15, 15,  6,
     6,  2,  6,  8, 15, 15,  2,  2, 15, 15, 15, 15, 15,  2,  2, 15,
};
const uint8_t kAnchor3b[64] = {
     3,  3, 15, 15,  8,  3, 15, 15,  8,  8,  6,  6,  6,  5,  3,  3,
     3,  3,  8, 15,  3,  3,  6, 10,  5,  8,  8,  6,  8,  5, 15, 15,
     8, 15,  3,  5,  6, 10,  8, 15, 15,  3, 15,  5, 15, 15, 15, 15,
     3, 15,  5,  5,  5,  8,  5, 10,  5, 10,  8, 13, 15, 12,  3,  3,
};
const uint8_t kAnchor3c[64] = {
    15,  8,  8,  3, 15, 15,  3,  8, 15, 15, 15, 15, 15, 15, 15,  8,
    15,  8, 15,  3, 15,  8, 15,  8,  3, 15,  6, 10, 15, 15, 10,  8,
    15,  3, 15, 10, 10,  8,  9, 10,  6, 15,  8, 15,  3,  6,  6,  8,
    15,  3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,  3, 15, 15,  8,
};

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) { return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4; }

int subset(int ns, int partition, int i) {
  if (ns == 2) return (kPartition2[partition] >> i) & 1;
  if (ns == 3) return (kPartition3[partition] >> (2 * i)) & 3;
  return 0;
}

struct Rgba {
  int c[4];
};

uint8_t interp(int e0, int e1, int w) { return static_cast<uint8_t>(((64 - w) * e0 + w * e1 + 32) >> 6); }

void decode_bc7(const uint8_t* src, uint8_t* out) {
  if (src[0] == 0) {  // the reserved mode
    for (int i = 0; i < 16; ++i) {
      out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = 0;
      out[4 * i + 3] = 255;
    }
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  int bit = mode + 1;
  const Bc7Mode& m = kBc7Modes[mode];
  int cb = m.cb, ab = m.ab;
  const int* cw = weights(m.ib);
  const int* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  int numep = 2 * m.ns;
  Rgba ep[6];
  for (int ch = 0; ch < 3; ++ch) {
    for (int i = 0; i < numep; ++i) {
      ep[i].c[ch] = get_bits(src, bit, cb);
      bit += cb;
    }
  }
  for (int i = 0; i < numep; ++i) {
    if (ab) {
      ep[i].c[3] = get_bits(src, bit, ab);
      bit += ab;
    } else {
      ep[i].c[3] = 255;
    }
  }
  if (m.epb || m.spb) {
    ++cb;
    if (ab) ++ab;
    int p = 0;
    for (int i = 0; i < numep; ++i) {
      if (m.epb || i % 2 == 0) p = get_bit(src, bit++);  // a p-bit an endpoint, or a subset
      for (int ch = 0; ch < 3; ++ch) ep[i].c[ch] = (ep[i].c[ch] << 1) | p;
      if (ab) ep[i].c[3] = (ep[i].c[3] << 1) | p;
    }
  }
  for (int i = 0; i < numep; ++i) {
    for (int ch = 0; ch < 3; ++ch) {
      int x = ep[i].c[ch];
      ep[i].c[ch] = ((x << (8 - cb)) | (x >> (2 * cb - 8))) & 0xFF;
    }
    if (ab) {
      int x = ep[i].c[3];
      ep[i].c[3] = ((x << (8 - ab)) | (x >> (2 * ab - 8))) & 0xFF;
    }
  }
  int cibit = bit;
  int aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    int s = 2 * subset(m.ns, partition, i);
    int ib = m.ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition]) ||
        (m.ns == 3 && (i == kAnchor3b[partition] || i == kAnchor3c[partition])))
      --ib;
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    int wc = cw[i0], wa = cw[i0];
    if (ab && m.ib2) {
      int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wc = cw[i0];
        wa = aw[i1];
      }
    }
    uint8_t px[4];
    for (int ch = 0; ch < 3; ++ch) px[ch] = interp(ep[s].c[ch], ep[s + 1].c[ch], wc);
    px[3] = interp(ep[s].c[3], ep[s + 1].c[3], wa);
    if (rotation) {
      uint8_t t = px[rotation - 1];
      px[rotation - 1] = px[3];
      px[3] = t;
    }
    std::memcpy(out + 4 * i, px, 4);
  }
}

// ---- BC6H -------------------------------------------------------------------------------------

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};

// regions, transformed, partition bits, endpoint bits, delta bits of r, g, b
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4},
};

// each header bit after the mode bits, in stream order: 16 * endpoint
// value (r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3) + its bit
const uint8_t kBc6Layout[14][75] = {
    {116, 132, 180,   0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,
      18,  19,  20,  21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,
      39,  40,  41,  48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,
      66,  67,  68, 176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128,
     129, 130, 131,  96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165,   0,   1,   2,   3,   4,   5,   6, 176, 177, 132,  16,  17,
      18,  19,  20,  21,  22, 133, 178, 116,  32,  33,  34,  35,  36,  37,  38,
     179, 181, 180,  48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,
      66,  67,  68,  69, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128,
     129, 130, 131,  96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  10, 112, 113, 114, 115,  64,  65,  66,  67,  26,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  42, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  10, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      26, 160, 161, 162, 163,  80,  81,  82,  83,  42, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 176, 178, 144, 145, 146, 147, 116, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  10, 132, 112, 113, 114, 115,  64,  65,  66,  67,  26,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84,  42, 128, 129, 130, 131,
      96,  97,  98,  99, 177, 178, 144, 145, 146, 147, 180, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8, 132,  16,  17,  18,  19,  20,
      21,  22,  23,  24, 116,  32,  33,  34,  35,  36,  37,  38,  39,  40, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7, 164, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 178, 116,  32,  33,  34,  35,  36,  37,  38,  39, 179, 180,
      48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7, 176, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 117, 116,  32,  33,  34,  35,  36,  37,  38,  39, 165, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      69, 160, 161, 162, 163,  80,  81,  82,  83,  84, 177, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7, 177, 132,  16,  17,  18,  19,  20,
      21,  22,  23, 133, 116,  32,  33,  34,  35,  36,  37,  38,  39, 181, 180,
      48,  49,  50,  51,  52, 164, 112, 113, 114, 115,  64,  65,  66,  67,  68,
     176, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 178, 144, 145, 146, 147, 148, 179,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5, 164, 176, 177, 132,  16,  17,  18,  19,  20,
      21, 117, 133, 178, 116,  32,  33,  34,  35,  36,  37, 165, 179, 181, 180,
      48,  49,  50,  51,  52,  53, 112, 113, 114, 115,  64,  65,  66,  67,  68,
      69, 160, 161, 162, 163,  80,  81,  82,  83,  84,  85, 128, 129, 130, 131,
      96,  97,  98,  99, 100, 101, 144, 145, 146, 147, 148, 149,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  64,  65,  66,  67,  68,
      69,  70,  71,  72,  73,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  56,  10,  64,  65,  66,  67,  68,
      69,  70,  71,  72,  26,  80,  81,  82,  83,  84,  85,  86,  87,  88,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  52,  53,  54,  55,  11,  10,  64,  65,  66,  67,  68,
      69,  70,  71,  27,  26,  80,  81,  82,  83,  84,  85,  86,  87,  43,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
    {  0,   1,   2,   3,   4,   5,   6,   7,   8,   9,  16,  17,  18,  19,  20,
      21,  22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
      48,  49,  50,  51,  15,  14,  13,  12,  11,  10,  64,  65,  66,  67,  31,
      30,  29,  28,  27,  26,  80,  81,  82,  83,  47,  46,  45,  44,  43,  42,
       0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0,   0},
};

void sign_extend(int& v, int bits) {
  v &= (1 << bits) - 1;
  if (v & (1 << (bits - 1))) v -= 1 << bits;
}

int unquantize(int x, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xFFFF;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  x = static_cast<int16_t>(x);  // the endpoint as Pillow keeps it, 16 bits
  if (prec >= 16) return x;
  bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) x = x >= (1 << (prec - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (prec - 1);
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000u;
  o.u = static_cast<uint32_t>(h & 0x7FFF) << 13;
  o.f *= m.f;
  m.u = 0x47800000u;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

uint8_t finalize(int v, bool sign) {
  float f;
  if (!sign) f = half_to_float(static_cast<uint16_t>((v * 31) / 64));
  else if (v < 0) f = half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31) / 32));
  else f = half_to_float(static_cast<uint16_t>((v * 31) / 32));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void decode_bc6(const uint8_t* src, bool sign, uint8_t* out) {
  int low = src[0] & 0x1F, mode, bit;
  if ((low & 3) < 2) {
    mode = low & 3;
    bit = 2;
  } else if ((low & 3) == 2) {
    mode = (low >> 2) + 2;
    bit = 5;
  } else {
    mode = (low >> 2) + 10;
    bit = 5;
  }
  if (mode >= 14) {  // reserved
    for (int i = 0; i < 16; ++i) {
      out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = 0;
      out[4 * i + 3] = 255;
    }
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int epbits = m.ns == 2 ? 77 - bit : 60;
  int ib = m.ns == 2 ? 3 : 4;
  int ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    int d = kBc6Layout[mode][i];
    ep[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += epbits;
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int numep = 6 * m.ns;
  int mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) sign_extend(ep[c], m.epb);
  const int dbits[3] = {m.rb, m.gb, m.bb};
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i) sign_extend(ep[i], dbits[i % 3]);
  if (m.tr) {
    for (int i = 3; i < numep; ++i) {
      ep[i] = (ep[i] + ep[i % 3]) & mask;
    }
  }
  int uq[12];
  for (int i = 0; i < numep; ++i) uq[i] = unquantize(ep[i], m.epb, sign);
  const int* w = weights(ib);
  for (int i = 0; i < 16; ++i) {
    int s = 6 * subset(m.ns, partition, i);
    int b = ib - ((i == 0 || (m.ns == 2 && i == kAnchor2[partition])) ? 1 : 0);
    int idx = get_bits(src, bit, b);
    bit += b;
    int t = w[idx];
    for (int c = 0; c < 3; ++c)
      out[4 * i + c] = finalize((uq[s + c] * (64 - t) + uq[s + 3 + c] * t) >> 6, sign);
    out[4 * i + 3] = 255;
  }
}

}  // namespace

extern "C" {

// nb blocks of 16 bytes -> nb x 16 RGBA pixels; kind 0 BC6H unsigned,
// 1 BC6H signed, 2 BC7. Returns 0, or 1 for an unknown kind.
int bcn_blocks(const uint8_t* src, int64_t nb, int kind, uint8_t* out) {
  if (kind < 0 || kind > 2) return 1;
  for (int64_t b = 0; b < nb; ++b) {
    if (kind == 2) decode_bc7(src + 16 * b, out + 64 * b);
    else decode_bc6(src + 16 * b, kind == 1, out + 64 * b);
  }
  return 0;
}

// PackBits from src[0, n) into `rows` rows of `row_bytes` at dst, as
// Pillow's PackDecode.c: returns the bytes read, or -1 when the data ends
// before the last row is full.
int64_t packbits_rows(const uint8_t* src, int64_t n, int64_t row_bytes, int64_t rows,
                      uint8_t* dst) {
  int64_t pos = 0, x = 0, y = 0;
  if (rows == 0) return 0;
  for (;;) {
    if (pos >= n) return -1;
    int op = src[pos];
    if (op == 0x80) {
      ++pos;
      continue;
    }
    uint8_t* row = dst + y * row_bytes;
    if (op & 0x80) {
      if (pos + 2 > n) return -1;
      for (int k = 257 - op; k > 0 && x < row_bytes; --k) row[x++] = src[pos + 1];
      pos += 2;
    } else {
      int len = op + 1;
      if (pos + 1 + len > n) return -1;
      for (int k = 0; k < len && x < row_bytes; ++k) row[x++] = src[pos + 1 + k];
      pos += 1 + len;
    }
    if (x >= row_bytes) {
      x = 0;
      if (++y >= rows) return pos;
    }
  }
}

}  // extern "C"
