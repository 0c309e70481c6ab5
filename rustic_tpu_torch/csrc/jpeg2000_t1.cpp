// The tier-1 (EBCOT) block decoder of the port's JPEG 2000 decoder: host
// C++, built by g++ at first use (ops/_build.py `compile_host`) and called
// through ctypes from rustic_tpu_torch/utils/jpeg2000.py.
//
// - j2k_codeblocks: the code-blocks of an image, each an MQ-coded segment
//   of code-block style 0 (ISO/IEC 15444-1 Annex C and D): the cleanup,
//   significance propagation and magnitude refinement passes over stripes
//   of four rows, with the run-length mode of the cleanup pass. Each
//   coefficient comes out as OpenJPEG 2.5 keeps it: its magnitude with one
//   more bit below the last decoded plane, set to one half of that plane
//   (the mid-point of what the decoded planes leave open), and its sign.
//
// Tier-2 (packet headers), dequantisation, the wavelets and the colour
// stay in NumPy.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- the MQ decoder (Annex C, with OpenJPEG's register layout) ---------------------------------

struct MQState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MQState kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 magnitude refinement, 17 run length, 18 uniform
enum { CTX_SC = 9, CTX_MAG = 14, CTX_RL = 17, CTX_UNI = 18, N_CTX = 19 };

struct MQ {
  const uint8_t* bp;  // the byte last read; the data ends with 0xFF 0xFF
  uint32_t a, c;
  int ct;
  uint8_t state[N_CTX], mps[N_CTX];

  void init(const uint8_t* data, int64_t len) {
    for (int i = 0; i < N_CTX; ++i) state[i] = mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_RL] = 3;
    state[0] = 4;
    bp = data;
    c = static_cast<uint32_t>(len == 0 ? 0xFF : data[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void bytein() {
    const uint32_t next = bp[1];
    if (bp[0] == 0xFF) {
      if (next > 0x8F) {  // a marker: feed ones and stay on it
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }

  int decode(int cx) {
    const MQState& s = kStates[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // the LPS sub-interval
      if (a < s.qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(d);
        state[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = static_cast<uint8_t>(d);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ---- tier-1 (Annex D) --------------------------------------------------------------------------

enum : uint8_t { SIG = 1, NEG = 2, VISITED = 4, REFINED = 8 };

// Table D.1: the zero-coding context from the significant neighbours.
// `orient` is the band: 0 LL, 1 HL (horizontally high-pass), 2 LH, 3 HH.
int zc_context(int h, int v, int d, int orient) {
  if (orient == 3) {
    const int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
    return hv >= 2 ? 2 : hv;
  }
  if (orient == 1) {  // HL: the roles of the horizontal and vertical neighbours swap
    const int t = h;
    h = v;
    v = t;
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d;
}

struct Block {
  int w, h, stride;
  std::vector<uint8_t> f;  // flags, a border of one sample on every side
  int32_t* out;            // w x h, row-major

  uint8_t* at(int x, int y) { return &f[(y + 1) * stride + x + 1]; }

  // significant neighbours: horizontal, vertical, diagonal counts
  void neighbours(int x, int y, int& h, int& v, int& d) {
    const uint8_t* p = at(x, y);
    h = (p[-1] & SIG) + (p[1] & SIG);
    v = (p[-stride] & SIG) + (p[stride] & SIG);
    d = (p[-stride - 1] & SIG) + (p[-stride + 1] & SIG) + (p[stride - 1] & SIG) +
        (p[stride + 1] & SIG);
  }

  bool any_neighbour(int x, int y) {
    const uint8_t* p = at(x, y);
    return ((p[-1] | p[1] | p[-stride] | p[stride] | p[-stride - 1] | p[-stride + 1] |
             p[stride - 1] | p[stride + 1]) & SIG) != 0;
  }

  // Table D.3: a neighbour's contribution to the sign context
  static int contribution(uint8_t f) { return (f & SIG) ? ((f & NEG) ? -1 : 1) : 0; }

  void decode_sign(MQ& mq, int x, int y, int32_t magnitude) {
    const uint8_t* p = at(x, y);
    int hc = contribution(p[-1]) + contribution(p[1]);
    int vc = contribution(p[-stride]) + contribution(p[stride]);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    int flip = 0;
    if (hc < 0 || (hc == 0 && vc < 0)) {
      flip = 1;
      hc = -hc;
      vc = -vc;
    }
    const int cx = hc == 0 ? CTX_SC + vc : CTX_SC + 3 + vc;
    const int negative = mq.decode(cx) ^ flip;
    *at(x, y) |= SIG | (negative ? NEG : 0);
    out[y * w + x] = negative ? -magnitude : magnitude;
  }

  void significance_pass(MQ& mq, int orient, int32_t oneplushalf) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint8_t* p = at(x, y);
          if ((*p & SIG) || !any_neighbour(x, y)) continue;
          int hn, vn, dn;
          neighbours(x, y, hn, vn, dn);
          if (mq.decode(zc_context(hn, vn, dn, orient))) decode_sign(mq, x, y, oneplushalf);
          *p |= VISITED;
        }
  }

  void refinement_pass(MQ& mq, int32_t poshalf) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint8_t* p = at(x, y);
          if ((*p & (SIG | VISITED)) != SIG) continue;
          const int cx = (*p & REFINED) ? CTX_MAG + 2 : CTX_MAG + (any_neighbour(x, y) ? 1 : 0);
          const int bit = mq.decode(cx);
          int32_t& v = out[y * w + x];
          v += (bit ^ (v < 0)) ? poshalf : -poshalf;
          *p |= REFINED;
        }
  }

  void cleanup_sample(MQ& mq, int x, int y, int orient, int32_t oneplushalf) {
    uint8_t* p = at(x, y);
    if (*p & (SIG | VISITED)) return;
    int hn, vn, dn;
    neighbours(x, y, hn, vn, dn);
    if (mq.decode(zc_context(hn, vn, dn, orient))) decode_sign(mq, x, y, oneplushalf);
  }

  // the four samples of a stripe's column and their neighbours all insignificant
  bool run_eligible(int x, int y0) {
    for (int y = y0 - 1; y <= y0 + 4; ++y) {
      const uint8_t* p = at(x, y);
      const uint8_t own = (y >= y0 && y < y0 + 4) ? SIG | VISITED : SIG;
      if (((p[-1] | p[1]) & SIG) || (p[0] & own)) return false;
    }
    return true;
  }

  void cleanup_pass(MQ& mq, int orient, int32_t oneplushalf) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        if (y0 + 4 <= h && run_eligible(x, y0)) {
          if (!mq.decode(CTX_RL)) continue;
          int r = mq.decode(CTX_UNI) << 1;
          r |= mq.decode(CTX_UNI);
          y = y0 + r;
          decode_sign(mq, x, y, oneplushalf);
          ++y;
        }
        for (; y < y0 + 4 && y < h; ++y) cleanup_sample(mq, x, y, orient, oneplushalf);
      }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) *at(x, y) &= static_cast<uint8_t>(~VISITED);
  }
};

}  // namespace

extern "C" {

// Decode n_blocks code-blocks. meta holds 8 int64 a block: the offset and
// length of its data in `data` (its segments' bytes, all layers joined),
// its width and height, its band (0 LL, 1 HL, 2 LH, 3 HH), the number of
// its bit planes with the extra half bit (OpenJPEG's numbps), the number
// of coding passes to decode and the offset of its w x h int32 output in
// `out`. Returns 0, or -1 for a block of 31 or more bit planes.
int j2k_codeblocks(const uint8_t* data, int64_t n_blocks, const int64_t* meta, int32_t* out) {
  std::vector<uint8_t> buf;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t* m = meta + 8 * b;
    const int64_t len = m[1];
    Block blk;
    blk.w = static_cast<int>(m[2]);
    blk.h = static_cast<int>(m[3]);
    const int orient = static_cast<int>(m[4]);
    int bpno = static_cast<int>(m[5]);
    const int64_t passes = m[6];
    blk.out = out + m[7];
    std::memset(blk.out, 0, sizeof(int32_t) * blk.w * blk.h);
    if (bpno >= 31) return -1;
    if (passes <= 0 || bpno < 1) continue;
    blk.stride = blk.w + 2;
    blk.f.assign(static_cast<size_t>(blk.stride) * (blk.h + 2), 0);
    buf.assign(data + m[0], data + m[0] + len);
    buf.push_back(0xFF);  // the marker OpenJPEG puts after every block's data
    buf.push_back(0xFF);
    MQ mq;
    mq.init(buf.data(), len);
    int kind = 2;  // 0 significance propagation, 1 refinement, 2 cleanup; the first pass cleans up
    for (int64_t p = 0; p < passes && bpno >= 1; ++p) {
      const int32_t one = 1 << bpno, half = one >> 1;
      if (kind == 0)
        blk.significance_pass(mq, orient, one | half);
      else if (kind == 1)
        blk.refinement_pass(mq, half);
      else
        blk.cleanup_pass(mq, orient, one | half);
      if (++kind == 3) {
        kind = 0;
        --bpno;
      }
    }
  }
  return 0;
}

}  // extern "C"
