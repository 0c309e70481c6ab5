// The inverse transforms of AV1 (specification 7.13.2-7.13.3) for 8-bit
// samples, as csrc/av1_intra.cpp reconstructs lossy transform blocks: the
// DCT of 4-64 points, the ADST of 4 (its sinpi form), 8 and 16 points, the
// flipped ADST and the identity of 4-32 points, and the 2-D process (the
// 2:1 rectangular pre-scale, the row shift, the column pass and the final
// Round2(x, 4) added to the prediction).
//
// Every rotation is the specification's butterfly B: Round2 of the two
// products' sum by 12 bits, with cos128 of Cos128_Lookup. Every output of
// a rotation, and every sum or difference of a stage, is clamped to 16
// bits, and so is the row pass's output after its shift: for 8-bit samples
// dav1d 1.5.1 keeps its transforms in 16-bit lanes and saturates each of
// these, so where a bitstream breaks the range rule (a coefficient at the
// dequantiser's clamp, say) the pixels are still dav1d's. Its x86 code
// wraps some rotations to 16 bits instead, and so does this file: in each
// DCT's odd half the rotations between its input rotations and its last
// (by 32) stage (but in a 32x32 transform), and in the 8- and 16-point
// ADSTs the rotations after the first sums (each found by editing tile
// data against Pillow's decode on an x86 host; tests/test_torch_av1_lossy.py).

#pragma once

#include <algorithm>
#include <cstdint>

#include "av1_tables.h"

namespace av1itx {

enum {
    DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
    ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { T_DCT, T_ADST, T_FLIPADST, T_IDENTITY };

// the vertical (column) and horizontal (row) 1-D transform of each TxType
const uint8_t Col_Type[16] = {T_DCT, T_ADST, T_DCT, T_ADST, T_FLIPADST, T_DCT, T_FLIPADST,
                              T_ADST, T_FLIPADST, T_IDENTITY, T_DCT, T_IDENTITY, T_ADST,
                              T_IDENTITY, T_FLIPADST, T_IDENTITY};
const uint8_t Row_Type[16] = {T_DCT, T_DCT, T_ADST, T_ADST, T_DCT, T_FLIPADST, T_FLIPADST,
                              T_FLIPADST, T_ADST, T_IDENTITY, T_IDENTITY, T_DCT, T_IDENTITY,
                              T_ADST, T_IDENTITY, T_FLIPADST};

inline int clamp16(int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; }
inline int wrap16(int v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline int cos128(int a) { return Cos128_Lookup[a]; }
inline int sin128(int a) { return Cos128_Lookup[64 - a]; }
// the butterfly's one output: Round2(w0 * a + w1 * b, 12), saturated to 16 bits, or
// wrapped where dav1d wraps it
inline int bf(int w0, int a, int w1, int b) { return clamp16((w0 * a + w1 * b + 2048) >> 12); }
inline int bf_wrap(int w0, int a, int w1, int b) { return wrap16((w0 * a + w1 * b + 2048) >> 12); }

inline int brev(int bits, int x) {
    int r = 0;
    for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
    return r;
}
inline int log2i(int n) {
    int s = 0;
    while ((1 << s) < n) s++;
    return s;
}

// The odd half of an n-point inverse DCT on o[0..m-1] (m = n / 2, the odd
// inputs in bit-reversed order): the rotations of the input pairs, then for
// groups of 2, 4, ..., m / 2 the sums and differences within each group
// followed by the rotations of the pairs about the middle that the next
// smaller DCT's odd half rotates.
inline void dct_odd(int* o, int m, int n, bool wrap_middle) {
    int half = m / 2;
    int bits = log2i(half);
    for (int j = 0; j < half; j++) {
        int phi = 64 - (64 / n) * (1 + 4 * brev(bits, j));
        int a = o[j], b = o[m - 1 - j];
        o[j] = bf(cos128(phi), a, -sin128(phi), b);
        o[m - 1 - j] = bf(sin128(phi), a, cos128(phi), b);
    }
    for (int g = 2; g <= m / 2; g *= 2) {
        for (int base = 0, k = 0; base < m; base += g, k++)
            for (int j = 0; j < g / 2; j++) {
                int x = o[base + j], y = o[base + g - 1 - j];
                if (k & 1) {
                    o[base + j] = clamp16(y - x);
                    o[base + g - 1 - j] = clamp16(y + x);
                } else {
                    o[base + j] = clamp16(x + y);
                    o[base + g - 1 - j] = clamp16(x - y);
                }
            }
        int np = m / g;  // the smaller DCT whose odd-half rotations these are
        auto rot = np != 2 && wrap_middle ? bf_wrap : bf;
        for (int i = 0; i < m / 2; i++) {
            int p = i % (2 * g);
            if (p < g / 2 || p >= 3 * g / 2) continue;
            int phi = np == 2 ? 32
                              : 64 - (64 / np) * (1 + 4 * brev(log2i(np / 4), i / (2 * g)));
            int a = o[i], b = o[m - 1 - i];
            if (p < g) {
                o[i] = rot(-sin128(phi), a, cos128(phi), b);
                o[m - 1 - i] = rot(cos128(phi), a, sin128(phi), b);
            } else {
                o[i] = rot(-cos128(phi), a, -sin128(phi), b);
                o[m - 1 - i] = rot(-sin128(phi), a, cos128(phi), b);
            }
        }
    }
}

// an n-point inverse DCT on t[] in the bit-reversed order (7.13.2.3);
// wrap_middle: the odd halves' rotations between the input ones and the
// last stage wrap
inline void dct_core(int* t, int n, bool wrap_middle) {
    if (n == 2) {
        int a = t[0], b = t[1];
        t[0] = bf(cos128(32), a, sin128(32), b);
        t[1] = bf(sin128(32), a, -cos128(32), b);
        return;
    }
    int m = n / 2;
    dct_core(t, m, wrap_middle);
    dct_odd(t + m, m, n, wrap_middle);
    int e[32], o[32];
    for (int k = 0; k < m; k++) {
        e[k] = t[k];
        o[k] = t[m + k];
    }
    for (int k = 0; k < m; k++) {
        t[k] = clamp16(e[k] + o[m - 1 - k]);
        t[n - 1 - k] = clamp16(e[k] - o[m - 1 - k]);
    }
}

inline void inverse_dct(int* x, int n, bool wrap_middle) {
    int t[64], bits = log2i(n);
    for (int i = 0; i < n; i++) t[i] = x[brev(bits, i)];
    dct_core(t, n, wrap_middle);
    for (int i = 0; i < n; i++) x[i] = t[i];
}

// 7.13.2.6: the 4-point ADST through its sinpi constants
inline void inverse_adst4(int* x) {
    const int s1 = 1321, s2 = 2482, s3 = 3344, s4 = 3803;
    int x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    int a0 = s1 * x0 + s4 * x2 + s2 * x3;
    int a1 = s2 * x0 - s1 * x2 - s4 * x3;
    int a3 = s3 * x1;
    x[0] = clamp16((a0 + a3 + 2048) >> 12);
    x[1] = clamp16((a1 + a3 + 2048) >> 12);
    x[2] = clamp16((s3 * (x0 - x2 + x3) + 2048) >> 12);
    x[3] = clamp16((a0 + a1 - a3 + 2048) >> 12);
}

// 7.13.2.7: the 8-point ADST
inline void inverse_adst8(int* x) {
    int b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
    int s[8];
    for (int i = 0; i < 4; i++) {
        int phi = 4 + 16 * i;
        s[2 * i] = bf(cos128(phi), b[2 * i], sin128(phi), b[2 * i + 1]);
        s[2 * i + 1] = bf(sin128(phi), b[2 * i], -cos128(phi), b[2 * i + 1]);
    }
    for (int i = 0; i < 4; i++) {
        b[i] = clamp16(s[i] + s[i + 4]);
        b[i + 4] = clamp16(s[i] - s[i + 4]);
    }
    s[4] = bf_wrap(cos128(16), b[4], sin128(16), b[5]);
    s[5] = bf_wrap(sin128(16), b[4], -cos128(16), b[5]);
    s[6] = bf_wrap(-sin128(16), b[6], cos128(16), b[7]);
    s[7] = bf_wrap(cos128(16), b[6], sin128(16), b[7]);
    s[0] = b[0], s[1] = b[1], s[2] = b[2], s[3] = b[3];
    b[0] = clamp16(s[0] + s[2]);
    b[1] = clamp16(s[1] + s[3]);
    b[2] = clamp16(s[0] - s[2]);
    b[3] = clamp16(s[1] - s[3]);
    b[4] = clamp16(s[4] + s[6]);
    b[5] = clamp16(s[5] + s[7]);
    b[6] = clamp16(s[4] - s[6]);
    b[7] = clamp16(s[5] - s[7]);
    int c2 = bf(cos128(32), b[2], cos128(32), b[3]), c3 = bf(cos128(32), b[2], -cos128(32), b[3]);
    int c6 = bf(cos128(32), b[6], cos128(32), b[7]), c7 = bf(cos128(32), b[6], -cos128(32), b[7]);
    x[0] = b[0];
    x[1] = -b[4];
    x[2] = c6;
    x[3] = -c2;
    x[4] = c3;
    x[5] = -c7;
    x[6] = b[5];
    x[7] = -b[1];
}

// 7.13.2.8: the 16-point ADST
inline void inverse_adst16(int* x) {
    int b[16], s[16];
    for (int i = 0; i < 8; i++) {
        b[2 * i] = x[15 - 2 * i];
        b[2 * i + 1] = x[2 * i];
    }
    for (int i = 0; i < 8; i++) {
        int phi = 2 + 8 * i;
        s[2 * i] = bf(cos128(phi), b[2 * i], sin128(phi), b[2 * i + 1]);
        s[2 * i + 1] = bf(sin128(phi), b[2 * i], -cos128(phi), b[2 * i + 1]);
    }
    for (int i = 0; i < 8; i++) {
        b[i] = clamp16(s[i] + s[i + 8]);
        b[i + 8] = clamp16(s[i] - s[i + 8]);
    }
    for (int i = 0; i < 8; i++) s[i] = b[i];
    s[8] = bf_wrap(cos128(8), b[8], sin128(8), b[9]);
    s[9] = bf_wrap(sin128(8), b[8], -cos128(8), b[9]);
    s[10] = bf_wrap(cos128(40), b[10], sin128(40), b[11]);
    s[11] = bf_wrap(sin128(40), b[10], -cos128(40), b[11]);
    s[12] = bf_wrap(-sin128(8), b[12], cos128(8), b[13]);
    s[13] = bf_wrap(cos128(8), b[12], sin128(8), b[13]);
    s[14] = bf_wrap(-sin128(40), b[14], cos128(40), b[15]);
    s[15] = bf_wrap(cos128(40), b[14], sin128(40), b[15]);
    for (int h = 0; h < 16; h += 8)
        for (int i = 0; i < 4; i++) {
            b[h + i] = clamp16(s[h + i] + s[h + i + 4]);
            b[h + i + 4] = clamp16(s[h + i] - s[h + i + 4]);
        }
    for (int h = 0; h < 16; h += 8) {
        s[h + 0] = b[h + 0], s[h + 1] = b[h + 1], s[h + 2] = b[h + 2], s[h + 3] = b[h + 3];
        s[h + 4] = bf_wrap(cos128(16), b[h + 4], sin128(16), b[h + 5]);
        s[h + 5] = bf_wrap(sin128(16), b[h + 4], -cos128(16), b[h + 5]);
        s[h + 6] = bf_wrap(-sin128(16), b[h + 6], cos128(16), b[h + 7]);
        s[h + 7] = bf_wrap(cos128(16), b[h + 6], sin128(16), b[h + 7]);
    }
    for (int h = 0; h < 16; h += 4) {
        b[h + 0] = clamp16(s[h + 0] + s[h + 2]);
        b[h + 1] = clamp16(s[h + 1] + s[h + 3]);
        b[h + 2] = clamp16(s[h + 0] - s[h + 2]);
        b[h + 3] = clamp16(s[h + 1] - s[h + 3]);
    }
    for (int h = 0; h < 16; h += 4) {
        int a = b[h + 2], c = b[h + 3];
        b[h + 2] = bf(cos128(32), a, cos128(32), c);
        b[h + 3] = bf(cos128(32), a, -cos128(32), c);
    }
    const int from[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; i++) x[i] = (i & 1) ? -b[from[i]] : b[from[i]];
}

// 7.13.2.15: the identity of n points
inline void inverse_identity(int* x, int n) {
    for (int i = 0; i < n; i++) {
        int v = x[i];
        if (n == 4) x[i] = v + ((v * 1697 + 2048) >> 12);   // Round2(v * 5793, 12)
        else if (n == 8) x[i] = v * 2;
        else if (n == 16) x[i] = 2 * v + ((v * 1697 + 1024) >> 11);  // Round2(v * 11586, 12)
        else x[i] = v * 4;
    }
}

inline void transform_1d(int* x, int n, int type, bool wrap_middle) {
    switch (type) {
        case T_DCT: inverse_dct(x, n, wrap_middle); break;
        case T_IDENTITY: inverse_identity(x, n); break;
        default:
            if (n == 4) inverse_adst4(x);
            else if (n == 8) inverse_adst8(x);
            else inverse_adst16(x);
            if (type == T_FLIPADST) std::reverse(x, x + n);
    }
}

// The 2-D inverse transform of one w x h block (7.13.3) added to the
// prediction at dst: dq holds the dequantised coefficients, Min(w, 32) a
// row, Min(h, 32) rows (a 64-point side codes its first 32 coefficients).
inline void inverse_transform_add(const int* dq, int w, int h, int row_shift, int tx_type,
                                  uint8_t* dst, int64_t stride) {
    static thread_local int res[64 * 64];
    int log2w = log2i(w), log2h = log2i(h);
    int tw = std::min(w, 32), th = std::min(h, 32);
    int rect2 = log2w - log2h == 1 || log2h - log2w == 1;
    int rnd = (1 << row_shift) >> 1;
    bool wrap_middle = !(w == 32 && h == 32);  // dav1d's 32x32 saturates them
    int t[64];
    for (int i = 0; i < h; i++) {
        for (int j = 0; j < w; j++) {
            int v = i < th && j < tw ? dq[i * tw + j] : 0;
            t[j] = rect2 ? (v * 181 + 128) >> 8 : v;  // Round2(v * 2896, 12)
        }
        transform_1d(t, w, Row_Type[tx_type], wrap_middle);
        for (int j = 0; j < w; j++) res[i * 64 + j] = clamp16((t[j] + rnd) >> row_shift);
    }
    for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) t[i] = res[i * 64 + j];
        transform_1d(t, h, Col_Type[tx_type], wrap_middle);
        for (int i = 0; i < h; i++) {
            int v = dst[i * stride + j] + ((t[i] + 8) >> 4);
            dst[i * stride + j] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

}  // namespace av1itx
