// The in-loop filters of an AV1 key frame with 8-bit samples (specification
// 7.14-7.17; names follow it), run by csrc/av1_intra.cpp once the tile data
// is decoded, in the specification's order:
//
// - the deblocking filter (7.14) on CurrFrame in place: for each plane all
//   vertical edges, then all horizontal ones; an edge is a transform edge
//   of the plane (LoopfilterTxSizes) whose position lies in the frame
//   (FrameWidth x FrameHeight), filtered with 4, 8 or 14 taps on luma and
//   4 or 6 on chroma by the smaller transform of its two sides;
// - CDEF (7.15) from a copy of the deblocked frame into CurrFrame, per 8x8
//   block of each 64x64 with a cdef_idx, skipped where its four 4x4s are;
//   samples outside the MI area (MiRows x MiCols) are unavailable, tile
//   edges are not edges;
// - loop restoration (7.17), Wiener or self-guided per restoration unit,
//   from the CDEF output in 64-row stripes (offset by 8 luma rows) whose
//   rows beyond the stripe come from the deblocked frame, clamped to the
//   cropped plane, into CurrFrame.
//
// Every block of a key frame is intra, and a lossy frame with segmentation
// or delta lf is refused before its tile data (utils/avif.py tool_refusal),
// so one filter level holds for each plane and direction: the frame's
// level plus, where loop_filter_delta_enabled, the INTRA_FRAME ref delta.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

#include "av1_tables.h"

namespace av1lf {

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

// the filters' counters, from the decoder's first filter slot
enum {
    F_DEBLOCK_Y = 0,     // 3 entries: luma edges of 4 samples filtered with 4, 8 and 14 taps
    F_DEBLOCK_UV = 3,    // 2 entries: chroma edges of 4 samples filtered with 4 and 6 taps
    F_CDEF_Y = 5,        // luma 8x8 blocks CDEF filters (a non-zero strength)
    F_CDEF_UV = 6,       // chroma 8x8 blocks (of one plane each) CDEF filters
    F_CDEF_SKIPPED = 7,  // 64x64 blocks whose cdef_idx is -1
    F_LR_WIENER = 8,     // restoration units of type RESTORE_WIENER
    F_LR_SGRPROJ = 9,    // restoration units of type RESTORE_SGRPROJ
    F_LR_SGR_R0 = 10,    // of those, units whose Sgr_Params set has r0 = 0
    F_LR_SGR_R1 = 11,    // of those, units whose Sgr_Params set has r1 = 0
    F_COUNT = 12
};

struct LrUnit {
    uint8_t type = RESTORE_NONE, set = 0;  // LrType, LrSgrSet
    int8_t wiener[2][3] = {};              // LrWiener: [0] vertical, [1] horizontal
    int16_t xqd[2] = {};                   // LrSgrXqd
};

struct Params {
    int levels[4], sharpness, delta_enabled, ref_delta_intra;  // loop_filter_level[0..3], ...
    int cdef_on, cdef_damping, cdef[8][4];  // cdef_y_pri, cdef_y_sec, cdef_uv_pri, cdef_uv_sec
    int lr_type[3];                         // FrameRestorationType
};

// what the filters read of the decoded frame
struct Frame {
    int width, height, mi_rows, mi_cols, num_planes, ssx, ssy;
    uint8_t* planes[3];  // CurrFrame: the MI area from (0, 0), padded right and below
    int stride[3];
    const uint8_t* skips;                    // Skips, MiCols a row
    const uint8_t* tx_sizes[3];              // LoopfilterTxSizes, per 4x4 of each plane
    int tx_stride[3];
    const int* tx_width;                     // Tx_Width, Tx_Height
    const int* tx_height;
    const int8_t* cdef_idx;                  // per 64x64
    int cdef_stride;
    const LrUnit* lr_units[3];               // unit_rows x unit_cols of each plane
    int lr_rows[3], lr_cols[3], lr_size[3];  // and LoopRestorationSize
    int64_t* counters;                       // F_COUNT

    uint8_t& px(int pl, int y, int x) { return planes[pl][(int64_t)y * stride[pl] + x]; }
    int sub_x(int pl) const { return pl ? ssx : 0; }
    int sub_y(int pl) const { return pl ? ssy : 0; }
};

inline int clip3(int lo, int hi, int x) { return x < lo ? lo : x > hi ? hi : x; }
inline int round2_64(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + (1LL << (n - 1))) >> n); }
inline int floor_log2(int x) {
    int s = 0;
    while (x > 1) { x >>= 1; s++; }
    return s;
}

// ---- deblocking (7.14) ----------------------------------------------------------------------

// the level of a plane's edges in one direction (7.14.4, 7.14.5)
inline int filter_level(const Params& f, int plane, int pass) {
    int base = f.levels[plane == 0 ? pass : plane + 1];
    if (!f.delta_enabled) return base;
    return clip3(0, 63, base + f.ref_delta_intra * (1 << (base >> 5)));
}

// the sample filtering process (7.14.6) across the edge before (x, y), in direction (dx, dy)
inline void sample_filter(Frame& fr, int pl, int x, int y, int limit, int blimit, int thresh,
                          int dx, int dy, int filter_size) {
    auto at = [&](int k) -> uint8_t& { return fr.px(pl, y + dy * k, x + dx * k); };
    const int q0 = at(0), q1 = at(1), p0 = at(-1), p1 = at(-2);
    const int len = filter_size == 4 ? 4 : pl ? 6 : filter_size == 8 ? 8 : 16;
    const int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    bool mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
                std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    int p2 = 0, q2 = 0, p3 = 0, q3 = 0;
    if (len >= 6) {
        p2 = at(-3);
        q2 = at(2);
        mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    }
    if (len >= 8) {
        p3 = at(-4);
        q3 = at(3);
        mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
    }
    if (!mask) return;
    bool flat = false, flat2 = false;
    if (filter_size >= 8) {
        flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
               std::abs(q2 - q0) <= 1;
        if (len >= 8) flat = flat && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
    }
    if (filter_size >= 16) {
        flat2 = true;
        for (int k = 4; k <= 6; k++)
            flat2 = flat2 && std::abs(at(-k - 1) - p0) <= 1 && std::abs(at(k) - q0) <= 1;
    }
    if (filter_size == 4 || !flat) {  // the narrow filter (7.14.6.3)
        auto c = [](int v) { return clip3(-128, 127, v); };
        int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
        int filter = hev ? c(ps1 - qs1) : 0;
        filter = c(filter + 3 * (qs0 - ps0));
        int filter1 = c(filter + 4) >> 3, filter2 = c(filter + 3) >> 3;
        at(0) = (uint8_t)(c(qs0 - filter1) + 128);
        at(-1) = (uint8_t)(c(ps0 + filter2) + 128);
        if (!hev) {
            filter = (filter1 + 1) >> 1;  // Round2(filter1, 1)
            at(1) = (uint8_t)(c(qs1 - filter) + 128);
            at(-2) = (uint8_t)(c(ps1 + filter) + 128);
        }
        return;
    }
    // the wide filter (7.14.6.4)
    const int log2 = filter_size == 8 || !flat2 ? 3 : 4;
    const int n = log2 == 4 ? 6 : pl == 0 ? 3 : 2;
    const int n2 = log2 == 3 && pl == 0 ? 0 : 1;
    int in[14], out[12];
    for (int k = -(n + 1); k <= n; k++) in[k + n + 1] = at(k);
    for (int i = -n; i < n; i++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
            int p = clip3(-(n + 1), n, i + j);
            t += in[p + n + 1] * (std::abs(j) <= n2 ? 2 : 1);
        }
        out[i + n] = (t + (1 << (log2 - 1))) >> log2;
    }
    for (int i = -n; i < n; i++) at(i) = (uint8_t)out[i + n];
}

inline void deblock(Frame& fr, const Params& f) {
    if (!f.levels[0] && !f.levels[1]) return;
    for (int pl = 0; pl < fr.num_planes; pl++) {
        if (pl && !f.levels[pl + 1]) continue;
        const int sx = fr.sub_x(pl), sy = fr.sub_y(pl);
        const uint8_t* txs = fr.tx_sizes[pl];
        const int ts = fr.tx_stride[pl];
        for (int pass = 0; pass < 2; pass++) {
            const int lvl = filter_level(f, pl, pass);
            if (!lvl) continue;
            const int shift = f.sharpness > 4 ? 2 : f.sharpness > 0 ? 1 : 0;
            const int limit = f.sharpness > 0 ? clip3(1, 9 - f.sharpness, lvl >> shift)
                                              : std::max(1, lvl >> shift);
            const int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
            const int dx = pass == 0, dy = pass == 1;
            for (int row = 0; row < fr.mi_rows; row += 1 << sy)
                for (int col = 0; col < fr.mi_cols; col += 1 << sx) {
                    const int x = col * 4, y = row * 4;  // onScreen
                    if (x >= fr.width || y >= fr.height || (dx && x == 0) || (dy && y == 0))
                        continue;
                    const int xp = x >> sx, yp = y >> sy;
                    const int tx = txs[(yp >> 2) * ts + (xp >> 2)];
                    const int prev = txs[((yp >> 2) - dy) * ts + (xp >> 2) - dx];
                    const int size = dx ? fr.tx_width[tx] : fr.tx_height[tx];
                    if ((dx ? xp : yp) % size) continue;  // not a transform edge
                    const int base = std::min(size, dx ? fr.tx_width[prev] : fr.tx_height[prev]);
                    const int filter_size = std::min(pl == 0 ? 16 : 8, base);
                    if (pl == 0) fr.counters[F_DEBLOCK_Y + (filter_size == 4 ? 0 : filter_size == 8 ? 1 : 2)]++;
                    else fr.counters[F_DEBLOCK_UV + (filter_size == 8)]++;
                    for (int i = 0; i < 4; i++)
                        sample_filter(fr, pl, xp + dy * i, yp + dx * i, limit, blimit, thresh, dx,
                                      dy, filter_size);
                }
        }
    }
}

// ---- CDEF (7.15) ----------------------------------------------------------------------------

struct Cdef {
    Frame& fr;
    const Params& f;
    const std::vector<uint8_t>* src;  // CurrFrame: the deblocked planes, strided as fr's

    int at(int pl, int y, int x) const { return src[pl][(int64_t)y * fr.stride[pl] + x]; }

    // the CDEF direction process (7.15.2) of the luma 8x8 at MI (r, c)
    void direction(int r, int c, int* y_dir, int* var) const {
        int cost[8] = {0}, partial[8][15] = {{0}};
        const int x0 = c * 4, y0 = r * 4;
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
                int x = at(0, y0 + i, x0 + j) - 128;
                partial[0][i + j] += x;
                partial[1][i + j / 2] += x;
                partial[2][i] += x;
                partial[3][3 + i - j / 2] += x;
                partial[4][7 + i - j] += x;
                partial[5][3 - i / 2 + j] += x;
                partial[6][j] += x;
                partial[7][i / 2 + j] += x;
            }
        for (int i = 0; i < 8; i++) {
            cost[2] += partial[2][i] * partial[2][i];
            cost[6] += partial[6][i] * partial[6][i];
        }
        cost[2] *= Div_Table[8];
        cost[6] *= Div_Table[8];
        for (int i = 0; i < 7; i++) {
            cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) *
                       Div_Table[i + 1];
            cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) *
                       Div_Table[i + 1];
        }
        cost[0] += partial[0][7] * partial[0][7] * Div_Table[8];
        cost[4] += partial[4][7] * partial[4][7] * Div_Table[8];
        for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
            cost[i] *= Div_Table[8];
            for (int j = 0; j < 3; j++)
                cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                           Div_Table[2 * j + 2];
        }
        int best_cost = 0;
        *y_dir = 0;
        for (int i = 0; i < 8; i++)
            if (cost[i] > best_cost) {
                best_cost = cost[i];
                *y_dir = i;
            }
        *var = (best_cost - cost[(*y_dir + 4) & 7]) >> 10;
    }

    // constrain() with Max(0, damping - FloorLog2(threshold)) given as `shift`
    static int constrain(int diff, int threshold, int shift) {
        if (!threshold) return 0;
        int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> shift)));
        return diff < 0 ? -val : val;
    }

    // the CDEF filter process (7.15.3) of one plane's part of the 8x8 at MI (r, c)
    void filter(int pl, int r, int c, int pri, int sec, int damping, int dir) {
        const int sx = fr.sub_x(pl), sy = fr.sub_y(pl);
        const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
        const int end_x = (fr.mi_cols * 4) >> sx, end_y = (fr.mi_rows * 4) >> sy;
        // the block and 2 samples around it, -1 where is_inside_filter_region says no
        int win[12 * 12];
        for (int i = -2; i < h + 2; i++)
            for (int j = -2; j < w + 2; j++) {
                int y = y0 + i, x = x0 + j;
                win[(i + 2) * 12 + j + 2] =
                    y < 0 || y >= end_y || x < 0 || x >= end_x ? -1 : at(pl, y, x);
            }
        // the 12 taps: 4 primary (k = 0, 1 on either side), 8 secondary (dir -+ 2)
        int offset[12], weight[12], strength[12], shift[12], n = 0;
        const int pri_shift = pri ? std::max(0, damping - floor_log2(pri)) : 0;
        const int sec_shift = sec ? std::max(0, damping - floor_log2(sec)) : 0;
        const int pri_tap = pri & 1;  // Cdef_Pri_Taps[(priStr >> coeffShift) & 1]
        for (int k = 0; k < 2; k++)
            for (int sign = -1; sign <= 1; sign += 2)
                for (int t = 0; t < 3; t++) {
                    const bool primary = t == 0;
                    const int d = primary ? dir : (dir + (t == 1 ? -2 : 2)) & 7;
                    offset[n] = sign * (Cdef_Directions[d][k][0] * 12 + Cdef_Directions[d][k][1]);
                    weight[n] = primary ? Cdef_Pri_Taps[pri_tap][k] : Cdef_Sec_Taps[pri_tap][k];
                    strength[n] = primary ? pri : sec;
                    shift[n] = primary ? pri_shift : sec_shift;
                    n++;
                }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                const int* c = win + (i + 2) * 12 + j + 2;
                const int x = c[0];
                int sum = 0, mx = x, mn = x;
                for (int t = 0; t < 12; t++) {
                    const int p = c[offset[t]];
                    if (p < 0) continue;  // CdefAvailable 0
                    sum += weight[t] * constrain(p - x, strength[t], shift[t]);
                    mx = std::max(p, mx);
                    mn = std::min(p, mn);
                }
                fr.px(pl, y0 + i, x0 + j) = (uint8_t)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
            }
    }

    // the CDEF block process (7.15.1) of the 8x8 at MI (r, c)
    void block(int r, int c, int idx) {
        int y_dir, var;
        direction(r, c, &y_dir, &var);
        int pri = f.cdef[idx][0], sec = f.cdef[idx][1];
        sec += sec == 3;
        const int dir = pri ? y_dir : 0;
        const int var_str = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
        pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
        if (pri || sec) {
            filter(0, r, c, pri, sec, f.cdef_damping, dir);
            fr.counters[F_CDEF_Y]++;
        }
        if (fr.num_planes == 1) return;
        pri = f.cdef[idx][2];
        sec = f.cdef[idx][3];
        sec += sec == 3;
        if (!pri && !sec) return;
        const int uv_dir = pri ? Cdef_Uv_Dir[fr.ssx][fr.ssy][y_dir] : 0;
        for (int pl = 1; pl < 3; pl++) {
            filter(pl, r, c, pri, sec, f.cdef_damping - 1, uv_dir);
            fr.counters[F_CDEF_UV]++;
        }
    }

    void run() {
        for (int fbr = 0; fbr < fr.mi_rows; fbr += 16)
            for (int fbc = 0; fbc < fr.mi_cols; fbc += 16) {
                const int idx = fr.cdef_idx[(fbr >> 4) * fr.cdef_stride + (fbc >> 4)];
                if (idx == -1) {
                    fr.counters[F_CDEF_SKIPPED]++;
                    continue;
                }
                for (int r = fbr; r < std::min(fbr + 16, fr.mi_rows); r += 2)
                    for (int c = fbc; c < std::min(fbc + 16, fr.mi_cols); c += 2) {
                        const uint8_t* s = fr.skips + (int64_t)r * fr.mi_cols + c;
                        if (s[0] && s[1] && s[fr.mi_cols] && s[fr.mi_cols + 1]) continue;
                        block(r, c, idx);
                    }
            }
    }
};

// ---- loop restoration (7.17) ----------------------------------------------------------------

struct Restoration {
    Frame& fr;
    const std::vector<uint8_t>* deblocked;  // UpscaledCurrFrame
    const std::vector<uint8_t>* cdef;       // UpscaledCdefFrame (strided as fr's planes)
    int pl = 0, plane_w = 0, plane_h = 0, stripe_start = 0, stripe_end = 0;
    std::vector<int> patch, inter, box_a, box_b, col_a, col_b, flt[2];

    // get_source_sample
    int sample(int y, int x) const {
        x = clip3(0, plane_w - 1, x);
        y = clip3(0, plane_h - 1, y);
        const int64_t s = fr.stride[pl];
        if (y < stripe_start) return deblocked[pl][std::max(stripe_start - 2, y) * s + x];
        if (y > stripe_end) return deblocked[pl][std::min(stripe_end + 2, y) * s + x];
        return cdef[pl][y * s + x];
    }

    int source(int y, int x) const { return cdef[pl][(int64_t)y * fr.stride[pl] + x]; }

    // the samples of the w x h area at (x0, y0) and 3 around it, as get_source_sample reads them
    void fill_patch(int x0, int y0, int w, int h) {
        patch.resize((size_t)(h + 6) * (w + 6));
        for (int i = 0; i < h + 6; i++)
            for (int j = 0; j < w + 6; j++) patch[i * (w + 6) + j] = sample(y0 + i - 3, x0 + j - 3);
    }

    // the Wiener filter process (7.17.4)
    void wiener(const LrUnit& u, int x0, int y0, int w, int h, uint8_t* out) {
        int vf[7], hf[7];
        for (int pass = 0; pass < 2; pass++) {  // get_filter
            int* filter = pass ? hf : vf;
            filter[3] = 128;
            for (int i = 0; i < 3; i++) {
                filter[i] = filter[6 - i] = u.wiener[pass][i];
                filter[3] -= 2 * u.wiener[pass][i];
            }
        }
        const int offset = 1 << (8 + 7 - 3 - 1), limit = (1 << (8 + 1 + 7 - 3)) - 1;
        const int pw = w + 6;
        inter.resize((size_t)(h + 6) * w);
        for (int r = 0; r < h + 6; r++)
            for (int c = 0; c < w; c++) {
                int s = 0;
                for (int t = 0; t < 7; t++) s += hf[t] * patch[r * pw + c + t];
                inter[r * w + c] = clip3(-offset, limit - offset, round2_64(s, 3));
            }
        const int64_t stride = fr.stride[pl];
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int s = 0;
                for (int t = 0; t < 7; t++) s += vf[t] * inter[(r + t) * w + c];
                out[(y0 + r) * stride + x0 + c] = (uint8_t)clip3(0, 255, round2_64(s, 11));
            }
    }

    // the box filter process (7.17.3) of pass `pass` with radius r -> flt[pass]
    void box_filter(int w, int h, int r, int eps, int pass, int x0, int y0) {
        const int n = (2 * r + 1) * (2 * r + 1), n2e = n * n * eps;
        const int64_t s = ((1 << 20) + n2e / 2) / n2e;
        const int one_over_n = ((1 << 12) + n / 2) / n;
        const int pw = w + 6, bw = w + 2;
        box_a.resize((size_t)(h + 2) * bw);
        box_b.resize((size_t)(h + 2) * bw);
        col_a.resize(pw);
        col_b.resize(pw);
        for (int i = -1; i < h + 1; i++) {
            if (pass == 0 && !(i & 1)) continue;  // pass 0 weighs only A and B of odd rows
            for (int jj = 0; jj < pw; jj++) {  // the window's columns, summed down
                int sa = 0, sb = 0;
                for (int dy = -r; dy <= r; dy++) {
                    int c = patch[(i + 3 + dy) * pw + jj];
                    sa += c * c;
                    sb += c;
                }
                col_a[jj] = sa;
                col_b[jj] = sb;
            }
            for (int j = -1; j < w + 1; j++) {
                int64_t a = 0;
                int b = 0;
                for (int dx = -r; dx <= r; dx++) {
                    a += col_a[j + 3 + dx];
                    b += col_b[j + 3 + dx];
                }
                const int64_t p = std::max<int64_t>(0, a * n - (int64_t)b * b);
                const int64_t z = (p * s + (1 << 19)) >> 20;
                const int a2 = Sgr_X_By_Xplus1[std::min<int64_t>(z, 255)];
                const int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
                box_a[(i + 1) * bw + j + 1] = a2;
                box_b[(i + 1) * bw + j + 1] = round2_64(b2, 12);
            }
        }
        flt[pass].resize((size_t)h * w);
        for (int i = 0; i < h; i++) {
            const int shift = pass == 0 && (i & 1) ? 4 : 5;
            for (int j = 0; j < w; j++) {
                int64_t a = 0, b = 0;
                for (int dy = -1; dy <= 1; dy++)
                    for (int dx = -1; dx <= 1; dx++) {
                        int weight;
                        if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                        else weight = dx == 0 || dy == 0 ? 4 : 3;
                        if (!weight) continue;
                        a += weight * box_a[(i + 1 + dy) * bw + j + 1 + dx];
                        b += weight * box_b[(i + 1 + dy) * bw + j + 1 + dx];
                    }
                const int64_t v = a * source(y0 + i, x0 + j) + b;
                flt[pass][i * w + j] = round2_64(v, 8 + shift - 4);
            }
        }
    }

    // the self guided filter process (7.17.2)
    void self_guided(const LrUnit& u, int x0, int y0, int w, int h, uint8_t* out) {
        const int16_t* sp = Sgr_Params[u.set];
        const int r0 = sp[0], r1 = sp[2];
        if (r0) box_filter(w, h, r0, sp[1], 0, x0, y0);
        if (r1) box_filter(w, h, r1, sp[3], 1, x0, y0);
        const int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << 7) - w0 - w1;
        const int64_t stride = fr.stride[pl];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                const int64_t px = source(y0 + i, x0 + j) << 4;
                int64_t v = w1 * px;
                v += r0 ? (int64_t)w0 * flt[0][i * w + j] : w0 * px;
                v += r1 ? (int64_t)w2 * flt[1][i * w + j] : w2 * px;
                out[(y0 + i) * stride + x0 + j] = (uint8_t)clip3(0, 255, round2_64(v, 4 + 7));
            }
    }

    // every unit of every plane, stripe by stripe, into the planes
    void run(const Params& f) {
        for (pl = 0; pl < fr.num_planes; pl++) {
            if (f.lr_type[pl] == RESTORE_NONE) continue;
            const int sx = fr.sub_x(pl), sy = fr.sub_y(pl);
            const int unit = fr.lr_size[pl], rows = fr.lr_rows[pl], cols = fr.lr_cols[pl];
            plane_w = (fr.width + sx) >> sx;
            plane_h = (fr.height + sy) >> sy;
            const int offset = 8 >> sy, height = 64 >> sy;
            for (int s0 = -offset; s0 < plane_h; s0 += height) {
                stripe_start = s0;
                stripe_end = s0 + height - 1;
                const int y0 = std::max(0, s0), h = std::min(plane_h, s0 + height) - y0;
                const int unit_row = std::min(rows - 1, (y0 + offset) / unit);
                for (int uc = 0; uc < cols; uc++) {
                    const LrUnit& u = fr.lr_units[pl][unit_row * cols + uc];
                    if (u.type == RESTORE_NONE) continue;
                    const int x0 = uc * unit;
                    const int w = (uc == cols - 1 ? plane_w : std::min(plane_w, x0 + unit)) - x0;
                    fill_patch(x0, y0, w, h);
                    if (u.type == RESTORE_WIENER) wiener(u, x0, y0, w, h, fr.planes[pl]);
                    else self_guided(u, x0, y0, w, h, fr.planes[pl]);
                }
            }
        }
    }
};

// deblocking, then CDEF, then loop restoration
inline void filter_frame(Frame& fr, const Params& f) {
    deblock(fr, f);
    const bool restore = f.lr_type[0] || (fr.num_planes > 1 && (f.lr_type[1] || f.lr_type[2]));
    if (!f.cdef_on && !restore) return;
    std::vector<uint8_t> deblocked[3], cdef[3];
    for (int pl = 0; pl < fr.num_planes; pl++) {
        size_t n = (size_t)fr.stride[pl] * ((fr.mi_rows * 4 >> fr.sub_y(pl)) + 160);
        deblocked[pl].assign(fr.planes[pl], fr.planes[pl] + n);
    }
    if (f.cdef_on) Cdef{fr, f, deblocked}.run();
    if (!restore) return;
    for (int pl = 0; pl < fr.num_planes; pl++)
        cdef[pl].assign(fr.planes[pl], fr.planes[pl] + deblocked[pl].size());
    Restoration{fr, deblocked, cdef}.run(f);
}

}  // namespace av1lf
