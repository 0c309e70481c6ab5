// The AV1 tile decoder of the AVIF reader (utils/avif.py): the tile data of
// one key frame, decoded as the AV1 specification decodes it (sections 5.11
// and 7.11-7.13; names follow it): the symbol decoder with CDF adaptation,
// partitions, intra frame mode info (skip, segment id, CDEF indices, y and
// uv modes, angle deltas, CfL alphas, palette and its colour cache and
// colour-index map, filter intra), intra block copy (its DV stack, default
// DV and read_mv), the transform size (tx_depth, and the var-tx tree of a
// block copy) and type (the intra and inter sets), the coefficients of
// every transform size, and reconstruction: the intra edges (availability,
// the edge filter, the corner filter and upsampling), every intra
// prediction mode, CfL, filter intra, palette, the block copy's bilinear
// prediction, dequantisation, and the inverse transforms (av1_itx.h; the
// Walsh-Hadamard transform where the frame is CodedLossless); and the loop
// restoration units' syntax (5.11.57-5.11.58). The in-loop filters then run
// on the whole frame (av1_filters.h: deblocking, CDEF, loop restoration).
//
// utils/avif.py refuses by name the frames whose tools this file lacks:
// superres, film grain, quantiser matrices, segmentation in a lossy frame,
// and delta q / lf.
//
// Where a bitstream breaks a rule the decoder cannot go on from, the call
// returns 1 with a message: a partition whose chroma block is invalid at
// 4:2:2, a tile whose symbols read more than 14 bits past its end, an intra
// block copy that no clamp takes out of the superblock being decoded (as
// dav1d 1.5.1, the decoder Pillow's libavif uses, refuses them). Where dav1d goes
// on, this decoder goes on as it does: reads past the end of a tile's data
// read zeros, an intra block copy's source is clamped to the decoded area as
// dav1d clamps it, and coefficients and transform stages out of range are
// clamped as dav1d clamps them.
//
// Built by g++ at first use (ops/_build.py compile_host), loaded by
// utils/_entropy.py av1_library().

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "av1_filters.h"
#include "av1_itx.h"
#include "av1_tables.h"

namespace {

struct Corrupt {
    std::string what;
};

enum {
    BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16,
    BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64,
    BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8,
    BLOCK_16X64, BLOCK_64X16, BLOCK_SIZES, BLOCK_INVALID = 22
};
const int Num_4x4_Blocks_Wide[BLOCK_SIZES] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8,
                                              16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const int Num_4x4_Blocks_High[BLOCK_SIZES] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16,
                                              8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const int Mi_Width_Log2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                        4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const int Mi_Height_Log2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                                         3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
// Subsampled_Size[bsize][subx][suby]
const int Subsampled_Size[BLOCK_SIZES][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};

enum {
    PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
    PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4
};
enum {
    DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
    SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED, INTRA_MODES = 13
};
const int Intra_Mode_Context[INTRA_MODES] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int Filter_Intra_Mode_To_Intra_Dir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};

enum {
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32,
    TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16,
    TX_SIZES_ALL
};
const int Tx_Width[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int Tx_Height[TX_SIZES_ALL] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int Tx_Width_Log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const int Tx_Height_Log2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const int Tx_Size_Sqr[TX_SIZES_ALL] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2};
const int Tx_Size_Sqr_Up[TX_SIZES_ALL] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4};
enum { TX_MODE_ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT };
enum { TX_SET_DCTONLY, TX_SET_1, TX_SET_2, TX_SET_3 };  // INTRA_1/2, INTER_1/2/3
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };

// the block of w4 x h4 4x4 units (square, half, quarter and 4:1 shapes)
int block_of(int w4, int h4) {
    for (int b = 0; b < BLOCK_SIZES; b++)
        if (Num_4x4_Blocks_Wide[b] == w4 && Num_4x4_Blocks_High[b] == h4) return b;
    return BLOCK_INVALID;
}

int floor_log2(uint32_t x) {
    int s = 0;
    while (x > 1) { x >>= 1; s++; }
    return s;
}

int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) { i++; p <<= 1; }
    return i;
}

inline int round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int clip1(int x) { return x < 0 ? 0 : x > 255 ? 255 : x; }

// ---- the counters the tests read ----------------------------------------------------------

enum {
    C_Y_MODE = 0,              // 13 entries: blocks of each y mode (intra blocks)
    C_ANGLE_DELTA = 13,        // blocks with a non-zero angle delta (y or uv)
    C_UPSAMPLED = 14,          // directional predictions with an upsampled edge
    C_FILTER_INTRA = 15,       // blocks with filter intra
    C_CFL = 16,                // blocks with CfL
    C_PALETTE_Y = 17,          // blocks with a luma palette
    C_PALETTE_UV = 18,         // blocks with a chroma palette
    C_INTRABC = 19,            // blocks predicted by intra block copy
    C_TILES = 20,              // tiles decoded
    C_EDGE_FILTER = 21,        // intra edges filtered with a non-zero strength
    C_BLOCKS = 22,             // blocks decoded
    C_PADDING = 23,            // tiles whose trailing bits break the padding rule
    C_UV_MODE = 24,            // 14 entries: blocks of each uv mode
    C_TX_SIZE = 38,            // 19 entries: transform blocks with coefficients, by size
    C_TX_TYPE = 57,            // 16 entries: transform blocks with coefficients, by type
    C_TX_DEPTH = 73,           // intra blocks whose tx_depth is above 0
    C_TXFM_SPLIT = 74,         // var-tx splits of block copies
    C_INTRABC_RESIDUAL = 75,   // block copies with a residual (lossy)
    C_CORNER_FILTER = 76,      // directional predictions with the corner filter
    C_FILTERS = 77,            // av1lf::F_COUNT entries: the in-loop filters (av1_filters.h)
    C_COUNT = C_FILTERS + av1lf::F_COUNT
};

// ---- the CDFs one tile adapts ---------------------------------------------------------------

struct Cdfs {
    uint16_t partition_w8[4][5], partition_w16[4][11], partition_w32[4][11],
        partition_w64[4][11], partition_w128[4][9];
    uint16_t y_mode[5][5][14], uv_no_cfl[13][14], uv_cfl[13][15], angle_delta[8][8];
    uint16_t intrabc[3], skip[3][3], filter_intra[22][3], filter_intra_mode[6];
    uint16_t cfl_sign[9], cfl_alpha[6][17];
    uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3], pal_y_size[7][8], pal_uv_size[7][8];
    uint16_t pal_color[2][7][5][9];
    uint16_t seg_id[3][9];
    uint16_t mv_joint[5], mv_class[2][12], mv_sign[2][3], mv_class0_bit[2][3],
        mv_class0_fr[2][2][5], mv_class0_hp[2][3], mv_bit[2][10][3], mv_fr[2][5], mv_hp[2][3];
    uint16_t txb_skip[5][13][3], eob_pt16[2][2][6], eob_pt32[2][2][7], eob_pt64[2][2][8],
        eob_pt128[2][2][9], eob_pt256[2][2][10], eob_pt512[2][11], eob_pt1024[2][12],
        eob_extra[5][2][9][3];
    uint16_t coeff_base_eob[5][2][4][4], coeff_base[5][2][41][5], coeff_br[4][2][21][5];
    uint16_t dc_sign[2][3][3];
    uint16_t tx_8x8[3][3], tx_16x16[3][4], tx_32x32[3][4], tx_64x64[3][4], txfm_split[21][3];
    uint16_t intra_tx_set1[2][13][8], intra_tx_set2[3][13][6];
    uint16_t inter_tx_set1[2][17], inter_tx_set2[13], inter_tx_set3[4][3];
    uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];

    void init(int qctx) {
        std::memcpy(partition_w8, Default_Partition_W8_Cdf, sizeof partition_w8);
        std::memcpy(partition_w16, Default_Partition_W16_Cdf, sizeof partition_w16);
        std::memcpy(partition_w32, Default_Partition_W32_Cdf, sizeof partition_w32);
        std::memcpy(partition_w64, Default_Partition_W64_Cdf, sizeof partition_w64);
        std::memcpy(partition_w128, Default_Partition_W128_Cdf, sizeof partition_w128);
        std::memcpy(y_mode, Default_Intra_Frame_Y_Mode_Cdf, sizeof y_mode);
        std::memcpy(uv_no_cfl, Default_Uv_Mode_Cfl_Not_Allowed_Cdf, sizeof uv_no_cfl);
        std::memcpy(uv_cfl, Default_Uv_Mode_Cfl_Allowed_Cdf, sizeof uv_cfl);
        std::memcpy(angle_delta, Default_Angle_Delta_Cdf, sizeof angle_delta);
        std::memcpy(intrabc, Default_Intrabc_Cdf, sizeof intrabc);
        std::memcpy(skip, Default_Skip_Cdf, sizeof skip);
        std::memcpy(filter_intra, Default_Filter_Intra_Cdfs, sizeof filter_intra);
        std::memcpy(filter_intra_mode, Default_Filter_Intra_Mode_Cdf, sizeof filter_intra_mode);
        std::memcpy(cfl_sign, Default_Cfl_Sign_Cdf, sizeof cfl_sign);
        std::memcpy(cfl_alpha, Default_Cfl_Alpha_Cdf, sizeof cfl_alpha);
        std::memcpy(pal_y_mode, Default_Palette_Y_Mode_Cdf, sizeof pal_y_mode);
        std::memcpy(pal_uv_mode, Default_Palette_Uv_Mode_Cdf, sizeof pal_uv_mode);
        std::memcpy(pal_y_size, Default_Palette_Y_Size_Cdf, sizeof pal_y_size);
        std::memcpy(pal_uv_size, Default_Palette_Uv_Size_Cdf, sizeof pal_uv_size);
        std::memset(pal_color, 0, sizeof pal_color);
        const uint16_t* colours[2][7] = {
            {&Default_Palette_Size_2_Y_Color_Cdf[0][0], &Default_Palette_Size_3_Y_Color_Cdf[0][0],
             &Default_Palette_Size_4_Y_Color_Cdf[0][0], &Default_Palette_Size_5_Y_Color_Cdf[0][0],
             &Default_Palette_Size_6_Y_Color_Cdf[0][0], &Default_Palette_Size_7_Y_Color_Cdf[0][0],
             &Default_Palette_Size_8_Y_Color_Cdf[0][0]},
            {&Default_Palette_Size_2_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_3_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_4_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_5_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_6_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_7_Uv_Color_Cdf[0][0],
             &Default_Palette_Size_8_Uv_Color_Cdf[0][0]}};
        for (int p = 0; p < 2; p++)
            for (int n = 2; n <= 8; n++)
                for (int c = 0; c < 5; c++)
                    std::memcpy(pal_color[p][n - 2][c], colours[p][n - 2] + c * (n + 1),
                                (n + 1) * sizeof(uint16_t));
        std::memcpy(seg_id, Default_Segment_Id_Cdf, sizeof seg_id);
        std::memcpy(mv_joint, Default_Mv_Joint_Cdf, sizeof mv_joint);
        for (int c = 0; c < 2; c++) {
            std::memcpy(mv_class[c], Default_Mv_Class_Cdf, sizeof mv_class[c]);
            std::memcpy(mv_sign[c], Default_Mv_Sign_Cdf, sizeof mv_sign[c]);
            std::memcpy(mv_class0_bit[c], Default_Mv_Class0_Bit_Cdf, sizeof mv_class0_bit[c]);
            std::memcpy(mv_class0_fr[c], Default_Mv_Class0_Fr_Cdf, sizeof mv_class0_fr[c]);
            std::memcpy(mv_class0_hp[c], Default_Mv_Class0_Hp_Cdf, sizeof mv_class0_hp[c]);
            std::memcpy(mv_bit[c], Default_Mv_Bit_Cdf, sizeof mv_bit[c]);
            std::memcpy(mv_fr[c], Default_Mv_Fr_Cdf, sizeof mv_fr[c]);
            std::memcpy(mv_hp[c], Default_Mv_Hp_Cdf, sizeof mv_hp[c]);
        }
        std::memcpy(txb_skip, Default_Txb_Skip_Cdf[qctx], sizeof txb_skip);
        std::memcpy(eob_pt16, Default_Eob_Pt_16_Cdf[qctx], sizeof eob_pt16);
        std::memcpy(eob_pt32, Default_Eob_Pt_32_Cdf[qctx], sizeof eob_pt32);
        std::memcpy(eob_pt64, Default_Eob_Pt_64_Cdf[qctx], sizeof eob_pt64);
        std::memcpy(eob_pt128, Default_Eob_Pt_128_Cdf[qctx], sizeof eob_pt128);
        std::memcpy(eob_pt256, Default_Eob_Pt_256_Cdf[qctx], sizeof eob_pt256);
        std::memcpy(eob_pt512, Default_Eob_Pt_512_Cdf[qctx], sizeof eob_pt512);
        std::memcpy(eob_pt1024, Default_Eob_Pt_1024_Cdf[qctx], sizeof eob_pt1024);
        std::memcpy(eob_extra, Default_Eob_Extra_Cdf[qctx], sizeof eob_extra);
        std::memcpy(coeff_base_eob, Default_Coeff_Base_Eob_Cdf[qctx], sizeof coeff_base_eob);
        std::memcpy(coeff_base, Default_Coeff_Base_Cdf[qctx], sizeof coeff_base);
        std::memcpy(coeff_br, Default_Coeff_Br_Cdf[qctx], sizeof coeff_br);
        std::memcpy(dc_sign, Default_Dc_Sign_Cdf[qctx], sizeof dc_sign);
        std::memcpy(tx_8x8, Default_Tx_8x8_Cdf, sizeof tx_8x8);
        std::memcpy(tx_16x16, Default_Tx_16x16_Cdf, sizeof tx_16x16);
        std::memcpy(tx_32x32, Default_Tx_32x32_Cdf, sizeof tx_32x32);
        std::memcpy(tx_64x64, Default_Tx_64x64_Cdf, sizeof tx_64x64);
        std::memcpy(txfm_split, Default_Txfm_Split_Cdf, sizeof txfm_split);
        std::memcpy(intra_tx_set1, Default_Intra_Tx_Type_Set1_Cdf, sizeof intra_tx_set1);
        std::memcpy(intra_tx_set2, Default_Intra_Tx_Type_Set2_Cdf, sizeof intra_tx_set2);
        std::memcpy(inter_tx_set1, Default_Inter_Tx_Type_Set1_Cdf, sizeof inter_tx_set1);
        std::memcpy(inter_tx_set2, Default_Inter_Tx_Type_Set2_Cdf, sizeof inter_tx_set2);
        std::memcpy(inter_tx_set3, Default_Inter_Tx_Type_Set3_Cdf, sizeof inter_tx_set3);
        std::memcpy(restoration_type, Default_Restoration_Type_Cdf, sizeof restoration_type);
        std::memcpy(use_wiener, Default_Use_Wiener_Cdf, sizeof use_wiener);
        std::memcpy(use_sgrproj, Default_Use_Sgrproj_Cdf, sizeof use_sgrproj);
    }
};

// ---- the symbol decoder (8.2) ---------------------------------------------------------------

struct SymbolDecoder {
    const uint8_t* data = nullptr;
    int64_t size = 0, bitpos = 0, max_bits = 0;
    uint32_t value = 0, range = 0;
    bool update = true;

    uint32_t f(int n) {
        uint32_t x = 0;
        for (int i = 0; i < n; i++, bitpos++) {
            int64_t byte = bitpos >> 3;
            uint32_t bit = byte < size ? (data[byte] >> (7 - (bitpos & 7))) & 1 : 0;
            x = (x << 1) | bit;
        }
        return x;
    }

    void init(const uint8_t* d, int64_t sz, bool allow_update) {
        data = d;
        size = sz;
        bitpos = 0;
        update = allow_update;
        int num_bits = (int)std::min<int64_t>(sz * 8, 15);
        uint32_t buf = f(num_bits);
        uint32_t padded = buf << (15 - num_bits);
        value = ((1u << 15) - 1) ^ padded;
        range = 1u << 15;
        max_bits = 8 * sz - 15;
    }

    int symbol(uint16_t* cdf, int n, bool adapt = true) {
        uint32_t cur = range, prev;
        int s = -1;
        do {
            s++;
            prev = cur;
            uint32_t fr = (1u << 15) - cdf[s];
            cur = ((range >> 8) * (fr >> 6) >> 1) + 4 * (uint32_t)(n - s - 1);
        } while (value < cur);
        range = prev - cur;
        value -= cur;
        int bits = 15 - floor_log2(range);
        range <<= bits;
        int num_bits = (int)std::min<int64_t>(bits, std::max<int64_t>(0, max_bits));
        uint32_t new_data = f(num_bits);
        uint32_t padded = new_data << (bits - num_bits);
        value = padded ^ (((value + 1) << bits) - 1);
        max_bits -= bits;
        if (adapt && update) {
            int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(floor_log2(n), 2);
            uint32_t tmp = 0;
            for (int i = 0; i < n - 1; i++) {
                tmp = i == s ? (1u << 15) : tmp;
                if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
                else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
            }
            cdf[n] += cdf[n] < 32;
        }
        return s;
    }

    int boolean() {
        uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
        return symbol(cdf, 2, false);
    }

    uint32_t literal(int n) {
        uint32_t x = 0;
        for (int i = 0; i < n; i++) x = 2 * x + boolean();
        return x;
    }

    int ns(int n) {  // NS(n) read with bools
        int w = floor_log2(n) + 1;
        int m = (1 << w) - n;
        int v = (int)literal(w - 1);
        if (v < m) return v;
        return (v << 1) - m + (int)literal(1);
    }

    // exit_symbol's rule: the bit after the last one the symbols consumed
    // is 1 and every bit after it is 0 (dav1d does not check it).
    bool padding_ok() const {
        int64_t padding_end = 8 * size;
        int64_t trailing = bitpos - std::min<int64_t>(15, max_bits + 15);
        if (trailing < 0 || trailing >= padding_end) return trailing == padding_end;
        for (int64_t p = trailing; p < padding_end; p++) {
            int bit = (data[p >> 3] >> (7 - (p & 7))) & 1;
            if (bit != (p == trailing)) return false;
        }
        return true;
    }
};

// ---- the decoder ----------------------------------------------------------------------------

struct Params {
    int width, height, mono, ssx, ssy, sb128, enable_filter_intra, enable_edge_filter;
    int screen, allow_intrabc, disable_cdf_update, base_q_idx;
    int seg_enabled, seg_preskip, seg_last_active, seg_skip_mask;
    int lossless, tx_mode, reduced_tx_set, enable_cdef, cdef_bits;
    int dq_ydc, dq_udc, dq_uac, dq_vdc, dq_vac;  // DeltaQYDc, DeltaQUDc, ...
    av1lf::Params lf;
    int lr_unit_shift, lr_uv_shift;
};

struct Decoder {
    Params p;
    int mi_cols, mi_rows, num_planes;
    int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
    int64_t* counters;

    // per-MI state of the frame
    std::vector<uint8_t> mi_size, y_modes, uv_modes, skips, seg_ids, is_inters, written;
    std::vector<uint8_t> inter_tx_sizes, tx_types;  // InterTxSizes, TxTypes (luma 4x4 units)
    std::vector<uint8_t> lf_tx_sizes[3];            // LoopfilterTxSizes (each plane's 4x4 units)
    int lf_tx_w[3], lf_tx_h[3];
    std::vector<int8_t> cdef_idx;                   // per 64x64
    int cdef_stride;
    std::vector<uint8_t> pal_sizes[2];
    std::vector<uint16_t> pal_colors[2];
    std::vector<int16_t> mvs;

    // the planes (the MI area, padded)
    int stride[3], plane_w[3], plane_h[3];
    std::vector<uint8_t> frame[3];

    // loop restoration: each plane's units, and the references of the tile
    std::vector<av1lf::LrUnit> lr_units[3];
    int lr_rows[3], lr_cols[3], lr_size[3];
    int ref_lr_wiener[3][2][3], ref_sgr_xqd[3][2];

    // contexts of the tile
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    uint8_t block_decoded[3][35][35];
    Cdfs cdf;
    SymbolDecoder sd;

    // the block being decoded
    int mi_row, mi_col, mi_sz, bw4, bh4, has_chroma, avail_u, avail_l, avail_u_chroma,
        avail_l_chroma;
    int skip, segment_id, use_intrabc, is_inter, y_mode, uv_mode, angle_delta_y, angle_delta_uv;
    int use_filter_intra, filter_intra_mode, cfl_alpha_u, cfl_alpha_v;
    int palette_size_y, palette_size_uv;
    int palette_colors_y[8], palette_colors_u[8], palette_colors_v[8];
    uint8_t color_map_y[64][64], color_map_uv[64][64];
    int mv[2];
    int max_luma_w, max_luma_h;
    int mid[129 * 128];  // the block copy's horizontal pass

    uint8_t& px(int plane, int y, int x) { return frame[plane][(int64_t)y * stride[plane] + x]; }
    int64_t mi(int r, int c) const { return (int64_t)r * mi_cols + c; }

    bool is_inside(int r, int c) const {
        return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
    }

    void setup(const Params& params, int64_t* ctr) {
        p = params;
        counters = ctr;
        mi_cols = 2 * ((p.width + 7) >> 3);
        mi_rows = 2 * ((p.height + 7) >> 3);
        num_planes = p.mono ? 1 : 3;
        int64_t n = (int64_t)mi_cols * mi_rows;
        for (auto* v : {&mi_size, &y_modes, &uv_modes, &skips, &seg_ids, &is_inters, &written,
                        &inter_tx_sizes, &tx_types})
            v->assign(n, 0);
        cdef_stride = (mi_cols >> 4) + 3;
        cdef_idx.assign((int64_t)cdef_stride * ((mi_rows >> 4) + 3), -1);
        for (int k = 0; k < 2; k++) {
            pal_sizes[k].assign(n, 0);
            pal_colors[k].assign(n * 8, 0);
        }
        mvs.assign(n * 2, 0);
        for (int pl = 0; pl < num_planes; pl++) {
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
            plane_w[pl] = (mi_cols * 4) >> sx;
            plane_h[pl] = (mi_rows * 4) >> sy;
            stride[pl] = plane_w[pl] + 160;
            frame[pl].assign((int64_t)stride[pl] * (plane_h[pl] + 160), 0);
            lf_tx_w[pl] = plane_w[pl] >> 2;
            lf_tx_h[pl] = plane_h[pl] >> 2;
            lf_tx_sizes[pl].assign((int64_t)lf_tx_w[pl] * lf_tx_h[pl], 0);
            // LoopRestorationSize, and count_units_in_frame of the cropped plane
            lr_size[pl] = (256 >> (2 - p.lr_unit_shift)) >> (pl ? p.lr_uv_shift : 0);
            int w = (p.width + sx) >> sx, h = (p.height + sy) >> sy;
            lr_cols[pl] = std::max((w + (lr_size[pl] >> 1)) / lr_size[pl], 1);
            lr_rows[pl] = std::max((h + (lr_size[pl] >> 1)) / lr_size[pl], 1);
            lr_units[pl].assign((int64_t)lr_rows[pl] * lr_cols[pl], av1lf::LrUnit());
        }
    }

    [[noreturn]] void corrupt(const char* what) { throw Corrupt{what}; }

    // ---- tiles ----

    void decode_tile(const uint8_t* data, int64_t size, int row_start, int row_end,
                     int col_start, int col_end) {
        mi_row_start = row_start;
        mi_row_end = row_end;
        mi_col_start = col_start;
        mi_col_end = col_end;
        int qctx = p.base_q_idx <= 20 ? 0 : p.base_q_idx <= 60 ? 1 : p.base_q_idx <= 120 ? 2 : 3;
        cdf.init(qctx);
        sd.init(data, size, !p.disable_cdf_update);
        for (int pl = 0; pl < num_planes; pl++) {  // clear_above_context
            above_level[pl].assign(mi_cols + 32, 0);
            above_dc[pl].assign(mi_cols + 32, 0);
            for (int pass = 0; pass < 2; pass++) {
                ref_sgr_xqd[pl][pass] = Sgrproj_Xqd_Mid[pass];
                for (int i = 0; i < 3; i++) ref_lr_wiener[pl][pass][i] = Wiener_Taps_Mid[i];
            }
        }
        int sb_size = p.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        int sb4 = Num_4x4_Blocks_Wide[sb_size];
        for (int r = mi_row_start; r < mi_row_end; r += sb4) {
            for (int pl = 0; pl < num_planes; pl++) {  // clear_left_context
                left_level[pl].assign(mi_rows + 32, 0);
                left_dc[pl].assign(mi_rows + 32, 0);
            }
            for (int c = mi_col_start; c < mi_col_end; c += sb4) {
                clear_block_decoded_flags(r, c, sb4);
                for (int y = 0; y < sb4; y += 16)  // clear_cdef
                    for (int x = 0; x < sb4; x += 16) cdef_at(r + y, c + x) = -1;
                read_lr(r, c, sb_size);
                decode_partition(r, c, sb_size);
            }
        }
        // exit_symbol: SymbolMaxBits must be -14 or more (dav1d refuses the
        // frame past that: "symbol decoder overread")
        if (sd.max_bits < -14) corrupt("AV1 tile data read past its end");
        counters[C_TILES]++;
        if (!sd.padding_ok()) counters[C_PADDING]++;
    }

    uint8_t& decoded(int plane, int y, int x) { return block_decoded[plane][y + 1][x + 1]; }
    int8_t& cdef_at(int r, int c) { return cdef_idx[(int64_t)(r >> 4) * cdef_stride + (c >> 4)]; }

    void clear_block_decoded_flags(int r, int c, int sb4) {
        for (int pl = 0; pl < num_planes; pl++) {
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
            int sb_w4 = (mi_col_end - c) >> sx, sb_h4 = (mi_row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); y++)
                for (int x = -1; x <= (sb4 >> sx); x++) {
                    if (y < 0 && x < sb_w4) decoded(pl, y, x) = 1;
                    else if (x < 0 && y < sb_h4) decoded(pl, y, x) = 1;
                    else decoded(pl, y, x) = 0;
                }
            decoded(pl, sb4 >> sy, -1) = 0;
        }
    }

    // ---- partitions (5.11.4) ----

    void decode_partition(int r, int c, int bsize) {
        if (r >= mi_rows || c >= mi_cols) return;
        int avail_u_ = is_inside(r - 1, c), avail_l_ = is_inside(r, c - 1);
        int num4x4 = Num_4x4_Blocks_Wide[bsize];
        int half = num4x4 >> 1, quarter = half >> 1;
        int has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
        int partition;
        if (bsize < BLOCK_8X8) {
            partition = PARTITION_NONE;
        } else {
            int bsl = Mi_Width_Log2[bsize];
            int above = avail_u_ && Mi_Width_Log2[mi_size[mi(r - 1, c)]] < bsl;
            int left = avail_l_ && Mi_Height_Log2[mi_size[mi(r, c - 1)]] < bsl;
            int ctx = left * 2 + above;
            uint16_t* pcdf;
            int n;
            switch (bsl) {
                case 1: pcdf = cdf.partition_w8[ctx]; n = 4; break;
                case 2: pcdf = cdf.partition_w16[ctx]; n = 10; break;
                case 3: pcdf = cdf.partition_w32[ctx]; n = 10; break;
                case 4: pcdf = cdf.partition_w64[ctx]; n = 10; break;
                default: pcdf = cdf.partition_w128[ctx]; n = 8; break;
            }
            auto prob = [&](int k) { return pcdf[k] - (k ? pcdf[k - 1] : 0); };
            if (has_rows && has_cols) {
                partition = sd.symbol(pcdf, n);
            } else if (has_cols) {  // split_or_horz
                int psum = prob(PARTITION_SPLIT) + prob(PARTITION_VERT) + prob(PARTITION_HORZ_A) +
                           prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
                if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
                uint16_t b[3] = {(uint16_t)(32768 - psum), 32768, 0};
                partition = sd.symbol(b, 2, false) ? PARTITION_SPLIT : PARTITION_HORZ;
            } else if (has_rows) {  // split_or_vert
                int psum = prob(PARTITION_SPLIT) + prob(PARTITION_HORZ) + prob(PARTITION_HORZ_A) +
                           prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
                if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
                uint16_t b[3] = {(uint16_t)(32768 - psum), 32768, 0};
                partition = sd.symbol(b, 2, false) ? PARTITION_SPLIT : PARTITION_VERT;
            } else {
                partition = PARTITION_SPLIT;
            }
        }
        int w4 = num4x4, h4 = num4x4;
        int sub, split = block_of(half, half);
        switch (partition) {
            case PARTITION_NONE: sub = bsize; break;
            case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B:
                sub = block_of(w4, half); break;
            case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B:
                sub = block_of(half, h4); break;
            case PARTITION_SPLIT: sub = split; break;
            case PARTITION_HORZ_4: sub = block_of(w4, quarter); break;
            default: sub = block_of(quarter, h4); break;
        }
        if (bsize == BLOCK_8X8 && partition == PARTITION_SPLIT) sub = BLOCK_4X4;
        if (num_planes > 1 && Subsampled_Size[sub][p.ssx][p.ssy] == BLOCK_INVALID)
            corrupt("AV1 partition whose chroma block is invalid at this subsampling");
        switch (partition) {
            case PARTITION_NONE: decode_block(r, c, sub); break;
            case PARTITION_HORZ:
                decode_block(r, c, sub);
                if (has_rows) decode_block(r + half, c, sub);
                break;
            case PARTITION_VERT:
                decode_block(r, c, sub);
                if (has_cols) decode_block(r, c + half, sub);
                break;
            case PARTITION_SPLIT:
                decode_partition(r, c, sub);
                decode_partition(r, c + half, sub);
                decode_partition(r + half, c, sub);
                decode_partition(r + half, c + half, sub);
                break;
            case PARTITION_HORZ_A:
                decode_block(r, c, split);
                decode_block(r, c + half, split);
                decode_block(r + half, c, sub);
                break;
            case PARTITION_HORZ_B:
                decode_block(r, c, sub);
                decode_block(r + half, c, split);
                decode_block(r + half, c + half, split);
                break;
            case PARTITION_VERT_A:
                decode_block(r, c, split);
                decode_block(r + half, c, split);
                decode_block(r, c + half, sub);
                break;
            case PARTITION_VERT_B:
                decode_block(r, c, sub);
                decode_block(r, c + half, split);
                decode_block(r + half, c + half, split);
                break;
            case PARTITION_HORZ_4:
                for (int k = 0; k < 4; k++)
                    if (k < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * k, c, sub);
                break;
            default:
                for (int k = 0; k < 4; k++)
                    if (k < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * k, sub);
                break;
        }
    }

    // ---- blocks (5.11.5) ----

    void decode_block(int r, int c, int sub) {
        mi_row = r;
        mi_col = c;
        mi_sz = sub;
        bw4 = Num_4x4_Blocks_Wide[sub];
        bh4 = Num_4x4_Blocks_High[sub];
        if (bh4 == 1 && p.ssy && (mi_row & 1) == 0) has_chroma = 0;
        else if (bw4 == 1 && p.ssx && (mi_col & 1) == 0) has_chroma = 0;
        else has_chroma = num_planes > 1;
        avail_u = is_inside(r - 1, c);
        avail_l = is_inside(r, c - 1);
        avail_u_chroma = avail_u;
        avail_l_chroma = avail_l;
        if (has_chroma) {
            if (p.ssy && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
            if (p.ssx && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
        } else {
            avail_u_chroma = avail_l_chroma = 0;
        }
        intra_frame_mode_info();
        palette_tokens();
        read_block_tx_size();
        if (skip) reset_block_context();
        for (int y = 0; y < bh4; y++) {
            if (r + y >= mi_rows) break;
            for (int x = 0; x < bw4; x++) {
                if (c + x >= mi_cols) break;
                int64_t k = mi(r + y, c + x);
                y_modes[k] = (uint8_t)y_mode;
                if (has_chroma) uv_modes[k] = (uint8_t)uv_mode;
                is_inters[k] = (uint8_t)is_inter;
                skips[k] = (uint8_t)skip;
                mi_size[k] = (uint8_t)mi_sz;
                seg_ids[k] = (uint8_t)segment_id;
                pal_sizes[0][k] = (uint8_t)palette_size_y;
                pal_sizes[1][k] = (uint8_t)palette_size_uv;
                for (int i = 0; i < palette_size_y; i++)
                    pal_colors[0][k * 8 + i] = (uint16_t)palette_colors_y[i];
                for (int i = 0; i < palette_size_uv; i++)
                    pal_colors[1][k * 8 + i] = (uint16_t)palette_colors_u[i];
                mvs[k * 2] = (int16_t)(use_intrabc ? mv[0] : 0);
                mvs[k * 2 + 1] = (int16_t)(use_intrabc ? mv[1] : 0);
            }
        }
        compute_prediction();
        residual();
        for (int y = 0; y < bh4 && r + y < mi_rows; y++)
            for (int x = 0; x < bw4 && c + x < mi_cols; x++) written[mi(r + y, c + x)] = 1;
        counters[C_BLOCKS]++;
        if (use_intrabc) {
            counters[C_INTRABC]++;
        } else {
            counters[C_Y_MODE + y_mode]++;
            if (has_chroma) counters[C_UV_MODE + uv_mode]++;
            if (angle_delta_y || (has_chroma && angle_delta_uv)) counters[C_ANGLE_DELTA]++;
            if (use_filter_intra) counters[C_FILTER_INTRA]++;
            if (has_chroma && uv_mode == UV_CFL_PRED) counters[C_CFL]++;
            if (palette_size_y) counters[C_PALETTE_Y]++;
            if (palette_size_uv) counters[C_PALETTE_UV]++;
        }
    }

    void reset_block_context() {
        for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
            for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++)
                above_level[pl][i] = above_dc[pl][i] = 0;
            for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++)
                left_level[pl][i] = left_dc[pl][i] = 0;
        }
    }

    void intra_segment_id() {
        if (!p.seg_enabled) {
            segment_id = 0;
            return;
        }
        int prev_ul = avail_u && avail_l ? seg_ids[mi(mi_row - 1, mi_col - 1)] : -1;
        int prev_u = avail_u ? seg_ids[mi(mi_row - 1, mi_col)] : -1;
        int prev_l = avail_l ? seg_ids[mi(mi_row, mi_col - 1)] : -1;
        int pred;
        if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
        else if (prev_l == -1) pred = prev_u;
        else pred = prev_ul == prev_u ? prev_u : prev_l;
        if (skip) {
            segment_id = pred;
            return;
        }
        int ctx;
        if (prev_ul < 0) ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
        else ctx = 0;
        int v = sd.symbol(cdf.seg_id[ctx], 8);
        int max = p.seg_last_active + 1, out;
        if (!pred) out = v;
        else if (pred >= max - 1) out = max - v - 1;
        else if (2 * pred < max) {
            if (v <= 2 * pred) out = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else out = v;
        } else {
            if (v <= 2 * (max - pred - 1)) out = (v & 1) ? pred + ((v + 1) >> 1) : pred - (v >> 1);
            else out = max - (v + 1);
        }
        segment_id = std::min(std::max(out, 0), std::max(p.seg_last_active, 0));
    }

    void read_skip() {
        if (p.seg_enabled && p.seg_preskip && ((p.seg_skip_mask >> segment_id) & 1)) {
            skip = 1;
            return;
        }
        int ctx = (avail_u ? skips[mi(mi_row - 1, mi_col)] : 0) +
                  (avail_l ? skips[mi(mi_row, mi_col - 1)] : 0);
        skip = sd.symbol(cdf.skip[ctx], 2);
    }

    void intra_frame_mode_info() {
        segment_id = 0;
        skip = 0;
        if (p.seg_preskip) intra_segment_id();
        read_skip();
        if (!p.seg_preskip) intra_segment_id();
        read_cdef();
        use_intrabc = p.allow_intrabc ? sd.symbol(cdf.intrabc, 2) : 0;
        palette_size_y = palette_size_uv = 0;
        use_filter_intra = 0;
        angle_delta_y = angle_delta_uv = 0;
        cfl_alpha_u = cfl_alpha_v = 0;
        if (use_intrabc) {
            is_inter = 1;
            y_mode = DC_PRED;
            uv_mode = DC_PRED;
            find_mv_stack_and_read_dv();
            return;
        }
        is_inter = 0;
        int above = avail_u ? y_modes[mi(mi_row - 1, mi_col)] : (int)DC_PRED;
        int left = avail_l ? y_modes[mi(mi_row, mi_col - 1)] : (int)DC_PRED;
        y_mode = sd.symbol(cdf.y_mode[Intra_Mode_Context[above]][Intra_Mode_Context[left]], 13);
        int use_angle_delta = mi_sz >= BLOCK_8X8;
        if (use_angle_delta && y_mode >= V_PRED && y_mode <= D67_PRED)
            angle_delta_y = sd.symbol(cdf.angle_delta[y_mode - V_PRED], 7) - 3;
        if (has_chroma) {
            int cfl_allowed = p.lossless ? Subsampled_Size[mi_sz][p.ssx][p.ssy] == BLOCK_4X4
                                         : std::max(bw4, bh4) <= 8;
            if (cfl_allowed) uv_mode = sd.symbol(cdf.uv_cfl[y_mode], 14);
            else uv_mode = sd.symbol(cdf.uv_no_cfl[y_mode], 13);
            if (uv_mode == UV_CFL_PRED) read_cfl_alphas();
            if (use_angle_delta && uv_mode >= V_PRED && uv_mode <= D67_PRED)
                angle_delta_uv = sd.symbol(cdf.angle_delta[uv_mode - V_PRED], 7) - 3;
        } else {
            uv_mode = DC_PRED;
        }
        if (mi_sz >= BLOCK_8X8 && Num_4x4_Blocks_Wide[mi_sz] <= 16 &&
            Num_4x4_Blocks_High[mi_sz] <= 16 && p.screen)
            palette_mode_info();
        if (p.enable_filter_intra && y_mode == DC_PRED && palette_size_y == 0 &&
            std::max(Num_4x4_Blocks_Wide[mi_sz], Num_4x4_Blocks_High[mi_sz]) <= 8) {
            use_filter_intra = sd.symbol(cdf.filter_intra[mi_sz], 2);
            if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
        }
    }

    void read_cdef() {
        if (skip || p.lossless || !p.enable_cdef || p.allow_intrabc) return;
        int r = mi_row & ~15, c = mi_col & ~15;
        if (cdef_at(r, c) == -1) {
            int v = (int)sd.literal(p.cdef_bits);
            for (int y = r; y < r + bh4; y += 16)
                for (int x = c; x < c + bw4; x += 16) cdef_at(y, x) = (int8_t)v;
        }
    }

    // ---- loop restoration syntax (5.11.57, 5.11.58) ----

    void read_lr(int r, int c, int bsize) {
        if (p.allow_intrabc) return;
        int w = Num_4x4_Blocks_Wide[bsize], h = Num_4x4_Blocks_High[bsize];
        for (int pl = 0; pl < num_planes; pl++) {
            if (p.lf.lr_type[pl] == av1lf::RESTORE_NONE) continue;
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0, unit = lr_size[pl];
            int row_start = (r * (4 >> sy) + unit - 1) / unit;
            int row_end = std::min(lr_rows[pl], ((r + h) * (4 >> sy) + unit - 1) / unit);
            int col_start = (c * (4 >> sx) + unit - 1) / unit;
            int col_end = std::min(lr_cols[pl], ((c + w) * (4 >> sx) + unit - 1) / unit);
            for (int ur = row_start; ur < row_end; ur++)
                for (int uc = col_start; uc < col_end; uc++) read_lr_unit(pl, ur, uc);
        }
    }

    void read_lr_unit(int pl, int unit_row, int unit_col) {
        av1lf::LrUnit& u = lr_units[pl][(int64_t)unit_row * lr_cols[pl] + unit_col];
        int type = p.lf.lr_type[pl];
        if (type == av1lf::RESTORE_WIENER)
            u.type = sd.symbol(cdf.use_wiener, 2) ? av1lf::RESTORE_WIENER : av1lf::RESTORE_NONE;
        else if (type == av1lf::RESTORE_SGRPROJ)
            u.type = sd.symbol(cdf.use_sgrproj, 2) ? av1lf::RESTORE_SGRPROJ : av1lf::RESTORE_NONE;
        else
            u.type = (uint8_t)sd.symbol(cdf.restoration_type, 3);
        int64_t* lf_counters = counters + C_FILTERS;
        if (u.type == av1lf::RESTORE_WIENER) {
            for (int pass = 0; pass < 2; pass++) {
                int first = pl ? 1 : 0;
                u.wiener[pass][0] = 0;
                for (int j = first; j < 3; j++) {
                    int v = decode_signed_subexp_with_ref_bool(
                        Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1, Wiener_Taps_K[j],
                        ref_lr_wiener[pl][pass][j]);
                    u.wiener[pass][j] = (int8_t)v;
                    ref_lr_wiener[pl][pass][j] = v;
                }
            }
            lf_counters[av1lf::F_LR_WIENER]++;
        } else if (u.type == av1lf::RESTORE_SGRPROJ) {
            u.set = (uint8_t)sd.literal(4);  // SGRPROJ_PARAMS_BITS
            for (int i = 0; i < 2; i++) {
                int radius = Sgr_Params[u.set][i * 2];
                int lo = Sgrproj_Xqd_Min[i], hi = Sgrproj_Xqd_Max[i], v = 0;
                if (radius)
                    v = decode_signed_subexp_with_ref_bool(lo, hi + 1, 4, ref_sgr_xqd[pl][i]);
                else if (i == 1)
                    v = std::min(std::max((1 << 7) - ref_sgr_xqd[pl][0], lo), hi);
                u.xqd[i] = (int16_t)v;
                ref_sgr_xqd[pl][i] = v;
            }
            lf_counters[av1lf::F_LR_SGRPROJ]++;
            if (!Sgr_Params[u.set][0]) lf_counters[av1lf::F_LR_SGR_R0]++;
            if (!Sgr_Params[u.set][2]) lf_counters[av1lf::F_LR_SGR_R1]++;
        }
    }

    int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
        int mx = high - low;
        r -= low;
        int i = 0, mk = 0, v;  // decode_subexp_bool(mx, k)
        while (true) {
            int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (mx <= mk + 3 * a) {
                v = sd.ns(mx - mk) + mk;
                break;
            }
            if (!sd.literal(1)) {
                v = (int)sd.literal(b2) + mk;
                break;
            }
            i++;
            mk += a;
        }
        auto inverse_recenter = [](int r_, int v_) {
            if (v_ > 2 * r_) return v_;
            return (v_ & 1) ? r_ - ((v_ + 1) >> 1) : r_ + (v_ >> 1);
        };
        int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
        return x + low;
    }

    void read_cfl_alphas() {
        int signs = sd.symbol(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
            cfl_alpha_u = 1 + sd.symbol(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
            if (sign_u == 1) cfl_alpha_u = -cfl_alpha_u;
        }
        if (sign_v) {
            cfl_alpha_v = 1 + sd.symbol(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
            if (sign_v == 1) cfl_alpha_v = -cfl_alpha_v;
        }
    }

    // ---- palette (5.11.46, 7.11.4) ----

    int palette_cache(int plane, int* cache) {
        int above_n = 0, left_n = 0;
        if ((mi_row * 4) % 64 && avail_u) above_n = pal_sizes[plane][mi(mi_row - 1, mi_col)];
        if (avail_l) left_n = pal_sizes[plane][mi(mi_row, mi_col - 1)];
        const uint16_t* above_c = &pal_colors[plane][mi(std::max(mi_row - 1, 0), mi_col) * 8];
        const uint16_t* left_c = &pal_colors[plane][mi(mi_row, std::max(mi_col - 1, 0)) * 8];
        int ai = 0, li = 0, n = 0;
        while (ai < above_n && li < left_n) {
            int a = above_c[ai], l = left_c[li];
            if (l < a) {
                if (n == 0 || l != cache[n - 1]) cache[n++] = l;
                li++;
            } else {
                if (n == 0 || a != cache[n - 1]) cache[n++] = a;
                ai++;
                if (l == a) li++;
            }
        }
        while (ai < above_n) {
            int v = above_c[ai++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = v;
        }
        while (li < left_n) {
            int v = left_c[li++];
            if (n == 0 || v != cache[n - 1]) cache[n++] = v;
        }
        return n;
    }

    void palette_mode_info() {
        int bsize_ctx = Mi_Width_Log2[mi_sz] + Mi_Height_Log2[mi_sz] - 2;
        int cache[16];
        if (y_mode == DC_PRED) {
            int ctx = 0;
            if (avail_u && pal_sizes[0][mi(mi_row - 1, mi_col)] > 0) ctx++;
            if (avail_l && pal_sizes[0][mi(mi_row, mi_col - 1)] > 0) ctx++;
            if (sd.symbol(cdf.pal_y_mode[bsize_ctx][ctx], 2)) {
                palette_size_y = sd.symbol(cdf.pal_y_size[bsize_ctx], 7) + 2;
                int cache_n = palette_cache(0, cache), idx = 0;
                for (int i = 0; i < cache_n && idx < palette_size_y; i++)
                    if (sd.literal(1)) palette_colors_y[idx++] = cache[i];
                if (idx < palette_size_y) palette_colors_y[idx++] = (int)sd.literal(8);
                int bits = 0;
                if (idx < palette_size_y) bits = 8 - 3 + (int)sd.literal(2);
                while (idx < palette_size_y) {
                    int delta = (int)sd.literal(bits) + 1;
                    palette_colors_y[idx] = clip1(palette_colors_y[idx - 1] + delta);
                    int range = 256 - palette_colors_y[idx] - 1;
                    bits = std::min(bits, ceil_log2(range));
                    idx++;
                }
                std::sort(palette_colors_y, palette_colors_y + palette_size_y);
            }
        }
        if (has_chroma && uv_mode == DC_PRED) {
            int ctx = palette_size_y > 0;
            if (sd.symbol(cdf.pal_uv_mode[ctx], 2)) {
                palette_size_uv = sd.symbol(cdf.pal_uv_size[bsize_ctx], 7) + 2;
                int cache_n = palette_cache(1, cache), idx = 0;
                for (int i = 0; i < cache_n && idx < palette_size_uv; i++)
                    if (sd.literal(1)) palette_colors_u[idx++] = cache[i];
                if (idx < palette_size_uv) palette_colors_u[idx++] = (int)sd.literal(8);
                int bits = 0;
                if (idx < palette_size_uv) bits = 8 - 3 + (int)sd.literal(2);
                while (idx < palette_size_uv) {
                    int delta = (int)sd.literal(bits);
                    palette_colors_u[idx] = clip1(palette_colors_u[idx - 1] + delta);
                    int range = 256 - palette_colors_u[idx];
                    idx++;
                    bits = std::min(bits, ceil_log2(range));
                }
                std::sort(palette_colors_u, palette_colors_u + palette_size_uv);
                if (sd.literal(1)) {  // delta_encode_palette_colors_v
                    int min_bits = 8 - 4, max_val = 256;
                    int pbits = min_bits + (int)sd.literal(2);
                    palette_colors_v[0] = (int)sd.literal(8);
                    for (idx = 1; idx < palette_size_uv; idx++) {
                        int delta = (int)sd.literal(pbits);
                        if (delta && sd.literal(1)) delta = -delta;
                        int val = palette_colors_v[idx - 1] + delta;
                        if (val < 0) val += max_val;
                        if (val >= max_val) val -= max_val;
                        palette_colors_v[idx] = clip1(val);
                    }
                } else {
                    for (idx = 0; idx < palette_size_uv; idx++)
                        palette_colors_v[idx] = (int)sd.literal(8);
                }
            }
        }
    }

    int color_context(uint8_t (*map)[64], int r, int c, int n, int* order) {
        int scores[8] = {0};
        for (int i = 0; i < 8; i++) order[i] = i;
        if (c > 0) scores[map[r][c - 1]] += 2;
        if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
        if (r > 0) scores[map[r - 1][c]] += 2;
        for (int i = 0; i < 3; i++) {
            int max_score = scores[i], max_idx = i;
            for (int j = i + 1; j < n; j++)
                if (scores[j] > max_score) {
                    max_score = scores[j];
                    max_idx = j;
                }
            if (max_idx != i) {
                max_score = scores[max_idx];
                int max_order = order[max_idx];
                for (int k = max_idx; k > i; k--) {
                    scores[k] = scores[k - 1];
                    order[k] = order[k - 1];
                }
                scores[i] = max_score;
                order[i] = max_order;
            }
        }
        int hash = 0;
        for (int i = 0; i < 3; i++) hash += scores[i] * Palette_Color_Hash_Multipliers[i];
        return Palette_Color_Context[hash];
    }

    void read_color_map(uint8_t (*map)[64], int n, int plane, int block_w, int block_h,
                        int onscreen_w, int onscreen_h) {
        map[0][0] = (uint8_t)sd.ns(n);
        int order[8];
        for (int i = 1; i < onscreen_h + onscreen_w - 1; i++)
            for (int j = std::min(i, onscreen_w - 1); j >= std::max(0, i - onscreen_h + 1); j--) {
                int ctx = color_context(map, i - j, j, n, order);
                if (ctx < 0) corrupt("AV1 palette colour context out of range");
                int s = sd.symbol(cdf.pal_color[plane][n - 2][ctx], n);
                map[i - j][j] = (uint8_t)order[s];
            }
        for (int i = 0; i < onscreen_h; i++)
            for (int j = onscreen_w; j < block_w; j++) map[i][j] = map[i][onscreen_w - 1];
        for (int i = onscreen_h; i < block_h; i++)
            for (int j = 0; j < block_w; j++) map[i][j] = map[onscreen_h - 1][j];
    }

    void palette_tokens() {
        int block_h = Num_4x4_Blocks_High[mi_sz] * 4, block_w = Num_4x4_Blocks_Wide[mi_sz] * 4;
        int onscreen_h = std::min(block_h, (mi_rows - mi_row) * 4);
        int onscreen_w = std::min(block_w, (mi_cols - mi_col) * 4);
        if (palette_size_y)
            read_color_map(color_map_y, palette_size_y, 0, block_w, block_h, onscreen_w,
                           onscreen_h);
        if (palette_size_uv) {
            block_h >>= p.ssy;
            block_w >>= p.ssx;
            onscreen_h >>= p.ssy;
            onscreen_w >>= p.ssx;
            if (block_w < 4) {
                block_w += 2;
                onscreen_w += 2;
            }
            if (block_h < 4) {
                block_h += 2;
                onscreen_h += 2;
            }
            read_color_map(color_map_uv, palette_size_uv, 1, block_w, block_h, onscreen_w,
                           onscreen_h);
        }
    }

    // ---- intra block copy: the DV stack (7.10.2) and read_mv (5.11.32) ----

    int num_mv_found;
    int ref_stack[8][2], weight_stack[8];

    void add_ref_mv_candidate(int r, int c, int weight) {
        if (!is_inters[mi(r, c)]) return;
        // an intra block copy's candidate: RefFrame[0] is INTRA_FRAME, [1] NONE
        int cand[2] = {mvs[mi(r, c) * 2], mvs[mi(r, c) * 2 + 1]};
        for (int i = 0; i < 2; i++) {  // lower_mv_precision with force_integer_mv
            int a = std::abs(cand[i]), a_int = (a + 3) >> 3;
            cand[i] = cand[i] > 0 ? a_int << 3 : -(a_int << 3);
        }
        int idx;
        for (idx = 0; idx < num_mv_found; idx++)
            if (cand[0] == ref_stack[idx][0] && cand[1] == ref_stack[idx][1]) break;
        if (idx < num_mv_found) {
            weight_stack[idx] += weight;
        } else if (num_mv_found < 8) {
            ref_stack[num_mv_found][0] = cand[0];
            ref_stack[num_mv_found][1] = cand[1];
            weight_stack[num_mv_found] = weight;
            num_mv_found++;
        }
    }

    void scan_row(int delta_row) {
        int end4 = std::min(std::min(bw4, mi_cols - mi_col), 16);
        int delta_col = 0, use_step16 = bw4 >= 16;
        if (std::abs(delta_row) > 1) {
            delta_row += mi_row & 1;
            delta_col = 1 - (mi_col & 1);
        }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row, c = mi_col + delta_col + i;
            if (!is_inside(r, c)) break;
            int len = std::min(bw4, Num_4x4_Blocks_Wide[mi_size[mi(r, c)]]);
            if (std::abs(delta_row) > 1) len = std::max(2, len);
            if (use_step16) len = std::max(4, len);
            add_ref_mv_candidate(r, c, len * 2);
            i += len;
        }
    }

    void scan_col(int delta_col) {
        int end4 = std::min(std::min(bh4, mi_rows - mi_row), 16);
        int delta_row = 0, use_step16 = bh4 >= 16;
        if (std::abs(delta_col) > 1) {
            delta_row = 1 - (mi_row & 1);
            delta_col += mi_col & 1;
        }
        for (int i = 0; i < end4;) {
            int r = mi_row + delta_row + i, c = mi_col + delta_col;
            if (!is_inside(r, c)) break;
            int len = std::min(bh4, Num_4x4_Blocks_High[mi_size[mi(r, c)]]);
            if (std::abs(delta_col) > 1) len = std::max(2, len);
            if (use_step16) len = std::max(4, len);
            add_ref_mv_candidate(r, c, len * 2);
            i += len;
        }
    }

    void scan_point(int delta_row, int delta_col) {
        int r = mi_row + delta_row, c = mi_col + delta_col;
        if (is_inside(r, c) && written[mi(r, c)]) add_ref_mv_candidate(r, c, 4);
    }

    void sort_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int idx = start + 1; idx < end; idx++)
                if (weight_stack[idx - 1] < weight_stack[idx]) {
                    std::swap(weight_stack[idx - 1], weight_stack[idx]);
                    std::swap(ref_stack[idx - 1][0], ref_stack[idx][0]);
                    std::swap(ref_stack[idx - 1][1], ref_stack[idx][1]);
                    new_end = idx;
                }
            end = new_end;
        }
    }

    int read_mv_component(int comp) {
        int sign = sd.symbol(cdf.mv_sign[comp], 2);
        int mv_class = sd.symbol(cdf.mv_class[comp], 11);
        int mag;
        if (mv_class == 0) {
            int class0_bit = sd.symbol(cdf.mv_class0_bit[comp], 2);
            mag = ((class0_bit << 3) | (3 << 1) | 1) + 1;  // force_integer_mv: fr 3, hp 1
        } else {
            int d = 0;
            for (int i = 0; i < mv_class; i++) d |= sd.symbol(cdf.mv_bit[comp][i], 2) << i;
            mag = 2 << (mv_class + 2);
            mag += ((d << 3) | (3 << 1) | 1) + 1;
        }
        return sign ? -mag : mag;
    }

    void find_mv_stack_and_read_dv() {
        // find_mv_stack for an intra frame: only intra block copies are
        // candidates, so the global, temporal and extra searches add nothing
        num_mv_found = 0;
        std::memset(ref_stack, 0, sizeof ref_stack);
        std::memset(weight_stack, 0, sizeof weight_stack);
        scan_row(-1);
        scan_col(-1);
        if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
        int num_nearest = num_mv_found;
        for (int idx = 0; idx < num_nearest; idx++) weight_stack[idx] += 640;  // REF_CAT_LEVEL
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (bh4 > 1) scan_row(-5);
        if (bw4 > 1) scan_col(-5);
        sort_stack(0, num_nearest);
        sort_stack(num_nearest, num_mv_found);
        // context_and_clamping: clamp_mv_row / clamp_mv_col of each entry
        for (int idx = 0; idx < num_mv_found; idx++) {
            int border_r = 128 + bh4 * 4 * 8, border_c = 128 + bw4 * 4 * 8;
            int to_top = -((mi_row * 4) * 8), to_bottom = ((mi_rows - bh4 - mi_row) * 4) * 8;
            int to_left = -((mi_col * 4) * 8), to_right = ((mi_cols - bw4 - mi_col) * 4) * 8;
            ref_stack[idx][0] =
                std::min(std::max(ref_stack[idx][0], to_top - border_r), to_bottom + border_r);
            ref_stack[idx][1] =
                std::min(std::max(ref_stack[idx][1], to_left - border_c), to_right + border_c);
        }
        int pred[2] = {ref_stack[0][0], ref_stack[0][1]};
        if (pred[0] == 0 && pred[1] == 0) {
            pred[0] = ref_stack[1][0];
            pred[1] = ref_stack[1][1];
        }
        if (pred[0] == 0 && pred[1] == 0) {
            int sb4 = p.sb128 ? 32 : 16;
            if (mi_row - sb4 < mi_row_start) {
                pred[0] = 0;
                pred[1] = -(sb4 * 4 + 256) * 8;
            } else {
                pred[0] = -(sb4 * 4 * 8);
                pred[1] = 0;
            }
        }
        int diff[2] = {0, 0};
        int joint = sd.symbol(cdf.mv_joint, 4);
        if (joint == 2 || joint == 3) diff[0] = read_mv_component(0);
        if (joint == 1 || joint == 3) diff[1] = read_mv_component(1);
        mv[0] = (int16_t)(pred[0] + diff[0]);  // dav1d keeps MVs in 16 bits
        mv[1] = (int16_t)(pred[1] + diff[1]);
        clamp_dv();
    }

    // dav1d's clamp of a DV to the decoded part of the tile (a valid DV is
    // left as it is); where no move takes the source out of the superblock
    // being decoded (a block copy in a tile's first superblock), dav1d
    // refuses the frame.
    void clamp_dv() {
        int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
        if (has_chroma) {
            if (bw4 < 2 && p.ssx) border_left += 4;
            if (bh4 < 2 && p.ssy) border_top += 4;
        }
        int src_left = mi_col * 4 + (mv[1] >> 3), src_top = mi_row * 4 + (mv[0] >> 3);
        int src_right = src_left + bw4 * 4, src_bottom = src_top + bh4 * 4;
        int border_right = ((mi_col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
        if (src_left < border_left) {
            src_right += border_left - src_left;
            src_left += border_left - src_left;
        } else if (src_right > border_right) {
            src_left -= src_right - border_right;
            src_right -= src_right - border_right;
        }
        if (src_top < border_top) {
            src_bottom += border_top - src_top;
            src_top += border_top - src_top;
        }
        int sb_shift = p.sb128 ? 5 : 4;
        int sbx = (mi_col >> sb_shift) << (sb_shift + 2);
        int sby = (mi_row >> sb_shift) << (sb_shift + 2);
        int sb_size = 1 << (sb_shift + 2);
        if (src_bottom > sby && src_right > sbx) {  // the superblock being decoded
            if (src_top - border_top >= src_bottom - sby) {
                src_top -= src_bottom - sby;
                src_bottom -= src_bottom - sby;
            } else if (src_left - border_left >= src_right - sbx) {
                src_left -= src_right - sbx;
                src_right -= src_right - sbx;
            } else {
                corrupt("AV1 intra block copy with no decoded area to copy from");
            }
        }
        if (src_bottom > sby + sb_size) {
            src_top -= src_bottom - (sby + sb_size);
            src_bottom -= src_bottom - (sby + sb_size);
        }
        if (src_bottom > sby && src_right > sbx + sb_size) {
            src_left -= src_right - (sbx + sb_size);
            src_right -= src_right - (sbx + sb_size);
        }
        mv[1] = (src_left - mi_col * 4) * 8;
        mv[0] = (src_top - mi_row * 4) * 8;
    }

    // ---- prediction of an intra block copy (7.11.3) ----

    void compute_prediction() {
        if (!is_inter) return;
        for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
            int plane_sz = Subsampled_Size[mi_sz][sx][sy];
            int w = Num_4x4_Blocks_Wide[plane_sz] * 4, h = Num_4x4_Blocks_High[plane_sz] * 4;
            int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
            // positions in 1/16 sample
            int pos_x = (base_x << 4) + ((2 * mv[1]) >> sx);
            int pos_y = (base_y << 4) + ((2 * mv[0]) >> sy);
            int ix = pos_x >> 4, fx = pos_x & 15, iy = pos_y >> 4, fy = pos_y & 15;
            // dav1d clamps the source to the MI grid's size (the specification:
            // the frame's), so a source past the frame's right or bottom edge
            // reads the decoded samples there
            int last_x = plane_w[pl] - 1, last_y = plane_h[pl] - 1;
            auto ref = [&](int y, int x) {
                return (int)px(pl, std::min(std::max(y, 0), last_y),
                               std::min(std::max(x, 0), last_x));
            };
            for (int r = 0; r < h + 1; r++)
                for (int c = 0; c < w; c++)
                    mid[r * 128 + c] = 16 * ref(iy + r, ix + c) +
                                       fx * (ref(iy + r, ix + c + 1) - ref(iy + r, ix + c));
            for (int r = 0; r < h; r++)
                for (int c = 0; c < w; c++) {
                    int m0 = mid[r * 128 + c], m1 = mid[(r + 1) * 128 + c];
                    px(pl, base_y + r, base_x + c) =
                        (uint8_t)clip1(round2(16 * m0 + fy * (m1 - m0), 8));
                }
        }
    }

    // ---- transform size (5.11.15-5.11.17) ----

    int tx_size;  // TxSize: the block's (intra), or the last var-tx leaf's

    int get_above_tx_width(int row, int col) {
        if (row == mi_row) {
            if (!avail_u) return 64;
            int64_t k = mi(row - 1, col);
            if (skips[k] && is_inters[k]) return Num_4x4_Blocks_Wide[mi_size[k]] * 4;
        }
        return Tx_Width[inter_tx_sizes[mi(row - 1, col)]];
    }

    int get_left_tx_height(int row, int col) {
        if (col == mi_col) {
            if (!avail_l) return 64;
            int64_t k = mi(row, col - 1);
            if (skips[k] && is_inters[k]) return Num_4x4_Blocks_High[mi_size[k]] * 4;
        }
        return Tx_Height[inter_tx_sizes[mi(row, col - 1)]];
    }

    void read_block_tx_size() {
        if (p.tx_mode == TX_MODE_SELECT && mi_sz > BLOCK_4X4 && is_inter && !skip && !p.lossless) {
            int max_tx = Max_Tx_Size_Rect[mi_sz];
            int tw4 = Tx_Width[max_tx] >> 2, th4 = Tx_Height[max_tx] >> 2;
            for (int row = mi_row; row < mi_row + bh4; row += th4)
                for (int col = mi_col; col < mi_col + bw4; col += tw4)
                    read_var_tx_size(row, col, max_tx, 0);
            return;
        }
        read_tx_size(!skip || !is_inter);
        for (int row = mi_row; row < std::min(mi_row + bh4, mi_rows); row++)
            for (int col = mi_col; col < std::min(mi_col + bw4, mi_cols); col++)
                inter_tx_sizes[mi(row, col)] = (uint8_t)tx_size;
    }

    void read_var_tx_size(int row, int col, int tx, int depth) {
        if (row >= mi_rows || col >= mi_cols) return;
        int split = 0;
        if (tx != TX_4X4 && depth != 2) {  // MAX_VARTX_DEPTH
            int above = get_above_tx_width(row, col) < Tx_Width[tx];
            int left = get_left_tx_height(row, col) < Tx_Height[tx];
            int size = std::min(64, std::max(bw4, bh4) * 4);
            int max_tx_sz = floor_log2(size) - 2;  // find_tx_size(size, size)
            int ctx = (Tx_Size_Sqr_Up[tx] != max_tx_sz) * 3 + (TX_64X64 - max_tx_sz) * 6 + above +
                      left;
            split = sd.symbol(cdf.txfm_split[ctx], 2);
        }
        int w4 = Tx_Width[tx] >> 2, h4 = Tx_Height[tx] >> 2;
        if (split) {
            counters[C_TXFM_SPLIT]++;
            int sub = Split_Tx_Size[tx];
            int sw4 = Tx_Width[sub] >> 2, sh4 = Tx_Height[sub] >> 2;
            for (int i = 0; i < h4; i += sh4)
                for (int j = 0; j < w4; j += sw4) read_var_tx_size(row + i, col + j, sub, depth + 1);
        } else {
            for (int i = 0; i < h4 && row + i < mi_rows; i++)
                for (int j = 0; j < w4 && col + j < mi_cols; j++)
                    inter_tx_sizes[mi(row + i, col + j)] = (uint8_t)tx;
            tx_size = tx;
        }
    }

    void read_tx_size(int allow_select) {
        if (p.lossless) {
            tx_size = TX_4X4;
            return;
        }
        int max_rect = Max_Tx_Size_Rect[mi_sz];
        tx_size = max_rect;
        if (mi_sz > BLOCK_4X4 && allow_select && p.tx_mode == TX_MODE_SELECT) {
            int above_w = 0, left_h = 0;
            if (avail_u) {
                int64_t k = mi(mi_row - 1, mi_col);
                above_w = is_inters[k] ? Num_4x4_Blocks_Wide[mi_size[k]] * 4
                                       : get_above_tx_width(mi_row, mi_col);
            }
            if (avail_l) {
                int64_t k = mi(mi_row, mi_col - 1);
                left_h = is_inters[k] ? Num_4x4_Blocks_High[mi_size[k]] * 4
                                      : get_left_tx_height(mi_row, mi_col);
            }
            int ctx = (above_w >= Tx_Width[max_rect]) + (left_h >= Tx_Height[max_rect]);
            int depth;
            switch (Max_Tx_Depth[mi_sz]) {
                case 4: depth = sd.symbol(cdf.tx_64x64[ctx], 3); break;
                case 3: depth = sd.symbol(cdf.tx_32x32[ctx], 3); break;
                case 2: depth = sd.symbol(cdf.tx_16x16[ctx], 3); break;
                default: depth = sd.symbol(cdf.tx_8x8[ctx], 2); break;
            }
            for (int i = 0; i < depth; i++) tx_size = Split_Tx_Size[tx_size];
            if (depth) counters[C_TX_DEPTH]++;
        }
    }

    // get_tx_size: a chroma plane's transform is its residual block's largest,
    // 32 where that is 64
    int get_tx_size(int pl, int tx) {
        if (pl == 0) return tx;
        int uv_tx = Max_Tx_Size_Rect[Subsampled_Size[mi_sz][p.ssx][p.ssy]];
        if (Tx_Width[uv_tx] == 64 || Tx_Height[uv_tx] == 64) {
            if (Tx_Width[uv_tx] == 16) return TX_16X32;
            if (Tx_Height[uv_tx] == 16) return TX_32X16;
            return TX_32X32;
        }
        return uv_tx;
    }

    // ---- residual (5.11.34) and transform blocks ----

    void residual() {
        int width_chunks = std::max(1, bw4 >> 4), height_chunks = std::max(1, bh4 >> 4);
        int mi_size_chunk = width_chunks > 1 || height_chunks > 1 ? (int)BLOCK_64X64 : mi_sz;
        if (use_intrabc && !skip && !p.lossless) counters[C_INTRABC_RESIDUAL]++;
        for (int cy = 0; cy < height_chunks; cy++)
            for (int cx = 0; cx < width_chunks; cx++) {
                int mi_row_chunk = mi_row + (cy << 4), mi_col_chunk = mi_col + (cx << 4);
                for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
                    int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
                    int tx = p.lossless ? (int)TX_4X4 : get_tx_size(pl, tx_size);
                    int step_x = Tx_Width[tx] >> 2, step_y = Tx_Height[tx] >> 2;
                    int plane_sz = Subsampled_Size[mi_size_chunk][sx][sy];
                    int num4x4_w = Num_4x4_Blocks_Wide[plane_sz];
                    int num4x4_h = Num_4x4_Blocks_High[plane_sz];
                    if (is_inter && !p.lossless && pl == 0) {
                        transform_tree(mi_col_chunk * 4, mi_row_chunk * 4, num4x4_w * 4,
                                       num4x4_h * 4);
                        continue;
                    }
                    int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
                    for (int y = 0; y < num4x4_h; y += step_y)
                        for (int x = 0; x < num4x4_w; x += step_x)
                            transform_block(pl, base_x, base_y, tx, x + ((cx << 4) >> sx),
                                            y + ((cy << 4) >> sy));
                }
            }
    }

    // the luma transform blocks of a var-tx block: halves (or quarters) of
    // w x h down to the InterTxSizes leaf at their corner
    void transform_tree(int start_x, int start_y, int w, int h) {
        if (start_x >= mi_cols * 4 || start_y >= mi_rows * 4) return;
        int tx = inter_tx_sizes[mi(start_y >> 2, start_x >> 2)];
        if (w <= Tx_Width[tx] && h <= Tx_Height[tx]) {
            int found = TX_4X4;  // find_tx_size(w, h)
            for (int t = 0; t < TX_SIZES_ALL; t++)
                if (Tx_Width[t] == w && Tx_Height[t] == h) found = t;
            transform_block(0, start_x, start_y, found, 0, 0);
        } else if (w > h) {
            transform_tree(start_x, start_y, w / 2, h);
            transform_tree(start_x + w / 2, start_y, w / 2, h);
        } else if (w < h) {
            transform_tree(start_x, start_y, w, h / 2);
            transform_tree(start_x, start_y + h / 2, w, h / 2);
        } else {
            transform_tree(start_x, start_y, w / 2, h / 2);
            transform_tree(start_x + w / 2, start_y, w / 2, h / 2);
            transform_tree(start_x, start_y + h / 2, w / 2, h / 2);
            transform_tree(start_x + w / 2, start_y + h / 2, w / 2, h / 2);
        }
    }

    void transform_block(int pl, int base_x, int base_y, int tx, int x, int y) {
        int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
        int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
        int sb_mask = p.sb128 ? 31 : 15;
        int sub_row = row & sb_mask, sub_col = col & sb_mask;
        int step_x = Tx_Width[tx] >> 2, step_y = Tx_Height[tx] >> 2;
        int max_x = (mi_cols * 4) >> sx, max_y = (mi_rows * 4) >> sy;
        if (start_x >= max_x || start_y >= max_y) return;
        if (!is_inter) {
            if ((pl == 0 && palette_size_y) || (pl != 0 && palette_size_uv)) {
                const int* palette = pl == 0 ? palette_colors_y
                                             : pl == 1 ? palette_colors_u : palette_colors_v;
                uint8_t (*map)[64] = pl == 0 ? color_map_y : color_map_uv;
                for (int i = 0; i < Tx_Height[tx]; i++)
                    for (int j = 0; j < Tx_Width[tx]; j++)
                        px(pl, start_y + i, start_x + j) =
                            (uint8_t)palette[map[y * 4 + i][x * 4 + j]];
            } else {
                int is_cfl = pl > 0 && uv_mode == UV_CFL_PRED;
                int mode = pl == 0 ? y_mode : is_cfl ? DC_PRED : uv_mode;
                int have_left = (pl == 0 ? avail_l : avail_l_chroma) || x > 0;
                int have_above = (pl == 0 ? avail_u : avail_u_chroma) || y > 0;
                int have_above_rt = decoded(pl, (sub_row >> sy) - 1, (sub_col >> sx) + step_x);
                int have_below_lft = decoded(pl, (sub_row >> sy) + step_y, (sub_col >> sx) - 1);
                predict_intra(pl, start_x, start_y, have_left, have_above, have_above_rt,
                              have_below_lft, mode, Tx_Width_Log2[tx], Tx_Height_Log2[tx]);
                if (is_cfl) predict_cfl(pl, start_x, start_y, tx);
            }
            if (pl == 0) {
                max_luma_w = start_x + step_x * 4;
                max_luma_h = start_y + step_y * 4;
            }
        }
        if (!skip) {
            int eob = coeffs(pl, start_x, start_y, tx);
            if (eob > 0) reconstruct(pl, start_x, start_y, tx);
        }
        for (int i = 0; i < step_y; i++)
            for (int j = 0; j < step_x; j++) decoded(pl, (sub_row >> sy) + i, (sub_col >> sx) + j) = 1;
        for (int i = start_y >> 2; i < std::min((start_y >> 2) + step_y, lf_tx_h[pl]); i++)
            for (int j = start_x >> 2; j < std::min((start_x >> 2) + step_x, lf_tx_w[pl]); j++)
                lf_tx_sizes[pl][(int64_t)i * lf_tx_w[pl] + j] = (uint8_t)tx;
    }

    // ---- transform types (5.11.47, 7.13.1) ----

    int get_tx_set(int tx) {
        int sqr = Tx_Size_Sqr[tx], sqr_up = Tx_Size_Sqr_Up[tx];
        if (sqr_up > TX_32X32) return TX_SET_DCTONLY;
        if (is_inter) {
            if (p.reduced_tx_set || sqr_up == TX_32X32) return TX_SET_3;
            return sqr == TX_16X16 ? TX_SET_2 : TX_SET_1;
        }
        if (sqr_up == TX_32X32) return TX_SET_DCTONLY;
        if (p.reduced_tx_set || sqr == TX_16X16) return TX_SET_2;
        return TX_SET_1;
    }

    void transform_type(int x4, int y4, int tx) {
        int set = get_tx_set(tx), type = av1itx::DCT_DCT;
        if (set > 0 && !p.lossless && p.base_q_idx > 0) {
            int sqr = Tx_Size_Sqr[tx];
            if (is_inter) {
                if (set == TX_SET_1)
                    type = Tx_Type_Inter_Inv_Set1[sd.symbol(cdf.inter_tx_set1[sqr], 16)];
                else if (set == TX_SET_2)
                    type = Tx_Type_Inter_Inv_Set2[sd.symbol(cdf.inter_tx_set2, 12)];
                else
                    type = Tx_Type_Inter_Inv_Set3[sd.symbol(cdf.inter_tx_set3[sqr], 2)];
            } else {
                int dir = use_filter_intra ? Filter_Intra_Mode_To_Intra_Dir[filter_intra_mode]
                                           : y_mode;
                if (set == TX_SET_1)
                    type = Tx_Type_Intra_Inv_Set1[sd.symbol(cdf.intra_tx_set1[sqr][dir], 7)];
                else
                    type = Tx_Type_Intra_Inv_Set2[sd.symbol(cdf.intra_tx_set2[sqr][dir], 5)];
            }
        }
        set_tx_types(x4, y4, tx, type);
    }

    void set_tx_types(int x4, int y4, int tx, int type) {
        for (int j = 0; j < (Tx_Height[tx] >> 2) && y4 + j < mi_rows; j++)
            for (int i = 0; i < (Tx_Width[tx] >> 2) && x4 + i < mi_cols; i++)
                tx_types[mi(y4 + j, x4 + i)] = (uint8_t)type;
    }

    int compute_tx_type(int pl, int tx, int block_x, int block_y) {
        if (p.lossless || Tx_Size_Sqr_Up[tx] > TX_32X32) return av1itx::DCT_DCT;
        int set = get_tx_set(tx);
        if (pl == 0) return tx_types[mi(block_y, block_x)];
        int type;
        if (is_inter) {
            int x4 = std::max(mi_col, block_x << p.ssx), y4 = std::max(mi_row, block_y << p.ssy);
            type = tx_types[mi(y4, x4)];
            return Tx_Type_In_Set_Inter[set][type] ? type : av1itx::DCT_DCT;
        }
        type = Mode_To_Txfm[uv_mode];
        return Tx_Type_In_Set_Intra[set][type] ? type : av1itx::DCT_DCT;
    }

    static int tx_class_of(int type) {
        if (type == av1itx::V_DCT || type == av1itx::V_ADST || type == av1itx::V_FLIPADST)
            return TX_CLASS_VERT;
        if (type == av1itx::H_DCT || type == av1itx::H_ADST || type == av1itx::H_FLIPADST)
            return TX_CLASS_HORIZ;
        return TX_CLASS_2D;
    }

    const uint16_t* get_scan(int tx) {
        if (tx == TX_16X64) return Default_Scan_16x32;
        if (tx == TX_64X16) return Default_Scan_32x16;
        if (Tx_Size_Sqr_Up[tx] == TX_64X64) return Default_Scan_32x32;
        int cls = plane_tx_type == av1itx::IDTX ? TX_CLASS_2D : tx_class_of(plane_tx_type);
        switch (tx) {
#define AV1_SCANS(tx, size) \
    case tx: \
        return cls == TX_CLASS_VERT ? Mrow_Scan_##size \
               : cls == TX_CLASS_HORIZ ? Mcol_Scan_##size : Default_Scan_##size;
            AV1_SCANS(TX_4X4, 4x4) AV1_SCANS(TX_8X8, 8x8) AV1_SCANS(TX_16X16, 16x16)
            AV1_SCANS(TX_4X8, 4x8) AV1_SCANS(TX_8X4, 8x4) AV1_SCANS(TX_8X16, 8x16)
            AV1_SCANS(TX_16X8, 16x8) AV1_SCANS(TX_4X16, 4x16) AV1_SCANS(TX_16X4, 16x4)
#undef AV1_SCANS
            case TX_32X32: return Default_Scan_32x32;
            case TX_16X32: return Default_Scan_16x32;
            case TX_32X16: return Default_Scan_32x16;
            case TX_8X32: return Default_Scan_8x32;
            default: return Default_Scan_32x8;
        }
    }

    // ---- coefficients (5.11.39) ----

    int quant[1024];
    int plane_tx_type;

    int coeffs(int pl, int start_x, int start_y, int tx) {
        int x4 = start_x >> 2, y4 = start_y >> 2;
        int w4 = Tx_Width[tx] >> 2, h4 = Tx_Height[tx] >> 2;
        int tx_sz_ctx = (Tx_Size_Sqr[tx] + Tx_Size_Sqr_Up[tx] + 1) >> 1;
        int ptype = pl > 0;
        int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
        int max_x4 = mi_cols >> sx, max_y4 = mi_rows >> sy;
        int seg_eob = tx == TX_16X64 || tx == TX_64X16 ? 512
                                                       : std::min(1024, Tx_Width[tx] * Tx_Height[tx]);
        std::memset(quant, 0, seg_eob * sizeof(int));
        int ctx;
        int plane_sz = Subsampled_Size[mi_sz][sx][sy];
        int bw = Num_4x4_Blocks_Wide[plane_sz] * 4, bh = Num_4x4_Blocks_High[plane_sz] * 4;
        if (pl == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < max_x4) top = std::max(top, (int)above_level[pl][x4 + k]);
            for (int k = 0; k < h4; k++)
                if (y4 + k < max_y4) left = std::max(left, (int)left_level[pl][y4 + k]);
            if (bw == Tx_Width[tx] && bh == Tx_Height[tx]) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int k = 0; k < w4; k++)
                if (x4 + k < max_x4) above |= above_level[pl][x4 + k] | above_dc[pl][x4 + k];
            for (int k = 0; k < h4; k++)
                if (y4 + k < max_y4) left |= left_level[pl][y4 + k] | left_dc[pl][y4 + k];
            ctx = 7 + (above != 0) + (left != 0);
            if (bw * bh > Tx_Width[tx] * Tx_Height[tx]) ctx += 3;
        }
        int all_zero = sd.symbol(cdf.txb_skip[tx_sz_ctx][ctx], 2);
        int eob = 0, cul_level = 0, dc_category = 0;
        if (all_zero) {
            if (pl == 0) set_tx_types(x4, y4, tx, av1itx::DCT_DCT);
        } else {
            if (pl == 0) transform_type(x4, y4, tx);
            plane_tx_type = compute_tx_type(pl, tx, x4, y4);
            int tx_class = tx_class_of(plane_tx_type);
            const uint16_t* scan = get_scan(tx);
            int eob_multisize = std::min(Tx_Width_Log2[tx], 5) + std::min(Tx_Height_Log2[tx], 5) - 4;
            int ectx = tx_class == TX_CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (eob_multisize) {
                case 0: eob_pt = sd.symbol(cdf.eob_pt16[ptype][ectx], 5); break;
                case 1: eob_pt = sd.symbol(cdf.eob_pt32[ptype][ectx], 6); break;
                case 2: eob_pt = sd.symbol(cdf.eob_pt64[ptype][ectx], 7); break;
                case 3: eob_pt = sd.symbol(cdf.eob_pt128[ptype][ectx], 8); break;
                case 4: eob_pt = sd.symbol(cdf.eob_pt256[ptype][ectx], 9); break;
                case 5: eob_pt = sd.symbol(cdf.eob_pt512[ptype], 10); break;
                default: eob_pt = sd.symbol(cdf.eob_pt1024[ptype], 11); break;
            }
            eob_pt += 1;
            eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
            int eob_shift = eob_pt - 3;
            if (eob_shift >= 0) {
                if (sd.symbol(cdf.eob_extra[tx_sz_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
                for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
                    eob_shift = std::max(0, eob_pt - 2) - 1 - i;
                    if (sd.literal(1)) eob += 1 << eob_shift;
                }
            }
            int adj = Adjusted_Tx_Size[tx];
            int bwl = Tx_Width_Log2[adj], txh = Tx_Height[adj], area = Tx_Width[adj] * txh;
            for (int c = eob - 1; c >= 0; c--) {
                int pos = scan[c];
                int level;
                if (c == eob - 1) {
                    int bctx = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
                    level = sd.symbol(cdf.coeff_base_eob[tx_sz_ctx][ptype][bctx], 3) + 1;
                } else {
                    int bctx = coeff_base_ctx(tx, bwl, txh, pos, tx_class);
                    level = sd.symbol(cdf.coeff_base[tx_sz_ctx][ptype][bctx], 4);
                }
                if (level > 2) {
                    int bctx = coeff_br_ctx(bwl, txh, pos, tx_class);
                    for (int idx = 0; idx < 4; idx++) {
                        int br = sd.symbol(cdf.coeff_br[std::min(tx_sz_ctx, 3)][ptype][bctx], 4);
                        level += br;
                        if (br < 3) break;
                    }
                }
                quant[pos] = level;
            }
            for (int c = 0; c < eob; c++) {
                int pos = scan[c];
                int sign = 0;
                if (quant[pos] != 0) {
                    if (c == 0) {
                        int dc = 0;
                        for (int k = 0; k < w4; k++)
                            if (x4 + k < max_x4)
                                dc += above_dc[pl][x4 + k] == 1 ? -1 : above_dc[pl][x4 + k] == 2;
                        for (int k = 0; k < h4; k++)
                            if (y4 + k < max_y4)
                                dc += left_dc[pl][y4 + k] == 1 ? -1 : left_dc[pl][y4 + k] == 2;
                        int sctx = dc < 0 ? 1 : dc > 0 ? 2 : 0;
                        sign = sd.symbol(cdf.dc_sign[ptype][sctx], 2);
                    } else {
                        sign = (int)sd.literal(1);
                    }
                }
                uint32_t level = (uint32_t)quant[pos];
                if (level > 14) {  // golomb, as dav1d reads it
                    int len = 0;
                    while (!sd.literal(1) && len < 32) len++;
                    uint32_t val = 1;
                    while (len--) val = (val << 1) + sd.literal(1);
                    level = val - 1 + 15;
                }
                if (pos == 0 && level > 0) dc_category = sign ? 1 : 2;
                level &= 0xFFFFF;
                cul_level += (int)level;
                quant[pos] = sign ? -(int)level : (int)level;
            }
            cul_level = std::min(63, cul_level);
            counters[C_TX_SIZE + tx]++;
            counters[C_TX_TYPE + plane_tx_type]++;
        }
        for (int i = 0; i < w4; i++) {
            above_level[pl][x4 + i] = (uint8_t)cul_level;
            above_dc[pl][x4 + i] = (uint8_t)dc_category;
        }
        for (int i = 0; i < h4; i++) {
            left_level[pl][y4 + i] = (uint8_t)cul_level;
            left_dc[pl][y4 + i] = (uint8_t)dc_category;
        }
        return eob;
    }

    int coeff_base_ctx(int tx, int bwl, int txh, int pos, int tx_class) {
        int row = pos >> bwl, col = pos - (row << bwl), mag = 0;
        for (int i = 0; i < 5; i++) {
            int rr = row + Sig_Ref_Diff_Offset[tx_class][i][0];
            int cc = col + Sig_Ref_Diff_Offset[tx_class][i][1];
            if (rr < txh && cc < (1 << bwl)) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
        }
        int ctx = std::min((mag + 1) >> 1, 4);
        if (tx_class == TX_CLASS_2D) {
            if (row == 0 && col == 0) return 0;
            return ctx + Coeff_Base_Ctx_Offset[tx][std::min(row, 4)][std::min(col, 4)];
        }
        return ctx + Coeff_Base_Pos_Ctx_Offset[std::min(tx_class == TX_CLASS_VERT ? row : col, 2)];
    }

    int coeff_br_ctx(int bwl, int txh, int pos, int tx_class) {
        int row = pos >> bwl, col = pos - (row << bwl), mag = 0;
        for (int i = 0; i < 3; i++) {
            int rr = row + Mag_Ref_Offset_With_Tx_Class[tx_class][i][0];
            int cc = col + Mag_Ref_Offset_With_Tx_Class[tx_class][i][1];
            if (rr < txh && cc < (1 << bwl)) mag += std::min(quant[(rr << bwl) + cc], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        if (pos == 0) return mag;
        int near = tx_class == TX_CLASS_2D     ? row < 2 && col < 2
                   : tx_class == TX_CLASS_HORIZ ? col == 0
                                                : row == 0;
        return mag + (near ? 7 : 14);
    }

    // ---- reconstruction: dequantisation (7.12.3) and the inverse transforms (7.13) ----

    int dq[1024];

    void reconstruct(int pl, int x, int y, int tx) {
        if (p.lossless) {
            reconstruct_wht(pl, x, y);
            return;
        }
        int w = Tx_Width[tx], h = Tx_Height[tx];
        int tw = std::min(32, w), th = std::min(32, h);
        int area = w * h;
        int dq_shift = area > 1024 ? 2 : area > 256 ? 1 : 0;  // dqDenom 4, 2 or 1
        const int dc_delta[3] = {p.dq_ydc, p.dq_udc, p.dq_vdc};
        const int ac_delta[3] = {0, p.dq_uac, p.dq_vac};
        int dc_q = Dc_Qlookup[std::min(std::max(p.base_q_idx + dc_delta[pl], 0), 255)];
        int ac_q = Ac_Qlookup[std::min(std::max(p.base_q_idx + ac_delta[pl], 0), 255)];
        for (int i = 0; i < th * tw; i++) {
            int q = quant[i];
            uint32_t v = ((uint32_t)std::abs(q) * (uint32_t)(i == 0 ? dc_q : ac_q)) & 0xFFFFFF;
            v >>= dq_shift;
            dq[i] = q < 0 ? -(int)std::min<uint32_t>(v, 32768) : (int)std::min<uint32_t>(v, 32767);
        }
        av1itx::inverse_transform_add(dq, w, h, Transform_Row_Shift[tx], plane_tx_type,
                                      &px(pl, y, x), stride[pl]);
    }

    // a CodedLossless frame: dequantisation at q index 0 and the inverse WHT
    void reconstruct_wht(int pl, int x, int y) {
        int t[4][4];
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
                int q = quant[i * 4 + j];
                uint32_t dq4 = ((uint32_t)std::abs(q) * 4u) & 0xFFFFFF;
                t[i][j] = q < 0 ? -(int)std::min<uint32_t>(dq4, 32768)
                                : (int)std::min<uint32_t>(dq4, 32767);
            }
        auto wht = [](int* a, int* b, int* c, int* d, int shift) {
            int A = *a >> shift, C = *b >> shift, D = *c >> shift, B = *d >> shift;
            A += C;
            D -= B;
            int E = (A - D) >> 1;
            B = E - B;
            C = E - C;
            A -= B;
            D += C;
            *a = A;
            *b = B;
            *c = C;
            *d = D;
        };
        for (int i = 0; i < 4; i++) wht(&t[i][0], &t[i][1], &t[i][2], &t[i][3], 2);
        for (int j = 0; j < 4; j++) wht(&t[0][j], &t[1][j], &t[2][j], &t[3][j], 0);
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++)
                px(pl, y + i, x + j) = (uint8_t)clip1(px(pl, y + i, x + j) + t[i][j]);
    }

    // ---- intra prediction (7.11.2) ----

    bool is_smooth(int r, int c, int pl) {
        int mode;
        if (pl == 0) {
            mode = y_modes[mi(r, c)];
        } else {
            if (is_inters[mi(r, c)]) return false;
            mode = uv_modes[mi(r, c)];
        }
        return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
    }

    int filter_type(int pl) {
        int above_sm = 0, left_sm = 0;
        if (pl == 0 ? avail_u : avail_u_chroma) {
            int r = mi_row - 1, c = mi_col;
            if (pl > 0) {
                if (p.ssx && !(mi_col & 1)) c++;
                if (p.ssy && (mi_row & 1)) r--;
            }
            above_sm = is_smooth(r, c, pl);
        }
        if (pl == 0 ? avail_l : avail_l_chroma) {
            int r = mi_row, c = mi_col - 1;
            if (pl > 0) {
                if (p.ssx && (mi_col & 1)) c--;
                if (p.ssy && !(mi_row & 1)) r++;
            }
            left_sm = is_smooth(r, c, pl);
        }
        return above_sm || left_sm;
    }

    static int edge_strength(int w, int h, int type, int delta) {
        int d = std::abs(delta), wh = w + h, s = 0;
        if (type == 0) {
            if (wh <= 8) { if (d >= 56) s = 1; }
            else if (wh <= 12) { if (d >= 40) s = 1; }
            else if (wh <= 16) { if (d >= 40) s = 1; }
            else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
            else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
            else { if (d >= 1) s = 3; }
        } else {
            if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
            else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
            else if (wh <= 24) { if (d >= 4) s = 3; }
            else { if (d >= 1) s = 3; }
        }
        return s;
    }

    static int use_upsample(int w, int h, int type, int delta) {
        int d = std::abs(delta), wh = w + h;
        if (d <= 0 || d >= 40) return 0;
        return type ? wh <= 8 : wh <= 16;
    }

    // edge[-16..] with index offset 16
    void edge_filter(int* edge, int size, int strength) {
        if (!strength) return;
        int e[160];
        for (int i = 0; i < size; i++) e[i] = edge[i - 1];
        for (int i = 1; i < size; i++) {
            int s = 0;
            for (int j = 0; j < 5; j++) {
                int k = std::min(std::max(i - 2 + j, 0), size - 1);
                s += Intra_Edge_Kernel[strength - 1][j] * e[k];
            }
            edge[i - 1] = (s + 8) >> 4;
        }
    }

    void edge_upsample(int* buf, int num_px) {
        int dup[64];
        dup[0] = buf[-1];
        for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
        dup[num_px + 2] = buf[num_px - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < num_px; i++) {
            int s = 0;
            for (int k = 0; k < 4; k++) s += Intra_Edge_Upsample_Taps[k] * dup[i + k];
            s = clip1(round2(s, 4));
            buf[2 * i - 1] = s;
            buf[2 * i] = dup[i + 2];
        }
    }

    static const uint8_t* sm_weights(int log2) {
        switch (log2) {
            case 2: return Sm_Weights_Tx_4x4;
            case 3: return Sm_Weights_Tx_8x8;
            case 4: return Sm_Weights_Tx_16x16;
            case 5: return Sm_Weights_Tx_32x32;
            default: return Sm_Weights_Tx_64x64;
        }
    }

    int pred[64][64];

    void predict_intra(int pl, int x, int y, int have_left, int have_above, int have_above_rt,
                       int have_below_lft, int mode, int log2w, int log2h) {
        const int w = 1 << log2w, h = 1 << log2h;
        int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
        int max_x = ((mi_cols * 4) >> sx) - 1, max_y = ((mi_rows * 4) >> sy) - 1;
        int above_buf[176], left_buf[176];
        int* above = above_buf + 16;
        int* left = left_buf + 16;
        for (int i = 0; i < w + h; i++) {
            if (!have_above && have_left) above[i] = px(pl, y, x - 1);
            else if (!have_above && !have_left) above[i] = 127;
            else {
                int limit = std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
                above[i] = px(pl, y - 1, std::min(limit, x + i));
            }
        }
        for (int i = 0; i < w + h; i++) {
            if (!have_left && have_above) left[i] = px(pl, y - 1, x);
            else if (!have_left && !have_above) left[i] = 129;
            else {
                int limit = std::min(max_y, y + (have_below_lft ? 2 * h : h) - 1);
                left[i] = px(pl, std::min(limit, y + i), x - 1);
            }
        }
        if (have_above && have_left) above[-1] = px(pl, y - 1, x - 1);
        else if (have_above) above[-1] = px(pl, y - 1, x);
        else if (have_left) above[-1] = px(pl, y, x - 1);
        else above[-1] = 128;
        left[-1] = above[-1];
        if (pl == 0 && use_filter_intra) {
            // the recursive intra prediction process (filter intra), 4x2 at a time
            for (int i2 = 0; i2 < h / 2; i2++)
                for (int j4 = 0; j4 < w / 4; j4++) {
                    int pv[7];
                    for (int i = 0; i < 7; i++) {
                        if (i < 5) {
                            if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
                            else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
                            else pv[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                        } else {
                            if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
                            else pv[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                        }
                    }
                    for (int i = 0; i < 8; i++) {
                        int pr = 0;
                        for (int j = 0; j < 7; j++)
                            pr += Intra_Filter_Taps[filter_intra_mode][i][j] * pv[j];
                        pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
                            clip1(round2signed(pr, 4));
                    }
                }
        } else if (mode >= V_PRED && mode <= D67_PRED) {
            int angle_delta = pl == 0 ? angle_delta_y : angle_delta_uv;
            int p_angle = Mode_To_Angle[mode] + angle_delta * 3;
            int up_above = 0, up_left = 0;
            if (p.enable_edge_filter) {
                int type = filter_type(pl);
                if (p_angle != 90 && p_angle != 180) {
                    if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
                        int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                        left[-1] = above[-1] = v;
                        counters[C_CORNER_FILTER]++;
                    }
                    if (have_above) {
                        int strength = edge_strength(w, h, type, p_angle - 90);
                        int num_px = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
                        if (strength) counters[C_EDGE_FILTER]++;
                        edge_filter(above, num_px, strength);
                    }
                    if (have_left) {
                        int strength = edge_strength(w, h, type, p_angle - 180);
                        int num_px = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
                        if (strength) counters[C_EDGE_FILTER]++;
                        edge_filter(left, num_px, strength);
                    }
                }
                up_above = use_upsample(w, h, type, p_angle - 90);
                if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0));
                up_left = use_upsample(w, h, type, p_angle - 180);
                if (up_left) edge_upsample(left, h + (p_angle > 180 ? w : 0));
                if (up_above || up_left) counters[C_UPSAMPLED]++;
            }
            int dx = 0, dy = 0;
            if (p_angle < 90) dx = Dr_Intra_Derivative[p_angle];
            else if (p_angle > 90 && p_angle < 180) dx = Dr_Intra_Derivative[180 - p_angle];
            if (p_angle > 90 && p_angle < 180) dy = Dr_Intra_Derivative[p_angle - 90];
            else if (p_angle > 180) dy = Dr_Intra_Derivative[270 - p_angle];
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int v;
                    if (p_angle < 90) {
                        int idx = (i + 1) * dx;
                        int base = (idx >> (6 - up_above)) + (j << up_above);
                        int shift = ((idx << up_above) >> 1) & 0x1F;
                        int max_base_x = (w + h - 1) << up_above;
                        if (base < max_base_x)
                            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        else
                            v = above[max_base_x];
                    } else if (p_angle > 90 && p_angle < 180) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int base = idx >> (6 - up_above);
                        if (base >= -(1 << up_above)) {
                            int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        } else {
                            idx = (i << 6) - (j + 1) * dy;
                            base = idx >> (6 - up_left);
                            int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
                            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        }
                    } else if (p_angle > 180) {
                        int idx = (j + 1) * dy;
                        int base = (idx >> (6 - up_left)) + (i << up_left);
                        int shift = ((idx << up_left) >> 1) & 0x1F;
                        v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                    } else if (p_angle == 90) {
                        v = above[j];
                    } else {
                        v = left[i];
                    }
                    pred[i][j] = v;
                }
        } else if (mode == SMOOTH_PRED) {
            const uint8_t *wx = sm_weights(log2w), *wy = sm_weights(log2h);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                            (256 - wx[j]) * above[w - 1];
                    pred[i][j] = round2(s, 9);
                }
        } else if (mode == SMOOTH_V_PRED) {
            const uint8_t* wy = sm_weights(log2h);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i][j] = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
        } else if (mode == SMOOTH_H_PRED) {
            const uint8_t* wx = sm_weights(log2w);
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++)
                    pred[i][j] = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
        } else if (mode == DC_PRED) {
            int v;
            if (have_left && have_above) {
                int sum = 0;
                for (int k = 0; k < h; k++) sum += left[k];
                for (int k = 0; k < w; k++) sum += above[k];
                v = (sum + ((w + h) >> 1)) / (w + h);
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < h; k++) sum += left[k];
                v = clip1((sum + (h >> 1)) >> log2h);
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; k++) sum += above[k];
                v = clip1((sum + (w >> 1)) >> log2w);
            } else {
                v = 128;
            }
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) pred[i][j] = v;
        } else {  // PAETH_PRED
            for (int i = 0; i < h; i++)
                for (int j = 0; j < w; j++) {
                    int base = above[j] + left[i] - above[-1];
                    int p_left = std::abs(base - left[i]), p_top = std::abs(base - above[j]);
                    int p_top_left = std::abs(base - above[-1]);
                    if (p_left <= p_top && p_left <= p_top_left) pred[i][j] = left[i];
                    else if (p_top <= p_top_left) pred[i][j] = above[j];
                    else pred[i][j] = above[-1];
                }
        }
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) px(pl, y + i, x + j) = (uint8_t)pred[i][j];
    }

    void predict_cfl(int pl, int start_x, int start_y, int tx) {
        const int w = Tx_Width[tx], h = Tx_Height[tx];
        int sx = p.ssx, sy = p.ssy;
        int alpha = pl == 1 ? cfl_alpha_u : cfl_alpha_v;
        int avg = 0;
        for (int i = 0; i < h; i++) {
            int luma_y = std::min((start_y + i) << sy, max_luma_h - (1 << sy));
            for (int j = 0; j < w; j++) {
                int luma_x = std::min((start_x + j) << sx, max_luma_w - (1 << sx));
                int t = 0;
                for (int dy = 0; dy <= sy; dy++)
                    for (int dx = 0; dx <= sx; dx++) t += px(0, luma_y + dy, luma_x + dx);
                int v = t << (3 - sx - sy);
                pred[i][j] = v;
                avg += v;
            }
        }
        avg = round2(avg, Tx_Width_Log2[tx] + Tx_Height_Log2[tx]);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int dc = px(pl, start_y + i, start_x + j);
                int scaled = round2signed(alpha * (pred[i][j] - avg), 6);
                px(pl, start_y + i, start_x + j) = (uint8_t)clip1(dc + scaled);
            }
    }
};

}  // namespace

extern "C" {

// Decode one key frame's tiles.
//   data, size       the tile group data the tiles' offsets index
//   params           width, height, mono, subsampling_x, subsampling_y, sb128,
//                    enable_filter_intra, enable_intra_edge_filter,
//                    allow_screen_content_tools, allow_intrabc, disable_cdf_update,
//                    base_q_idx, segmentation_enabled, SegIdPreSkip, LastActiveSegId,
//                    the mask of segments with SEG_LVL_SKIP, CodedLossless, TxMode
//                    (0 ONLY_4X4, 1 LARGEST, 2 SELECT), reduced_tx_set, enable_cdef,
//                    cdef_bits, DeltaQYDc, DeltaQUDc, DeltaQUAc, DeltaQVDc, DeltaQVAc;
//                    then the in-loop filters: loop_filter_level[0..3],
//                    loop_filter_sharpness, loop_filter_delta_enabled,
//                    loop_filter_ref_deltas[INTRA_FRAME], CdefDamping, 8 x (cdef_y_pri,
//                    cdef_y_sec, cdef_uv_pri, cdef_uv_sec as coded: a sec of 3 means 4),
//                    FrameRestorationType[0..2] (0 NONE, 1 WIENER, 2 SGRPROJ,
//                    3 SWITCHABLE), lr_unit_shift, lr_uv_shift (71 int32)
//   tiles            per tile: offset, size, MiRowStart, MiRowEnd, MiColStart, MiColEnd
//   y, u, v          the planes out, cropped to the frame: height x width, and the
//                    chroma planes' ceil-subsampled size (u, v null for 4:0:0)
//   counters         C_COUNT int64 (see the enum above), added to
//   error            a message where the call returns 1
int av1_decode_tiles(const uint8_t* data, int64_t size, const int32_t* params,
                     const int64_t* tiles, int32_t n_tiles, uint8_t* y, uint8_t* u, uint8_t* v,
                     int64_t* counters, char* error, int32_t error_size) {
    Decoder* d = new Decoder();
    int rc = 0;
    try {
        Params p;
        p.width = params[0];
        p.height = params[1];
        p.mono = params[2];
        p.ssx = params[3];
        p.ssy = params[4];
        p.sb128 = params[5];
        p.enable_filter_intra = params[6];
        p.enable_edge_filter = params[7];
        p.screen = params[8];
        p.allow_intrabc = params[9];
        p.disable_cdf_update = params[10];
        p.base_q_idx = params[11];
        p.seg_enabled = params[12];
        p.seg_preskip = params[13];
        p.seg_last_active = params[14];
        p.seg_skip_mask = params[15];
        p.lossless = params[16];
        p.tx_mode = params[17];
        p.reduced_tx_set = params[18];
        p.enable_cdef = params[19];
        p.cdef_bits = params[20];
        p.dq_ydc = params[21];
        p.dq_udc = params[22];
        p.dq_uac = params[23];
        p.dq_vdc = params[24];
        p.dq_vac = params[25];
        const int32_t* f = params + 26;  // the in-loop filters
        for (int i = 0; i < 4; i++) p.lf.levels[i] = f[i];
        p.lf.sharpness = f[4];
        p.lf.delta_enabled = f[5];
        p.lf.ref_delta_intra = f[6];
        p.lf.cdef_on = p.enable_cdef && !p.lossless && !p.allow_intrabc;
        p.lf.cdef_damping = f[7];
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 4; j++) p.lf.cdef[i][j] = f[8 + 4 * i + j];
        for (int i = 0; i < 3; i++) p.lf.lr_type[i] = f[40 + i];
        p.lr_unit_shift = f[43];
        p.lr_uv_shift = f[44];
        d->setup(p, counters);
        for (int t = 0; t < n_tiles; t++) {
            const int64_t* tile = tiles + 6 * t;
            if (tile[0] < 0 || tile[1] < 0 || tile[0] + tile[1] > size)
                throw Corrupt{"AV1 tile past the tile group's data"};
            d->decode_tile(data + tile[0], tile[1], (int)tile[2], (int)tile[3], (int)tile[4],
                           (int)tile[5]);
        }
        av1lf::Frame fr;
        fr.width = p.width;
        fr.height = p.height;
        fr.mi_rows = d->mi_rows;
        fr.mi_cols = d->mi_cols;
        fr.num_planes = d->num_planes;
        fr.ssx = p.ssx;
        fr.ssy = p.ssy;
        for (int pl = 0; pl < d->num_planes; pl++) {
            fr.planes[pl] = d->frame[pl].data();
            fr.stride[pl] = d->stride[pl];
            fr.tx_sizes[pl] = d->lf_tx_sizes[pl].data();
            fr.tx_stride[pl] = d->lf_tx_w[pl];
            fr.lr_units[pl] = d->lr_units[pl].data();
            fr.lr_rows[pl] = d->lr_rows[pl];
            fr.lr_cols[pl] = d->lr_cols[pl];
            fr.lr_size[pl] = d->lr_size[pl];
        }
        fr.skips = d->skips.data();
        fr.tx_width = Tx_Width;
        fr.tx_height = Tx_Height;
        fr.cdef_idx = d->cdef_idx.data();
        fr.cdef_stride = d->cdef_stride;
        fr.counters = counters + C_FILTERS;
        av1lf::filter_frame(fr, p.lf);
        uint8_t* out[3] = {y, u, v};
        for (int pl = 0; pl < d->num_planes; pl++) {
            int sx = pl ? p.ssx : 0, sy = pl ? p.ssy : 0;
            int w = (p.width + sx) >> sx, h = (p.height + sy) >> sy;
            for (int r = 0; r < h; r++)
                std::memcpy(out[pl] + (int64_t)r * w, &d->px(pl, r, 0), w);
        }
    } catch (const Corrupt& e) {
        std::snprintf(error, error_size, "%s", e.what.c_str());
        rc = 1;
    } catch (const std::exception& e) {  // no memory for a frame this large
        std::snprintf(error, error_size, "AV1 frame the decoder cannot hold: %s", e.what());
        rc = 1;
    }
    delete d;
    return rc;
}

int av1_counter_count() { return C_COUNT; }

}  // extern "C"
