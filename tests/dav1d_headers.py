"""The AV1 sequence and frame headers as dav1d 1.5.1 parses them: the
oracle the AVIF fixtures' `dav1d` records come from
(tests/test_torch_image_formats_avif.py `make_avif_fixtures`).

Pillow 12.1.0's bundled libavif links dav1d statically and exports its
API. `dav1d_record(payload)` decodes one AV1 payload (an AVIF item's or
sample's bytes) through ctypes into dav1d_open / dav1d_send_data /
dav1d_get_picture and reads the picture's Dav1dSequenceHeader and
Dav1dFrameHeader (include/dav1d/headers.h of dav1d 1.5.1, API 7.0.0,
mirrored below) into the fields and names of the port's
rustic_tpu_torch/utils/avif.py `header_record`. A field the layout below
misplaced would read another field's bytes: the records agree with the
port's on every fixture, on non-zero anchors on either side of each field
(quantiser, loop-filter levels, CDEF strengths, the tool flags).

Only the fixture maker calls it, on a host with Pillow's libavif; the
Tier-1 tests read the committed records.
"""

from __future__ import annotations

import ctypes
import glob
import os
from ctypes import c_int as cint
from ctypes import c_int8 as i8
from ctypes import c_int16 as i16
from ctypes import c_uint8 as u8
from ctypes import c_uint16 as u16
from ctypes import c_uint32 as u32
from ctypes import c_uint64 as u64

EAGAIN = -11


def _struct(name: str, fields: list):
    return type(name, (ctypes.Structure,), {"_fields_": fields})


_OP_POINT = _struct("Dav1dSequenceHeaderOperatingPoint", [
    ("major_level", u8), ("minor_level", u8), ("initial_display_delay", u8), ("idc", u16),
    ("tier", u8), ("decoder_model_param_present", u8), ("display_model_param_present", u8)])
_OP_PARAM = _struct("Dav1dSequenceHeaderOperatingParameterInfo", [
    ("decoder_buffer_delay", u32), ("encoder_buffer_delay", u32), ("low_delay_mode", u8)])
SEQUENCE_HEADER = _struct("Dav1dSequenceHeader", [
    ("profile", u8), ("max_width", cint), ("max_height", cint), ("layout", cint), ("pri", cint),
    ("trc", cint), ("mtrx", cint), ("chr", cint), ("hbd", u8), ("color_range", u8),
    ("num_operating_points", u8), ("operating_points", _OP_POINT * 32), ("still_picture", u8),
    ("reduced_still_picture_header", u8), ("timing_info_present", u8),
    ("num_units_in_tick", u32), ("time_scale", u32), ("equal_picture_interval", u8),
    ("num_ticks_per_picture", u32), ("decoder_model_info_present", u8),
    ("encoder_decoder_buffer_delay_length", u8), ("num_units_in_decoding_tick", u32),
    ("buffer_removal_delay_length", u8), ("frame_presentation_delay_length", u8),
    ("display_model_info_present", u8), ("width_n_bits", u8), ("height_n_bits", u8),
    ("frame_id_numbers_present", u8), ("delta_frame_id_n_bits", u8), ("frame_id_n_bits", u8),
    ("sb128", u8), ("filter_intra", u8), ("intra_edge_filter", u8), ("inter_intra", u8),
    ("masked_compound", u8), ("warped_motion", u8), ("dual_filter", u8), ("order_hint", u8),
    ("jnt_comp", u8), ("ref_frame_mvs", u8), ("screen_content_tools", cint),
    ("force_integer_mv", cint), ("order_hint_n_bits", u8), ("super_res", u8), ("cdef", u8),
    ("restoration", u8), ("ss_hor", u8), ("ss_ver", u8), ("monochrome", u8),
    ("color_description_present", u8), ("separate_uv_delta_q", u8), ("film_grain_present", u8),
    ("operating_parameter_info", _OP_PARAM * 32)])
_GRAIN = _struct("Dav1dFilmGrainData", [
    ("seed", ctypes.c_uint), ("num_y_points", cint), ("y_points", u8 * 28),
    ("chroma_scaling_from_luma", cint), ("num_uv_points", cint * 2), ("uv_points", u8 * 40),
    ("scaling_shift", cint), ("ar_coeff_lag", cint), ("ar_coeffs_y", i8 * 24),
    ("ar_coeffs_uv", i8 * 56), ("ar_coeff_shift", u64), ("grain_scale_shift", cint),
    ("uv_mult", cint * 2), ("uv_luma_mult", cint * 2), ("uv_offset", cint * 2),
    ("overlap_flag", cint), ("clip_to_restricted_range", cint)])
_SEGMENT = _struct("Dav1dSegmentationData", [
    ("delta_q", i16), ("delta_lf_y_v", i8), ("delta_lf_y_h", i8), ("delta_lf_u", i8),
    ("delta_lf_v", i8), ("ref", i8), ("skip", u8), ("globalmv", u8)])
_WARP = _struct("Dav1dWarpedMotionParams", [("type", cint), ("matrix", ctypes.c_int32 * 6),
                                            ("abcd", i16 * 4)])
FRAME_HEADER = _struct("Dav1dFrameHeader", [
    ("film_grain", _struct("film_grain", [("data", _GRAIN), ("present", u8), ("update", u8)])),
    ("frame_type", cint), ("width", cint * 2), ("height", cint), ("frame_offset", u8),
    ("temporal_id", u8), ("spatial_id", u8), ("show_existing_frame", u8),
    ("existing_frame_idx", u8), ("frame_id", u32), ("frame_presentation_delay", u32),
    ("show_frame", u8), ("showable_frame", u8), ("error_resilient_mode", u8),
    ("disable_cdf_update", u8), ("allow_screen_content_tools", u8), ("force_integer_mv", u8),
    ("frame_size_override", u8), ("primary_ref_frame", u8), ("buffer_removal_time_present", u8),
    ("operating_points", u32 * 32), ("refresh_frame_flags", u8), ("render_width", cint),
    ("render_height", cint),
    ("super_res", _struct("super_res", [("width_scale_denominator", u8), ("enabled", u8)])),
    ("have_render_size", u8), ("allow_intrabc", u8), ("frame_ref_short_signaling", u8),
    ("refidx", i8 * 7), ("hp", u8), ("subpel_filter_mode", cint), ("switchable_motion_mode", u8),
    ("use_ref_frame_mvs", u8), ("refresh_context", u8),
    ("tiling", _struct("tiling", [
        ("uniform", u8), ("n_bytes", u8), ("min_log2_cols", u8), ("max_log2_cols", u8),
        ("log2_cols", u8), ("cols", u8), ("min_log2_rows", u8), ("max_log2_rows", u8),
        ("log2_rows", u8), ("rows", u8), ("col_start_sb", u16 * 65), ("row_start_sb", u16 * 65),
        ("update", u16)])),
    ("quant", _struct("quant", [
        ("yac", u8), ("ydc_delta", i8), ("udc_delta", i8), ("uac_delta", i8), ("vdc_delta", i8),
        ("vac_delta", i8), ("qm", u8), ("qm_y", u8), ("qm_u", u8), ("qm_v", u8)])),
    ("segmentation", _struct("segmentation", [
        ("enabled", u8), ("update_map", u8), ("temporal", u8), ("update_data", u8),
        ("d", _SEGMENT * 8), ("preskip", u8), ("last_active_segid", i8), ("lossless", u8 * 8),
        ("qidx", u8 * 8)])),
    ("delta", _struct("delta", [("q_present", u8), ("q_res_log2", u8), ("lf_present", u8),
                                ("lf_res_log2", u8), ("lf_multi", u8)])),
    ("all_lossless", u8),
    ("loopfilter", _struct("loopfilter", [
        ("level_y", u8 * 2), ("level_u", u8), ("level_v", u8), ("mode_ref_delta_enabled", u8),
        ("mode_ref_delta_update", u8), ("mode_delta", i8 * 2), ("ref_delta", i8 * 8),
        ("sharpness", u8)])),
    ("cdef", _struct("cdef", [("damping", u8), ("n_bits", u8), ("y_strength", u8 * 8),
                              ("uv_strength", u8 * 8)])),
    ("restoration", _struct("restoration", [("type", cint * 3), ("unit_size", u8 * 2)])),
    ("txfm_mode", cint), ("switchable_comp_refs", u8), ("skip_mode_allowed", u8),
    ("skip_mode_enabled", u8), ("skip_mode_refs", i8 * 2), ("warp_motion", u8),
    ("reduced_txtp_set", u8), ("gmv", _WARP * 7)])

_RESTORATION = ("NONE", "SWITCHABLE", "WIENER", "SGRPROJ")  # enum Dav1dRestorationType
_TX_MODE = ("ONLY_4X4", "TX_MODE_LARGEST", "TX_MODE_SELECT")  # enum Dav1dTxfmMode


def _library():
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
    vp = ctypes.c_void_p
    lib.dav1d_version.restype = ctypes.c_char_p
    lib.dav1d_data_create.restype = vp
    lib.dav1d_data_create.argtypes = [vp, ctypes.c_size_t]
    for name in ("dav1d_default_settings", "dav1d_picture_unref", "dav1d_data_unref",
                 "dav1d_close"):
        getattr(lib, name).argtypes = [vp]
    lib.dav1d_open.argtypes = lib.dav1d_send_data.argtypes = [vp, vp]
    lib.dav1d_get_picture.argtypes = [vp, vp]
    assert lib.dav1d_version().startswith(b"1.5.") and lib.dav1d_version_api() >> 16 == 7
    return lib


def _sequence(seq) -> dict:
    return dict(profile=seq.profile, still_picture=seq.still_picture,
                reduced=seq.reduced_still_picture_header, max_width=seq.max_width,
                max_height=seq.max_height, sb128=seq.sb128, filter_intra=seq.filter_intra,
                intra_edge=seq.intra_edge_filter, superres=seq.super_res, cdef=seq.cdef,
                restoration=seq.restoration, depth=8 + 2 * seq.hbd, mono=seq.monochrome,
                primaries=seq.pri, transfer=seq.trc, matrix=seq.mtrx, full_range=seq.color_range,
                ssx=seq.ss_hor, ssy=seq.ss_ver, csp=seq.chr,
                separate_uv_dq=seq.separate_uv_delta_q, film_grain=seq.film_grain_present)


def _frame(fh, seq) -> dict:
    t, q = fh.tiling, fh.quant
    cdef_read = seq.cdef and not (fh.all_lossless or fh.allow_intrabc)
    return dict(
        size=[fh.width[0], fh.height], render=[fh.render_width, fh.render_height],
        upscaled_width=fh.width[1], superres=fh.super_res.width_scale_denominator,
        intrabc=fh.allow_intrabc,
        # dav1d leaves n_bytes 0 where one tile has no tile_size_bytes
        tiles=dict(cols=t.cols, rows=t.rows, cols_log2=t.log2_cols, rows_log2=t.log2_rows,
                   size_bytes=t.n_bytes),
        quant=dict(base=q.yac, y_dc=q.ydc_delta, u_dc=q.udc_delta, u_ac=q.uac_delta,
                   v_dc=q.vdc_delta, v_ac=q.vac_delta, qmatrix=q.qm),
        segmentation=fh.segmentation.enabled,
        delta=dict(q=[fh.delta.q_present, fh.delta.q_res_log2],
                   lf=[fh.delta.lf_present, fh.delta.lf_res_log2, fh.delta.lf_multi]),
        loop_filter=[fh.loopfilter.level_y[0], fh.loopfilter.level_y[1], fh.loopfilter.level_u,
                     fh.loopfilter.level_v],
        sharpness=fh.loopfilter.sharpness,
        cdef=dict(bits=fh.cdef.n_bits, damping=fh.cdef.damping, strengths=[
            [fh.cdef.y_strength[i] >> 2, fh.cdef.y_strength[i] & 3,
             fh.cdef.uv_strength[i] >> 2, fh.cdef.uv_strength[i] & 3]
            for i in range(1 << fh.cdef.n_bits)]) if cdef_read else None,
        restoration=[_RESTORATION[k] for k in fh.restoration.type][: 1 if seq.monochrome else 3],
        tx_mode=_TX_MODE[fh.txfm_mode], reduced_tx_set=fh.reduced_txtp_set,
        film_grain=bool(fh.film_grain.present), coded_lossless=bool(fh.all_lossless))


def dav1d_record(payload: bytes) -> dict:
    """One AV1 payload decoded by dav1d (one thread, no frame delay) ->
    {"sequence", "frame"} of its first picture, in header_record's names,
    and "picture": [width, height, layout, bits per component]."""
    lib = _library()
    settings = ctypes.create_string_buffer(1024)  # Dav1dSettings, 100 bytes in 1.5.1
    lib.dav1d_default_settings(settings)
    ctypes.c_int.from_buffer(settings, 0).value = 1  # n_threads
    ctypes.c_int.from_buffer(settings, 4).value = 1  # max_frame_delay
    ctx = ctypes.c_void_p()
    if lib.dav1d_open(ctypes.byref(ctx), settings) != 0:
        raise RuntimeError("dav1d_open failed")
    data = ctypes.create_string_buffer(256)  # Dav1dData
    picture = ctypes.create_string_buffer(1024)  # Dav1dPicture
    try:
        ptr = lib.dav1d_data_create(data, len(payload))
        ctypes.memmove(ptr, payload, len(payload))
        for _ in range(64):
            if ctypes.c_size_t.from_buffer(data, 8).value:  # bytes not yet taken
                r = lib.dav1d_send_data(ctx, data)
                if r not in (0, EAGAIN):
                    raise RuntimeError(f"dav1d_send_data: {r}")
            r = lib.dav1d_get_picture(ctx, picture)
            if r == 0:
                break
            if r != EAGAIN:
                raise RuntimeError(f"dav1d_get_picture: {r}")
        else:
            raise RuntimeError("dav1d gave no picture")
        try:
            seq = SEQUENCE_HEADER.from_address(ctypes.c_void_p.from_buffer(picture, 0).value)
            fh = FRAME_HEADER.from_address(ctypes.c_void_p.from_buffer(picture, 8).value)
            return dict(sequence=_sequence(seq), frame=_frame(fh, seq),
                        picture=list((ctypes.c_int * 4).from_buffer(picture, 56)))
        finally:
            lib.dav1d_picture_unref(picture)
    finally:
        lib.dav1d_data_unref(data)
        lib.dav1d_close(ctypes.byref(ctx))
