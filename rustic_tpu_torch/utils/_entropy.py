"""The host C++ loops of the image decoders: the WebP decoder's entropy
loops, the QOI op loop, the FLI, SUN, ICNS and MSP run-length loops and
IM's n-bit samples, the JPEG decoder's entropy loops, the CCITT fax rows
and the .xz / LZMA2 strips of TIFF and the BMP RLE8 / RLE4 loop (csrc/image_entropy.cpp), the JPEG 2000 tier-1 decoder
(csrc/jpeg2000_t1.cpp), the BC6H / BC7 blocks of the DDS decoder and
the PackBits rows of the PSD decoder (csrc/bcn_decode.cpp), and the AV1
tile decoder of AVIF's lossless key frames (csrc/av1_intra.cpp), each built by g++
at first use (ops/_build.py `compile_host`; a missing or failing g++
raises with the compiler's message) and loaded with ctypes."""

from __future__ import annotations

import ctypes
import functools
import os

from rustic_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.compile_host(os.path.join(_build.CSRC, "image_entropy.cpp")))
    p, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    lib.vp8_macroblocks.restype = i32
    lib.vp8_macroblocks.argtypes = [p, i64, i64, u64, i32, i32, p, p, i32, i32, i32, i32, p, i32,
                                    i32, p, p, p] + [p] * 8
    lib.vp8l_pixels.restype = i64
    lib.vp8l_pixels.argtypes = [p, i64, i64, i32, i32, p, p, p, p, i32, i32, i32, p]
    lib.qoi_pixels.restype = i64
    lib.qoi_pixels.argtypes = [p, i64, i64, i64, i32, p]
    lib.fli_frame.restype = i32
    lib.fli_frame.argtypes = [p, i64, i32, i32, p]
    lib.sun_rle.restype = i32
    lib.sun_rle.argtypes = [p, i64, i64, i64, p]
    lib.icns_rle.restype = i64
    lib.icns_rle.argtypes = [p, i64, i64, i64, p, p]
    lib.msp_rows.restype = i64
    lib.msp_rows.argtypes = [p, i64, i64, p, i64, i64, p, i64]
    lib.im_bits.restype = i32
    lib.im_bits.argtypes = [p, i64, i32, i32, i32, p]
    lib.jpeg_scan.restype = i64
    lib.jpeg_scan.argtypes = [p, i64, i64, p, p, p, p, p, p]
    lib.jpeg_lossless_scan.restype = i64
    lib.jpeg_lossless_scan.argtypes = [p, i64, i64, p, p, p, p, p]
    lib.ccitt_rows.restype = i32
    lib.ccitt_rows.argtypes = [p, i64, i32, i32, i32, i32, p, p, p]
    lib.ccitt_nruns.restype = i64
    lib.ccitt_nruns.argtypes = [i32, i32]
    lib.bmp_rle.restype = i64
    lib.bmp_rle.argtypes = [p, i64, i64, i64, i64, i32, p, i64]
    lib.xz_strip.restype = i64
    lib.xz_strip.argtypes = [p, i64, p, i64]
    return lib


@functools.lru_cache(maxsize=None)
def j2k_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.compile_host(os.path.join(_build.CSRC, "jpeg2000_t1.cpp")))
    p = ctypes.c_void_p
    lib.j2k_codeblocks.restype = ctypes.c_int
    lib.j2k_codeblocks.argtypes = [p, ctypes.c_int64, p, p]
    return lib


@functools.lru_cache(maxsize=None)
def bcn_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.compile_host(os.path.join(_build.CSRC, "bcn_decode.cpp")))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bcn_blocks.restype = ctypes.c_int
    lib.bcn_blocks.argtypes = [p, i64, ctypes.c_int, p]
    lib.packbits_rows.restype = i64
    lib.packbits_rows.argtypes = [p, i64, i64, i64, p]
    return lib


@functools.lru_cache(maxsize=None)
def av1_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build.compile_host(os.path.join(_build.CSRC, "av1_intra.cpp")))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.av1_decode_tiles.restype = i32
    lib.av1_decode_tiles.argtypes = [p, i64, p, p, i32, p, p, p, p, ctypes.c_char_p, i32]
    lib.av1_counter_count.restype = i32
    return lib


def ptr(a) -> int:
    """The address of a C-contiguous NumPy array (or None)."""
    return None if a is None else a.ctypes.data
