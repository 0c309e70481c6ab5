"""A NumPy OpenEXR reader for HDR skyboxes.

The JAX package reads .exr skies through imageio; the port reads them
itself. `read_exr` takes single-part scanline files: channels of type
HALF, FLOAT or UINT, compression NONE, RLE, ZIPS or ZIP (zlib, after
OpenEXR's byte predictor and the split of each block into its even and
odd bytes). It returns the pixels of the data window, as OpenEXR's
reading API gives them: float32 [H, W, C] with C the channels R, G, B
(and A where the file has it), or Y alone. PIZ, PXR24, B44, B44A, DWAA
and DWAB compression, tiled, multi-part and deep files, subsampled
channels and other channel sets raise NotImplementedError naming the
variant.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO

EXR_MAGIC = b"\x76\x2f\x31\x01"
_COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB")
_LINES = {"NONE": 1, "RLE": 1, "ZIPS": 1, "ZIP": 16}  # the read ones: scanlines a block
_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}  # UINT, HALF, FLOAT
_TILED, _DEEP, _MULTIPART = 0x200, 0x800, 0x1000  # version flags
_LAYOUTS = (("R", "G", "B", "A"), ("R", "G", "B"), ("Y",))


def _refuse(variant: str):
    raise NotImplementedError(f"OpenEXR {variant} is not read ({FORMATS_TODO})")


def _cstr(raw: bytes, pos: int):
    end = raw.index(b"\x00", pos)
    return raw[pos:end].decode("latin-1"), end + 1


def _header(raw: bytes, pos: int):
    """The attributes from `pos` -> ({name: (type, value bytes)}, the
    position after the header's terminating null)."""
    attrs = {}
    while raw[pos] != 0:
        name, pos = _cstr(raw, pos)
        kind, pos = _cstr(raw, pos)
        (size,) = struct.unpack("<i", raw[pos : pos + 4])
        attrs[name] = (kind, raw[pos + 4 : pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _channels(value: bytes):
    """A chlist attribute -> [(name, pixel type)], in the file's order."""
    out, pos = [], 0
    while value[pos] != 0:
        name, pos = _cstr(value, pos)
        kind, _linear, xs, ys = struct.unpack("<iB3xii", value[pos : pos + 16])
        pos += 16
        if kind not in _TYPES:
            raise ValueError(f"OpenEXR channel {name} has pixel type {kind}")
        if (xs, ys) != (1, 1):
            _refuse(f"channel {name} subsampled {xs}x{ys}")
        out.append((name, kind))
    return out


def _rle_expand(data: bytes, size: int) -> bytes:
    """OpenEXR's run-length coding: a signed count byte; -n: n literal
    bytes follow; n >= 0: the next byte n + 1 times."""
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        count = data[pos] - 256 if data[pos] > 127 else data[pos]
        if count < 0:
            out += data[pos + 1 : pos + 1 - count]
            pos += 1 - count
        else:
            out += data[pos + 1 : pos + 2] * (count + 1)
            pos += 2
    if len(out) != size:
        raise ValueError("OpenEXR RLE block does not fill its scanlines")
    return bytes(out)


def _unpredict(data: bytes) -> bytes:
    """Undo the predictor (each byte the previous one + delta - 128) and
    the split into first and second halves, which interleave again."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    t = ((np.cumsum(d) - 128 * np.arange(len(d))) & 0xFF).astype(np.uint8)
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(raw: bytes) -> np.ndarray:
    """OpenEXR bytes -> float32 [H, W, C] (R, G, B[, A], or Y)."""
    if raw[:4] != EXR_MAGIC:
        raise ValueError("not an OpenEXR file")
    (version,) = struct.unpack("<I", raw[4:8])
    if version & 0xFF != 2:
        raise ValueError(f"OpenEXR version {version & 0xFF}")
    if version & _MULTIPART:
        _refuse("multi-part file")
    if version & _DEEP:
        _refuse("deep file")
    if version & _TILED:
        _refuse("tiled file")
    attrs, pos = _header(raw, 8)
    if "tiles" in attrs:
        _refuse("tiled file")
    code = attrs["compression"][1][0]
    compression = _COMPRESSIONS[code] if code < len(_COMPRESSIONS) else f"code {code}"
    if compression not in _LINES:
        _refuse(f"{compression} compression")
    channels = _channels(attrs["channels"][1])  # the order of each scanline's data
    names = tuple(n for n, _ in channels)
    order = next((layout for layout in _LAYOUTS if sorted(layout) == list(names)), None)
    if order is None:
        _refuse(f"channel set {names}")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    lines = _LINES[compression]
    n_blocks = -(-height // lines)
    offsets = struct.unpack(f"<{n_blocks}Q", raw[pos : pos + 8 * n_blocks])
    dtypes = [_TYPES[k] for _, k in channels]
    row_bytes = sum(width * t.itemsize for t in dtypes)
    planes = [np.zeros((height, width), np.float32) for _ in channels]
    for off in offsets:
        y, size = struct.unpack("<ii", raw[off : off + 8])
        data = raw[off + 8 : off + 8 + size]
        n = min(lines, y1 + 1 - y)
        expect = n * row_bytes
        if size < expect:  # a block that did not shrink is stored as it is
            if compression == "RLE":
                data = _unpredict(_rle_expand(data, expect))
            elif compression in ("ZIPS", "ZIP"):
                data = _unpredict(zlib.decompress(data))
        if len(data) != expect:
            raise ValueError(f"OpenEXR block at y={y} holds {len(data)} bytes, not {expect}")
        at = 0
        for row in range(n):  # each scanline: every channel's samples in turn
            for plane, t in zip(planes, dtypes):
                count = width * t.itemsize
                plane[y - y0 + row] = np.frombuffer(data, t, width, at)
                at += count
    by_name = dict(zip(names, planes))
    return np.stack([by_name[c] for c in order], axis=-1)
