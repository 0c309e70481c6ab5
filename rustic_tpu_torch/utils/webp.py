"""A NumPy WebP decoder for scene textures and LDR skyboxes: the RIFF
container, the ALPH alpha plane and the lossless (VP8L) bitstream; the
lossy (VP8) bitstream is utils/vp8.py.

The JAX package reads WebP through Pillow, which decodes with libwebp
1.6.0's `WebPAnimDecoder` in `MODE_RGBA` and default options;
`decode_webp` gives the same uint8 [H, W, 4]. It reads a simple file
(one "VP8 " or "VP8L" chunk) and an extended one ("VP8X", its ICCP, EXIF
and XMP chunks skipped, an ALPH chunk beside a lossy image: raw or
VP8L-coded, under its none, horizontal, vertical or gradient filter).
Where the file says it has no alpha, Pillow opens it as "RGB" and the
alpha is 255. An animated file (VP8X's animation flag, ANIM, ANMF
frames) shows its first frame as `WebPAnimDecoder` composes it: a key
frame on a canvas of VP8X's size that starts transparent black, decoded
into its rectangle (at twice the stored X and Y offsets, of the stored
size plus one) with its own alpha (ALPH or VP8L's), the background colour
and the blending and disposal flags unused by a first frame. ANMF chunks
in a file without the animation flag raise NotImplementedError; so does
a lossy frame that is not a key frame (utils/vp8.py).

VP8L is read in full: the predictor transform with its 14 modes, the
cross-colour, subtract-green and colour-indexing transforms (pixel
bundling included), meta Huffman codes chosen per block from the entropy
image, the colour cache, and LZ77 back-references with the 120-entry
distance map. The header, the transforms' headers and the Huffman codes
are read here; the pixel loop, the serial entropy decode, is host C++
(csrc/image_entropy.cpp, built by g++ at first use). The transforms run
over whole images, the predictor's over one anti-diagonal of pixels at a
time (a pixel needs its left, top-left, top and top-right neighbours:
x + 2y orders them).
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import note_core
from rustic_tpu_torch.utils.vp8 import decode_vp8

# the distance map of VP8L back-references: (dx, dy) of the 120 short codes
_PLANE = [
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2),
    (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2),
    (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2),
    (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1),
    (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6),
    (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5),
    (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5),
    (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7),
    (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
]
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _refuse(variant: str):
    raise NotImplementedError(f"WebP {variant} is not decoded ({FORMATS_TODO})")


class _Bits:
    """VP8L's bit reader: least significant bit first."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(32)  # room for the C++ loop's 8-byte reads past the end
        b = np.frombuffer(self.data, np.uint8).astype(np.uint64)
        n = len(data) + 1
        w = np.zeros(n, np.uint64)
        for i in range(7, -1, -1):
            w = (w << np.uint64(8)) | b[i : i + n]
        self.words = w.tolist()  # the 64 bits from byte i, little-endian
        self.p = 0
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.p
        self.p = p + n
        return (self.words[p >> 3] >> (p & 7)) & ((1 << n) - 1)


def _huffman_table(lengths) -> tuple:
    """Code lengths (0: unused) -> (the bits it indexes, a list: the next
    `bits` bits of the stream -> length << 16 | symbol). A code of one
    symbol takes no bits, as libwebp builds it."""
    lengths = np.asarray(lengths, np.int64)
    used = np.flatnonzero(lengths)
    if len(used) == 0:
        raise ValueError("VP8L Huffman code has no symbols")
    if len(used) == 1:
        return 0, [int(used[0])]
    ln = lengths[used]
    order = np.lexsort((used, ln))
    sym, ln = used[order], ln[order]
    if np.sum(2.0 ** -ln) != 1.0:
        raise ValueError("VP8L Huffman code is not complete")
    bits = int(ln.max())
    # canonical codes: each is the previous + 1, shifted left where the length grows
    code = np.zeros(len(sym), np.int64)
    for i in range(1, len(sym)):
        code[i] = (code[i - 1] + 1) << (ln[i] - ln[i - 1])
    rev = np.zeros_like(code)  # the stream gives a code's first bit first: reverse it
    for i in range(bits):
        rev |= ((code >> i) & 1) << np.maximum(ln - 1 - i, 0)
    reps = 1 << (bits - ln)
    start = np.repeat(np.cumsum(reps) - reps, reps)
    k = np.arange(int(reps.sum())) - start
    index = np.repeat(rev, reps) + (k << np.repeat(ln, reps))
    table = np.zeros(1 << bits, np.int64)
    table[index] = np.repeat(ln << 16 | sym, reps)
    return bits, table.tolist()


def _read_code(br: _Bits, size: int) -> tuple:
    """One Huffman code of an alphabet of `size` symbols -> its table."""
    lengths = [0] * size
    if br.read(1):  # simple: one or two symbols
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if two:
            lengths[br.read(8)] = 1
        return _huffman_table(lengths)
    count = br.read(4) + 4
    cl = [0] * 19
    for i in range(count):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    bits, table = _huffman_table(cl)
    limit = size
    if br.read(1):
        n = 2 + 2 * br.read(3)
        limit = 2 + br.read(n)
        if limit > size:
            raise ValueError("VP8L code length count beyond the alphabet")
    prev, sym = 8, 0
    while sym < size and limit > 0:
        limit -= 1
        e = table[(br.words[br.p >> 3] >> (br.p & 7)) & ((1 << bits) - 1)] if bits else table[0]
        br.p += e >> 16
        v = e & 0xFFFF
        if v < 16:
            lengths[sym] = v
            sym += 1
            if v:
                prev = v
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[v - 16]
        repeat = br.read(extra) + offset
        if sym + repeat > size:
            raise ValueError("VP8L code lengths run past the alphabet")
        value = prev if v == 16 else 0
        lengths[sym : sym + repeat] = [value] * repeat
        sym += repeat
    return _huffman_table(lengths)


def _read_codes(br: _Bits, width: int, height: int, level0: bool):
    """An entropy-coded image's colour cache bits, its entropy image where
    `level0` allows one (meta bits, blocks a row, each block's group) and
    its Huffman groups (five tables each)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"VP8L colour cache of {cache_bits} bits")
    meta_bits, meta_w, meta = 0, 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = -(-width // (1 << meta_bits))
        mh = -(-height // (1 << meta_bits))
        meta = (_decode_pixels(br, meta_w, mh, False) >> 8) & 0xFFFF
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, s) for s in (280 + cache_size, 256, 256, 256, 40)]
              for _ in range(int(meta.max()) + 1 if meta is not None else 1)]
    return cache_bits, meta_bits, meta_w, meta, groups


def _decode_pixels(br: _Bits, width: int, height: int, level0: bool) -> np.ndarray:
    """One entropy-coded image (the colour cache bit, the meta codes where
    `level0`, the codes; the pixel loop in C++, csrc/image_entropy.cpp) ->
    its ARGB values, uint32 [width * height]."""
    cache_bits, meta_bits, meta_w, meta, groups = _read_codes(br, width, height, level0)
    tables, offsets, bits = [], [], []
    at = 0
    for group in groups:
        for b, table in group:
            bits.append(b)
            offsets.append(at)
            tables.append(np.asarray(table, np.int32))
            at += len(table)
    data = np.frombuffer(br.data, np.uint8)
    out = np.empty(width * height, np.uint32)
    meta = None if meta is None else np.ascontiguousarray(meta, np.int32)
    bits, offsets = np.asarray(bits, np.int32), np.asarray(offsets, np.int64)
    tables = np.concatenate(tables)
    end = _entropy.library().vp8l_pixels(
        ptr(data), br.end // 8, br.p, width, height, ptr(bits), ptr(offsets), ptr(tables),
        ptr(meta), meta_bits, meta_w, cache_bits, ptr(out))
    if end < 0:
        raise ValueError({-1: "VP8L back-reference out of the image",
                          -2: "VP8L colour cache code without a cache"}.get(end, "VP8L data ends early"))
    if end > br.end:
        raise ValueError("VP8L data ends early")
    br.p = end
    return out


def _channels(argb) -> np.ndarray:
    """Flat ARGB ints -> uint8 [N, 4] as (A, R, G, B)."""
    v = np.asarray(argb, np.uint32)
    return np.stack([v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)


def _avg(a, b):
    return (a + b) >> 1


def _unpredict(res: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """The predictor transform undone: residuals int32 [H, W, 4] (A, R, G,
    B) and each pixel's mode [H, W] -> pixels, one anti-diagonal
    (x + 2y constant) at a time."""
    h, w, _ = res.shape
    out = np.zeros((h * w + 1, 4), np.int32)  # the last row: a zero pixel for missing neighbours
    flat = res.reshape(-1, 4)
    y, x = np.mgrid[0:h, 0:w]
    m = modes.copy()
    m[0, :] = 1  # the top row predicts from the left, the left column from the top
    m[:, 0] = 2
    m[0, 0] = 0
    idx, pad = y * w + x, h * w
    left = np.where(x > 0, idx - 1, pad).reshape(-1)
    top = np.where(y > 0, idx - w, pad).reshape(-1)
    tl = np.where((x > 0) & (y > 0), idx - w - 1, pad).reshape(-1)
    # top-right; on the rightmost column, the leftmost pixel of the current row
    tr = np.where(y > 0, np.where(x < w - 1, idx - w + 1, y * w), pad).reshape(-1)
    t = (x + 2 * y).reshape(-1)
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(t.max() + 2))
    m = m.reshape(-1)
    black = np.array([255, 0, 0, 0], np.int32)
    for s in range(len(bounds) - 1):
        i = order[bounds[s] : bounds[s + 1]]
        L, T, TL, TR = out[left[i]], out[top[i]], out[tl[i]], out[tr[i]]
        mode = m[i]
        grad = np.clip(L + T - TL, 0, 255)
        avg = _avg(L, T)
        half = avg + (avg - TL) // 2
        half = np.clip(np.where(avg - TL < 0, avg + -((TL - avg) // 2), half), 0, 255)
        pick_l = (np.abs(T - TL).sum(-1) < np.abs(L - TL).sum(-1))[:, None]
        cands = np.stack([np.broadcast_to(black, L.shape), L, T, TR, TL,
                          _avg(_avg(L, TR), T), _avg(L, TL), avg, _avg(TL, T), _avg(T, TR),
                          _avg(_avg(L, TL), _avg(T, TR)), np.where(pick_l, L, T), grad, half,
                          np.broadcast_to(black, L.shape), np.broadcast_to(black, L.shape)])
        pred = cands[mode, np.arange(len(i))]
        out[i] = (pred + flat[i]) & 255
    return out[:-1].reshape(h, w, 4)


def _cross_colour(px: np.ndarray, mult: np.ndarray) -> np.ndarray:
    """The colour transform undone: px int32 [H, W, 4] (A, R, G, B) and
    each pixel's multipliers (green to red, green to blue, red to blue)."""
    def delta(t, c):
        t = np.where(t >= 128, t - 256, t)
        c = np.where(c >= 128, c - 256, c)
        return (t * c) >> 5

    g = px[..., 2]
    red = (px[..., 1] + delta(mult[..., 0], g)) & 255
    blue = (px[..., 3] + delta(mult[..., 1], g) + delta(mult[..., 2], red)) & 255
    out = px.copy()
    out[..., 1] = red
    out[..., 3] = blue
    return out


def _block_values(sub: np.ndarray, bits: int, h: int, w: int) -> np.ndarray:
    """A transform's sub-image [ceil(h / 2^bits), ceil(w / 2^bits), 4] ->
    each pixel's entry [h, w, 4]."""
    return sub[(np.arange(h) >> bits)[:, None], (np.arange(w) >> bits)[None, :]]


def _invert(kind: int, px: np.ndarray, tw: int, bits: int, sub) -> np.ndarray:
    """One transform undone: predictor (0), cross-colour (1), subtract
    green (2) or colour indexing (3) of an image `tw` wide (before the
    transform's pixel bundling) -> int32 [H, tw, 4] (A, R, G, B)."""
    height = px.shape[0]
    if kind == 0:
        modes = _block_values(sub, bits, height, tw)[..., 2] & 15
        return _unpredict(px, modes.astype(np.int64))
    if kind == 1:
        s = _block_values(sub, bits, height, tw).astype(np.int32)
        return _cross_colour(px, np.stack([s[..., 3], s[..., 2], s[..., 1]], -1))
    if kind == 2:
        px = px.copy()
        px[..., 1] = (px[..., 1] + px[..., 2]) & 255
        px[..., 3] = (px[..., 3] + px[..., 2]) & 255
        return px
    x = np.arange(tw)  # colour indexing: 8 >> bits of index a pixel, packed in green
    packed = px[:, x >> bits, 2]
    index = (packed >> ((x & ((1 << bits) - 1)) * (8 >> bits))) & ((1 << (8 >> bits)) - 1)
    return sub[index].astype(np.int32)


def decode_vp8l(data: bytes, width: int = 0, height: int = 0) -> np.ndarray:
    """A VP8L bitstream -> uint8 [H, W, 4] (R, G, B, A). With `width` and
    `height` given, the stream has no header (the ALPH chunk's form)."""
    br = _Bits(data)
    if not width:
        if len(data) < 5 or data[0] != 0x2F:
            raise ValueError("not a VP8L bitstream")
        br.p = 8
        width, height = br.read(14) + 1, br.read(14) + 1
        br.read(1)  # alpha hint
        if br.read(3):
            raise ValueError("VP8L version is not 0")
    transforms = []
    xsize = width
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise ValueError("VP8L transform repeated")
        if kind in (0, 1):  # predictor, cross-colour: a sub-image of blocks
            bits = br.read(3) + 2
            sw, sh = -(-xsize // (1 << bits)), -(-height // (1 << bits))
            sub = _channels(_decode_pixels(br, sw, sh, False)).reshape(sh, sw, 4)
            transforms.append((kind, xsize, bits, sub))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:  # colour indexing: a palette, and pixels bundled 8, 4 or 2 a byte
            n = br.read(8) + 1
            pal = _channels(_decode_pixels(br, n, 1, False)).astype(np.int64)
            pal = np.cumsum(pal, axis=0) & 255  # each entry coded as its difference from the last
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            full = np.zeros((256, 4), np.uint8)  # indices past the palette: transparent black
            full[:n] = pal
            transforms.append((kind, xsize, bits, full))
            xsize = -(-xsize // (1 << bits))
    px = _channels(_decode_pixels(br, xsize, height, True)).reshape(height, xsize, 4)
    px = px.astype(np.int32)
    for kind, tw, bits, sub in reversed(transforms):
        px = _invert(kind, px, tw, bits, sub)
    argb = px.astype(np.uint8)
    return np.ascontiguousarray(argb[..., [1, 2, 3, 0]])


# ---- the alpha plane (ALPH) ----------------------------------------------------------------------

def unfilter_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk -> uint8 [H, W]: raw or VP8L-compressed, then its
    prediction filter undone (libwebp's filters.c)."""
    head = chunk[0]
    method, filt, pre = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or pre > 1 or head >> 6:
        raise ValueError(f"WebP ALPH header {head:#x}")
    if method == 0:
        a = np.frombuffer(chunk[1 : 1 + width * height], np.uint8)
        if len(a) < width * height:
            raise ValueError("WebP ALPH data is truncated")
        a = a.reshape(height, width).astype(np.int64)
    else:
        a = decode_vp8l(chunk[1:], width, height)[..., 1].astype(np.int64)
    if filt == 0:
        return a.astype(np.uint8)
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0]) & 255  # the first row: from the left, starting at 0
    if filt == 1:  # horizontal: each row starts from the pixel above its first
        first = np.cumsum(a[:, 0]) & 255
        rows = a.copy()
        rows[:, 0] = first
        out = np.cumsum(rows, axis=1) & 255
    elif filt == 2:  # vertical
        out[1:] = a[1:]
        out = np.cumsum(out, axis=0) & 255
    else:  # gradient: left + top - top-left clipped; one anti-diagonal at a time
        if height > 1:
            out[1:, 0] = a[1:, 0]
            out[:, 0] = np.cumsum(out[:, 0]) & 255
            for s in range(2, width + height - 1):
                y = np.arange(max(1, s - width + 1), min(height, s))
                x = s - y
                pred = np.clip(out[y, x - 1] + out[y - 1, x] - out[y - 1, x - 1], 0, 255)
                out[y, x] = (a[y, x] + pred) & 255
    return out.astype(np.uint8)


# ---- the container ---------------------------------------------------------------------------

def riff_chunks(raw: bytes):
    """The RIFF chunks after the WEBP tag -> [(fourcc, body)]."""
    out, pos = [], 12
    (riff,) = struct.unpack("<I", raw[4:8])
    end = min(len(raw), 8 + riff)
    while pos + 8 <= end:
        kind, size = raw[pos : pos + 4], struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        out.append((kind, raw[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def decode_webp(raw: bytes) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    raw = bytes(raw)
    if raw[:4] != b"RIFF" or raw[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    chunks = riff_chunks(raw)
    if not chunks:
        raise ValueError("WebP file has no chunks")
    kinds = [k for k, _ in chunks]
    has_alpha = None
    if kinds[0] == b"VP8X":
        flags = chunks[0][1][0]
        has_alpha = bool(flags & 0x10)
        if flags & 0x02:
            note_core("RGBA" if has_alpha else "RGB")
            return _first_frame(chunks, has_alpha)
        if b"ANIM" in kinds or b"ANMF" in kinds:
            _refuse("animation (ANIM/ANMF) without VP8X's animation flag")
    out, has_alpha = _still(chunks, has_alpha)
    note_core("RGBA" if has_alpha else "RGB")
    if not has_alpha:
        out[..., 3] = 255
    return out


def _u24(b: bytes, pos: int) -> int:
    return b[pos] | b[pos + 1] << 8 | b[pos + 2] << 16


def _first_frame(chunks, has_alpha: bool) -> np.ndarray:
    """An animated file's first frame on its canvas (WebPAnimDecoder's key
    frame: ZeroFillCanvas, then WebPDecode into the frame's rectangle)."""
    vp8x = chunks[0][1]
    if len(vp8x) < 10:
        raise ValueError("WebP VP8X chunk is cut short")
    width, height = _u24(vp8x, 4) + 1, _u24(vp8x, 7) + 1
    if not any(k == b"ANIM" for k, _ in chunks):
        raise ValueError("WebP animation has no ANIM chunk")
    frame = next((b for k, b in chunks if k == b"ANMF"), None)
    if frame is None or len(frame) < 16:
        raise ValueError("WebP animation has no frame")
    x, y = 2 * _u24(frame, 0), 2 * _u24(frame, 3)
    fw, fh = _u24(frame, 6) + 1, _u24(frame, 9) + 1
    if x + fw > width or y + fh > height:
        raise ValueError(f"WebP frame of {fw}x{fh} at ({x}, {y}) is outside its "
                         f"{width}x{height} canvas")
    sub = riff_chunks(b"RIFF" + struct.pack("<I", len(frame) - 12) + b"WEBP" + frame[16:])
    got, _ = _still(sub, True)
    if got.shape[:2] != (fh, fw):
        raise ValueError(f"WebP frame of {got.shape[1]}x{got.shape[0]} where its ANMF says "
                         f"{fw}x{fh}")
    out = np.zeros((height, width, 4), np.uint8)
    out[y : y + fh, x : x + fw] = got
    if not has_alpha:
        out[..., 3] = 255
    return out


def _still(chunks, has_alpha):
    """One image's "VP8 " (with its ALPH where `has_alpha`) or "VP8L" chunk
    -> (uint8 [H, W, 4] with its own alpha, whether the file has alpha:
    `has_alpha`, or where it is None VP8L's header hint)."""
    image = next(((k, b) for k, b in chunks if k in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise ValueError("WebP file has no image chunk")
    kind, body = image
    if kind == b"VP8L":
        out = decode_vp8l(body)
        if has_alpha is None:
            has_alpha = bool(body[4] & 0x10)  # the header's alpha hint
    else:
        out = decode_vp8(body)
        alph = next((b for k, b in chunks if k == b"ALPH"), None)
        if alph is not None and has_alpha:
            out[..., 3] = unfilter_alpha(alph, out.shape[1], out.shape[0])
    return out, bool(has_alpha)
