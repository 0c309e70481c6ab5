"""Host-side image codecs of the port: NumPy, and in host C++ the WebP
decoder's entropy loops and the QOI op loop (csrc/image_entropy.cpp),
the JPEG 2000 decoder's tier-1 (csrc/jpeg2000_t1.cpp), and the DDS
decoder's BC6H and BC7 blocks with the PSD decoder's PackBits rows
(csrc/bcn_decode.cpp). The DDS (dds.py) and PSD (psd.py) decoders sit
beside the others, with PNM (pnm.py), QOI (qoi.py), ICO and CUR (ico.py),
PCX and DCX (pcx.py) and SGI (sgi.py); utils/png.py tries them in Pillow's
order."""

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"


class NotThisFormat(Exception):
    """A header that Pillow's plugin turns away with SyntaxError,
    IndexError, TypeError, KeyError, EOFError or struct.error (or a size
    of zero): `Image.open` then passes the file on to the next plugin, and
    so does utils/png.py `image_format`. Any other refusal ends the open."""
