"""Host-side image codecs of the port: NumPy, and in host C++ the WebP
and JPEG decoders' entropy loops, the QOI op loop and the run-length
loops of the legacy formats (csrc/image_entropy.cpp), the JPEG 2000
decoder's tier-1 (csrc/jpeg2000_t1.cpp), and the DDS decoder's BC6H and BC7 blocks with
the PSD decoder's PackBits rows (csrc/bcn_decode.cpp). The DDS (dds.py)
and PSD (psd.py) decoders sit beside the others, with PNM (pnm.py), QOI
(qoi.py), ICO and CUR (ico.py), PCX and DCX (pcx.py), SGI (sgi.py), and
the legacy formats: IM and IMT (im.py), IPTC (iptc.py), PCD (pcd.py),
SPIDER (spider.py), BLP (blp.py), FITS (fits.py), FLI and FLC (fli.py),
FTEX (ftex.py), GBR (gbr.py), ICNS (icns.py), MCIDAS (mcidas.py), MSP
(msp.py), PIXAR (pixar.py), SUN (sun.py), XBM (xbm.py), XPM (xpm.py) and
XVThumb (xvthumb.py); utils/png.py tries them in Pillow's order."""

import struct

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"

# the errors of a plugin's header reader that make Pillow's Image.open try the next plugin
# (ImageFile.__init__ turns the last five into SyntaxError; Image.open catches that)
PASSED_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)


class NotThisFormat(Exception):
    """A header that Pillow's plugin turns away with SyntaxError,
    IndexError, TypeError, KeyError, EOFError or struct.error (or a size
    of zero): `Image.open` then passes the file on to the next plugin, and
    so does utils/png.py `image_format`. Any other refusal ends the open."""


def read_header(read, raw: bytes):
    """`read(raw)`, a port of a Pillow header reader that raises what
    Pillow's raises: the errors in PASSED_ON become NotThisFormat, an
    OSError a ValueError (it ends the open, as in Pillow). utils/png.py
    runs every plugin's header reader under this rule."""
    try:
        return read(raw)
    except PASSED_ON as e:
        raise NotThisFormat(f"{type(e).__name__}: {e}") from e
    except OSError as e:
        raise ValueError(f"{type(e).__name__}: {e}") from e
