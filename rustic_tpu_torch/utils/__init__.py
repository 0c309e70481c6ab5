"""Host-side image codecs of the port: NumPy, and in host C++ the WebP
decoder's entropy loops (csrc/image_entropy.cpp), the JPEG 2000
decoder's tier-1 (csrc/jpeg2000_t1.cpp), and the DDS decoder's BC6H and
BC7 blocks with the PSD decoder's PackBits rows (csrc/bcn_decode.cpp).
The DDS (dds.py) and PSD (psd.py) decoders sit beside the others."""

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"
