"""Host-side image codecs of the port: NumPy, and in host C++ the WebP
decoder's entropy loops (csrc/image_entropy.cpp) and the JPEG 2000
decoder's tier-1 (csrc/jpeg2000_t1.cpp)."""

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"
