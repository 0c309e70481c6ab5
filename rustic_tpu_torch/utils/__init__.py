"""Host-side image codecs of the port: NumPy, and the WebP decoder's
entropy loops in host C++ (csrc/image_entropy.cpp)."""

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"
