"""Host-side image codecs of the port (NumPy only)."""

# what a refusal of an image variant points at
FORMATS_TODO = "ROADMAP.md queue 3: image variants the port refuses"
