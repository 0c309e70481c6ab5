"""Host-side image codecs of the port (NumPy only)."""
