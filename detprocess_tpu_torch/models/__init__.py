"""Host-side models (pulse templates, the dIdV template conversion)."""
