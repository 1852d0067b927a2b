"""Host-side models (pulse templates)."""
