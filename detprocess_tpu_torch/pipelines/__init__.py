"""Processing steps built from the ops."""
