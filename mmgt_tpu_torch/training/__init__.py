"""Training loops of the port (Stage 2)."""
