"""Measurement scripts of the port's kernels (run on a card, by hand)."""
