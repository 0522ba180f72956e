"""Measurement scripts for the port's kernels; each runs on a machine with a card."""
