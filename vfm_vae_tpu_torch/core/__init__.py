"""Training-side utilities of the port."""
