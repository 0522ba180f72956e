"""Tensor ops of the port (NHWC layout, torch channel order)."""
