"""Modules of the port (NHWC activations, reference torch state_dict keys)."""
