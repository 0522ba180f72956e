"""Training of the port: the stage-0 [D, G] step (losses, optimisers, EMA)."""
