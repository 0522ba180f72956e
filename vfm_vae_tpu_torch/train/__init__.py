"""Training of the port: the [D, G] step (losses, optimisers, EMA), the
training loop, snapshots and the CLI of the four-stage recipe."""
