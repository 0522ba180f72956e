"""Work splitting for the offline tools (one process per card)."""
