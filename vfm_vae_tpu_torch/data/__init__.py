"""Input pipelines of the port (tar-shard streaming)."""
