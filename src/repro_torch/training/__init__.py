"""Training substrate: optimizer, data pipeline, train step, checkpointing."""
