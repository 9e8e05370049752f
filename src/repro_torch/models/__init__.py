"""The dense model family's decode path, and the JAX parameter bridge."""
