"""The five model families' decode paths, and the JAX parameter bridge."""
