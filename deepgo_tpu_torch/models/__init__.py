"""Models: the policy CNN, weight conversion from the JAX layout, and the
serving forwards."""
