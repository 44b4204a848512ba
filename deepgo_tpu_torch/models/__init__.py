"""Models: the policy CNN, the value CNN, weight conversion from the JAX
layout, and the serving forwards."""
