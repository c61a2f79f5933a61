"""Models: FCN-32s, its support-pruned blocks and the JAX weight bridge."""
