"""Models: FCN-32s, its support-pruned blocks, the JAX weight bridge, the
reference checkpoint format (import, export) and VGG16 import."""
