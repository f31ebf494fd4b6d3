"""The frozen plain-PyTorch reference of every configuration, in float32.
It imports torch alone: never the program under test, never JAX."""
