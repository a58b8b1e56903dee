"""Plain PyTorch references, one a configuration. They import nothing of
the program, nor JAX."""
