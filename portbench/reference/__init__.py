"""Plain PyTorch/NumPy references that decide `correct`. They import
neither jax, the JAX package nor the port, and take nothing the port made."""
