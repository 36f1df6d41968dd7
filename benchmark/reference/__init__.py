"""Plain references of the model families, in plain PyTorch; they import
neither the port nor JAX nor the JAX package."""
