"""Plain references the output comparison holds the port to: PyTorch and
NumPy only, nothing of the port."""
