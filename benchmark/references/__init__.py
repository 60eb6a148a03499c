"""Plain references: PyTorch and NumPy only, nothing of the program."""
