"""Plain PyTorch and NumPy references; nothing here imports the program."""
