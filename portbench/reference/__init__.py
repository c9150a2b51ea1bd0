"""The plain reference of the benchmark's melts: NumPy and plain PyTorch,
importing nothing of the program it judges."""
