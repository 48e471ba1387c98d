"""The plain reference: float32 PyTorch that imports nothing of the program
under test."""
