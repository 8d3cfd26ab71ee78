"""The plain reference: float64 PyTorch that imports nothing of the
program under test."""
