"""The plain reference that decides `correct`: numpy and plain PyTorch,
importing nothing of the program under test."""
