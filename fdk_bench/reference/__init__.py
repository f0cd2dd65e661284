"""The plain FDK that decides ``correct``: PyTorch and NumPy only, with
nothing of the program imported."""
