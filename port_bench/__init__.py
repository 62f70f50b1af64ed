"""The PyTorch port's benchmark (see run.py)."""
