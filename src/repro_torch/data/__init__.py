"""Synthetic attributed-vector datasets of the PyTorch port."""
