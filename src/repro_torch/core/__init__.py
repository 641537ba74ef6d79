"""SQUASH system core of the PyTorch port: index build + batched query plane."""
