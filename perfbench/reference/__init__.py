"""The plain reference the benchmark holds the program's answers against.

Plain NumPy (the index build) and plain PyTorch (the search, on any
device), independent of the program: nothing here imports ``repro_torch``,
``repro`` or ``jax``. It builds its own index from the corpus the harness
made and answers each batch with SQUASH's stages written out directly.
"""
