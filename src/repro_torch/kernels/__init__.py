"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers
(``hamming``, ``adc_lookup``, ``bitpack``, ``ssd``), plain PyTorch twins
(``ref``) and the dispatch layer (``ops``). No kernel is built or loaded at
import time."""
