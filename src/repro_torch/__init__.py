"""PyTorch + CUDA port of the SQUASH reproduction (the JAX package ``repro``
stays beside it as the reference).

The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro`` — and mirrors the reference's module names:

* ``repro_torch.core`` — index build (NumPy, bit-for-bit copies of the
  reference) and the batched query plane (``core.dataplane``, torch).
* ``repro_torch.kernels`` — hand-written CUDA kernels for Hopper (``csrc/``),
  their ctypes wrappers, plain-PyTorch twins (``ref``) and the dispatch layer
  (``ops``): CUDA tensors go to the kernels, CPU tensors to the twins.
* ``repro_torch.data`` — the synthetic attributed-vector datasets.
* ``repro_torch.serve`` — the vector-search service facade and the
  language-model serving ``Engine``.
* ``repro_torch.configs``, ``repro_torch.models``, ``repro_torch.launch`` —
  the LM substrate ported so far: ``mamba2-370m`` (Mamba2 mixer, decoder,
  ``python -m repro_torch.launch.serve``).

Entry points run on the card: ``SquashIndex.search(backend="torch")`` and
``Engine`` take ``device=None`` meaning ``"cuda"`` and raise when CUDA is
absent, unless the caller passes ``device="cpu"``.
"""
