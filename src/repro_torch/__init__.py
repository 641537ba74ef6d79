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
* ``repro_torch.analysis`` — squashlint for the port (pure ``ast``: needs
  neither torch nor numpy), ``python -m repro_torch.analysis``.
* ``repro_torch.configs``, ``repro_torch.models``, ``repro_torch.launch``,
  ``repro_torch.train``, ``repro_torch.optim``, ``repro_torch.checkpoint``
  — the LM substrate: all ten configs (GQA / sliding / M-RoPE attention,
  MLA, MoE, Mamba2, the local:global and hybrid schedules, the audio
  heads), serving (``python -m repro_torch.launch.serve``), training
  (``python -m repro_torch.launch.train``), the sharded path on a
  ``DeviceMesh`` and its dry run. Models take the reference's parameter
  dtypes: f32 by default, or bf16 (its production dtype) through
  ``models.transformer.init_params(..., dtype=torch.bfloat16)``, with the
  MoE routers and the Mamba2 mixers' ``A_log``, ``D`` and ``dt_bias`` kept
  f32 as the reference keeps them.

Entry points run on the card: ``SquashIndex.search(backend="torch")``,
``Engine`` and the model builders take ``device=None`` meaning ``"cuda"``
and raise when CUDA is absent, unless the caller passes ``device="cpu"``.
"""
