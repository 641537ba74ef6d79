"""Checkpoints (the port of ``repro.checkpoint``): one ``.npz`` and a
manifest for nested dicts of tensors."""

from repro_torch.checkpoint.store import restore_pytree, save_pytree

__all__ = ["save_pytree", "restore_pytree"]
