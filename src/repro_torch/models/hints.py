"""Sharding hints inside model code (the port of ``repro.models.hints``).

The reference applies GSPMD ``with_sharding_constraint`` when the mesh in
scope at trace time names the axes, and does nothing on a plain one-device
jit. The port has no GSPMD and no ambient mesh around model code: its mesh
path (``core/distributed.py``) shards the search, not the language model.
So :func:`ambient_mesh_sizes` is always ``{}`` and :func:`hint` returns its
argument, which is what the reference does on one device; in particular
attention's ``_heads_need_pinning`` is always false. Sharding the language
model comes with training's ``launch/shardings`` (``ROADMAP.md``).
"""

from __future__ import annotations

__all__ = ["ambient_mesh_sizes", "hint"]


def ambient_mesh_sizes() -> dict:
    """Axis-name → size of the mesh around model code: none in the port."""
    return {}


def hint(x, *spec):
    """The reference's sharding constraint with no mesh in scope: ``x``."""
    del spec
    return x
