"""Sharding hints inside model code (the port of ``repro.models.hints``).

The reference applies GSPMD's ``with_sharding_constraint`` where the mesh
in scope names the spec's axes, and does nothing on a plain one-device
jit. The port has no ambient mesh: a tensor carries its own. So
:func:`hint` redistributes a DTensor (a model that
``launch.shardings.shard_model`` placed on a ``DeviceMesh``) to the spec's
placements when its mesh names every axis of the spec, after
``launch.shardings.fit_spec`` dropped an axis that does not divide its dim;
it returns a plain tensor, or a DTensor whose mesh lacks an axis, as it is.
:func:`mesh_sizes` is the mesh a tensor lies on, ``{}`` for a plain one.

Around the model's entry points, :func:`sharded_scope` lets the plain
tensors that model code makes (positions, masks, RoPE frequencies, zero
aux losses: the same on every rank, at the global shape) meet a sharded
model's DTensors as replicated ones. :func:`on_replicated` runs a function
that DTensor has no sharding strategy for (the MoE router's stable sorts,
``searchsorted`` and index writes; the KV cache's slot writes are in
``attention``) on the whole, replicated tensors on every rank, as the
reference's hints pin them; :func:`along` runs an op along one dim on each
rank's shard.
"""

from __future__ import annotations

import contextlib

__all__ = ["mesh_sizes", "hint", "hint_local", "is_sharded",
           "sharded_scope", "on_replicated", "split_heads", "merge_heads",
           "along", "hint_batch", "pad_dim"]


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_sizes(x) -> dict:
    """Axis name → size of the mesh ``x`` lies on ({} for a plain tensor)."""
    if not is_sharded(x):
        return {}
    from repro_torch.launch.mesh import mesh_axes

    return mesh_axes(x.device_mesh)


def hint(x, *spec):
    """``x`` redistributed to ``spec``'s placements on its own mesh (a
    DTensor whose mesh names the spec's axes), and its gradient likewise;
    otherwise ``x``."""
    sizes = mesh_sizes(x)
    named = [a for entry in spec if entry is not None
             for a in (entry if isinstance(entry, tuple) else (entry,))]
    if not sizes or any(a not in sizes for a in named):
        return x
    from repro_torch.launch.shardings import fitted_placements

    mesh = x.device_mesh
    # Even where x lies so already: the backward then places x's gradient
    # the same way, whatever placements the later products gave it.
    return x.redistribute(mesh, fitted_placements(spec, x.shape, mesh))


def hint_batch(x):
    """A batch leaf placed as ``launch.shardings.batch_shardings`` places
    batches: the leading dim over the mesh's batch axes (a plain tensor as
    it is)."""
    if not is_sharded(x):
        return x
    from repro_torch.launch.mesh import batch_axes

    return hint(x, batch_axes(x.device_mesh), *([None] * (x.ndim - 1)))


def hint_local(x, mesh, placements):
    """This rank's shard of ``x`` placed by ``placements`` on ``mesh`` (a
    plain tensor counts as replicated: every rank holds the whole)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_sharded(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements).to_local()


def split_heads(t, heads: int, head_dim: int):
    """``t`` (..., heads · head_dim) → (..., heads, head_dim). A DTensor
    whose last dim lies over a mesh dim that does not divide ``heads``
    (llama3-8b's 8 kv heads over a model axis of 16) is gathered over it
    first: its shards would cut a head."""
    if is_sharded(t):
        from torch.distributed.tensor import Replicate

        mesh, last = t.device_mesh, t.ndim - 1
        placements = [Replicate() if p.is_shard(last)
                      and heads % mesh.size(i) else p
                      for i, p in enumerate(t.placements)]
        if placements != list(t.placements):
            t = t.redistribute(mesh, placements)
    return t.reshape(*t.shape[:-1], heads, head_dim)


def merge_heads(t):
    """``t`` (..., heads, head_dim) → (..., heads · head_dim). A DTensor's
    gradient comes back placed as the merged tensor lay in the forward
    (torch 2.11's DTensor cannot split a sharded dim in a view's backward,
    as the output projection's gradient, sharded over ``model``, would
    need when the heads do not divide the axis)."""
    t = t.reshape(*t.shape[:-2], -1)
    if not is_sharded(t):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def sharded_scope(*tensors):
    """``implicit_replication()`` when any of ``tensors`` is a DTensor and
    it is not on already, else a context that does nothing: the context
    switches it off on exit, so an entry point called inside a train step
    must leave it on for the step's backward (which recomputes the
    checkpointed blocks). A backward of a sharded model's forward runs in
    this scope."""
    if any(is_sharded(t) for t in tensors):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        if not getattr(DTensor._op_dispatcher,
                       "_allow_implicit_replication", False):
            return implicit_replication()
    return contextlib.nullcontext()


def on_replicated(fn, n_out: int, *args):
    """``fn(*args)``; when an argument is a DTensor, ``fn`` runs on every
    rank on the whole, replicated arguments (DTensors are gathered first)
    and each of its ``n_out`` outputs comes back a replicated DTensor.
    Differentiable either way."""
    mesh = next((a.device_mesh for a in args if is_sharded(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    outs = rep if n_out == 1 else tuple([rep] * n_out)
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(rep if is_sharded(a) else None
                                         for a in args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def along(fn, x, dim: int):
    """``fn(x)`` for an op that works along ``x``'s dim ``dim`` alone (a
    cumulative sum); on a DTensor each rank runs it on its own shard,
    gathered first over the mesh dims that shard ``dim``. Differentiable.
    (DTensor has no strategy for every such op's backward: a cumsum's
    takes ``flip``, which torch 2.11's DTensor lacks.)"""
    if not is_sharded(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    dim = dim % x.ndim
    placements = [Replicate() if p.is_shard(dim) or p.is_partial() else p
                  for p in x.placements]
    return local_map(fn, out_placements=placements,
                     in_placements=(placements,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def pad_dim(x, dim: int, before: int, after: int):
    """``x`` with ``before`` and ``after`` zeros along its dim ``dim``
    (``F.pad``); a DTensor through :func:`along` (torch 2.11's DTensor
    gives ``constant_pad_nd``'s output one placement on a 2-D mesh, which
    the next view refuses)."""
    import torch.nn.functional as F

    dim = dim % x.ndim
    widths = [0, 0] * (x.ndim - 1 - dim) + [before, after]
    return along(lambda t: F.pad(t, widths), x, dim)
