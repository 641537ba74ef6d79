"""Sharding profiles for parameters, optimizer state, batches and KV caches
on a ``torch.distributed`` ``DeviceMesh`` (the port of
``repro.launch.shardings``).

The rules are the reference's, name-based over a parameter's name:

  * projections whose OUTPUT grows (wq/wk/wv/gate/up/router/in_proj/w_dkv/
    w_uk/w_uv/lm_head/cb_head): d_out over ``model``, d_in over ``data``
    (tensor-parallel + FSDP — the "2-D sharded" megatron layout).
  * projections whose INPUT grows (wo/down/out_proj): d_in over ``model``,
    d_out over ``data``.
  * expert stacks (E, ·, ·): E over ``model`` (expert parallelism), the
    next dim over ``data``.
  * embeddings (V, d): vocab over ``model``.
  * 1-D leaves (norm scales, A_log, D, dt_bias) and ``conv_w`` replicated.

A spec has one entry per dim: an axis name, a tuple of names, or None;
:func:`fit_spec` drops an axis that does not divide its dim (mamba2's vocab
50,280 over 16, MQA's one kv head, a batch of 1). :func:`to_placements`
turns a spec into DTensor placements, one per mesh dim: ``Shard(i)`` on
every mesh dim that names tensor dim i (a tuple such as ``("pod",
"data")`` on one dim shards it over both, pod major as in the reference),
``Replicate()`` elsewhere.

The port un-stacks the layers: its ``blocks.0.attn.wq.w`` is one slice of
the reference's stacked ``blocks/attn/wq/w`` (``repro/models/
transformer.py``). The reference leaves its stack axes unsharded, so its
rule lands on the trailing dims, which are the port parameter's dims: the
port's spec is the reference's without the leading stack entries.

Optimizer moments inherit their parameter's spec (ZeRO-style); ``step`` is
replicated. Batches shard the leading dim over ``("pod",) data``. Caches
keep the reference's stacked layout, so their specs are the reference's:
batch over data and heads over model, except ``long_context`` (batch = 1),
where the *sequence* axis takes the data dimension.

``*_shardings`` return the fitted specs (the reference returns
``NamedSharding``s, a spec on a mesh); ``shard_*`` place tensors by them
as DTensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import batch_axes, mesh_axes

__all__ = ["param_pspec", "fit_spec", "to_placements", "fitted_placements",
           "params_shardings",
           "opt_shardings", "batch_shardings", "cache_shardings",
           "distribute", "place", "shard_model", "shard_opt_state",
           "shard_batch", "shard_caches", "mesh_axes"]

Spec = Tuple[Any, ...]

_OUT_GROWS = {"wq", "wk", "wv", "gate", "up", "router", "in_z", "in_xbc",
              "in_dt", "w_dkv", "w_uk", "w_uv", "lm_head", "cb_head",
              "table"}
_IN_GROWS = {"wo", "down", "out_proj"}


def _path_names(name) -> list:
    return name.split(".") if isinstance(name, str) else [str(n)
                                                          for n in name]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(spec: Sequence, shape, mesh) -> Spec:
    """Drop axis assignments that do not divide the corresponding dim; one
    entry per dim of ``shape``, a tuple of one axis written as the axis
    (as ``PartitionSpec`` reads it)."""
    sizes = mesh_axes(mesh)
    out = []
    for i in range(len(shape)):
        ax = spec[i] if i < len(spec) else None
        axes = _axes(ax)
        size = int(np.prod([sizes[a] for a in axes])) if axes else 1
        fits = axes and shape[i] % size == 0
        out.append((axes[0] if len(axes) == 1 else axes) if fits else None)
    return tuple(out)


def param_pspec(name, leaf) -> Spec:
    """The rule's spec of one parameter, by its ``named_parameters()`` name
    (or a sequence of path names) and anything with an ``ndim``."""
    names = _path_names(name)
    ndim = leaf.ndim
    last = names[-1] if names else ""
    none = (None,) * ndim
    if ndim <= 1:
        return none
    if "experts" in names:
        # (..., E, d_in, d_out): experts over model, middle over data.
        return (None,) * (ndim - 3) + ("model", "data", None)
    if last == "w" and len(names) >= 2:
        last = names[-2]
    if last == "table":     # embeddings (…, V, d) — vocab over model
        return (None,) * (ndim - 2) + ("model", None)
    if last in _OUT_GROWS:
        return (None,) * (ndim - 2) + ("data", "model")
    if last in _IN_GROWS:
        return (None,) * (ndim - 2) + ("model", "data")
    return none             # conv_w and anything unnamed: replicated


def to_placements(spec: Sequence, mesh, shape=None) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.

    A mesh axis of size 1, and with the tensor's ``shape`` a dim of size 1,
    stay ``Replicate()``: a shard over one rank is the whole, and DTensor
    mishandles such shards (it refuses to flatten or squeeze a size-1 dim
    it holds as sharded, which a batch of one on a 1 × 1 mesh gives in the
    backward)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {tuple(spec)}: the axes {axes} of dim "
                             f"{dim} are not in the mesh's major-to-minor "
                             f"order {tuple(names)}")
        if shape is not None and shape[dim] == 1:
            continue
        for p in pos:
            if sizes[names[p]] > 1:
                out[p] = Shard(dim)
    return out


def fitted_placements(spec: Sequence, shape, mesh) -> list:
    """The placements of ``spec`` fitted to a tensor of ``shape``."""
    return to_placements(fit_spec(spec, shape, mesh), mesh, shape)


def params_shardings(mesh, params: Mapping[str, Any]) -> Dict[str, Spec]:
    """{name: fitted spec} of ``dict(model.named_parameters())``."""
    return {k: fit_spec(param_pspec(k, p), p.shape, mesh)
            for k, p in params.items()}


def opt_shardings(mesh, opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """m/v inherit their parameter's spec; step is replicated."""
    return {"step": (),
            **{part: params_shardings(mesh, opt_state[part])
               for part in ("m", "v")}}


def batch_shardings(mesh, batch: Mapping[str, Any]) -> Dict[str, Spec]:
    ba = batch_axes(mesh)
    return {k: fit_spec((ba,) + (None,) * (v.ndim - 1), v.shape, mesh)
            for k, v in batch.items()}


def _cache_spec(name: str, shape, mesh, ba, dp: bool, seq: bool,
                long_context: bool) -> Spec:
    """Cache leaves carry leading stack dims, then (B, buf, …): k/v (B,
    buf, kv, hd); latent/k_rope (B, buf, r); conv (B, k, C); state (B, H,
    P, N)."""
    nd = len(shape)
    if name in ("k", "v"):
        lead = nd - 4
        # MQA / small GQA: if kv heads don't divide the model axis, put the
        # model axis on head_dim instead.
        hd_axis = shape[-2] % mesh_axes(mesh)["model"] != 0
        kv_s = None if (hd_axis or dp or seq) else "model"
        hd_s = "model" if (hd_axis and not dp and not seq) else None
        buf_s = "model" if seq else None
        if long_context:
            s = (None,) * lead + (None, ba, kv_s, hd_s)
        else:
            s = (None,) * lead + (ba, buf_s, kv_s, hd_s)
    elif name in ("latent", "k_rope"):
        lead = nd - 3
        r_s = None if (dp or seq) else "model"
        buf_s = "model" if seq else None
        if long_context:
            s = (None,) * lead + (None, ba, r_s)
        else:
            s = (None,) * lead + (ba, buf_s, r_s)
    elif name == "state":   # (…, B, H, P, N)
        s = (None,) * (nd - 4) + (None if long_context else ba, "model",
                                  None, None)
    elif name == "conv":    # (…, B, k, C)
        s = (None,) * (nd - 3) + (None if long_context else ba, None,
                                  "model")
    else:
        s = ()
    return fit_spec(s, shape, mesh)


def cache_shardings(mesh, caches: Mapping[str, Any], *,
                    long_context: bool = False, profile: str = "tp"):
    """Fitted specs of every cache leaf, in the caches' nesting.

    ``profile``:
      "tp"       — batch over data, heads (or head_dim) over model.
      "dp-cache" — batch over data only; the cache is replicated across the
                   model axis.
      "seq"      — flash-decoding layout: batch over data, the cache buffer
                   over model.
    """
    if profile not in ("tp", "dp-cache", "seq"):
        raise ValueError(f"profile must be 'tp', 'dp-cache' or 'seq', got "
                         f"{profile!r}")
    ba = batch_axes(mesh)
    dp = profile == "dp-cache"
    # long_500k (batch = 1) already sequence-shards the buffer over data;
    # the seq profile is a decode_32k layout.
    seq = profile == "seq" and not long_context

    def walk(tree):
        return {k: walk(v) if isinstance(v, Mapping) else _cache_spec(
            k, tuple(v.shape), mesh, ba, dp, seq, long_context)
            for k, v in tree.items()}
    return walk(caches)


# ---------------------------------------------------------------- placing

def distribute(t: torch.Tensor, spec: Sequence, mesh):
    """``t`` as a DTensor on ``mesh`` placed by ``spec`` (fitted to it)."""
    return place(t, mesh, fitted_placements(spec, t.shape, mesh))


def place(t: torch.Tensor, mesh, placements):
    """``t`` as a DTensor on ``mesh`` with ``placements``, each rank taking
    its shards of it. A tensor on the ``meta`` device becomes its local
    shard's shape on ``meta`` (the dry run's case: nothing is allocated or
    sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, placements)
    if t.is_meta:
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh,
                                                         placements)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh,
            placements, run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, placements)


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor ``nn.Parameter``
    placed by its rule (in place; returns ``model``). Every rank must hold
    the same weights: each takes its shards of them."""
    specs = params_shardings(mesh, dict(model.named_parameters()))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), specs[name],
                                                   mesh),
                                        requires_grad=p.requires_grad))
    return model


def shard_opt_state(state: Mapping[str, Any], model: nn.Module,
                    mesh) -> Dict[str, Any]:
    """AdamW state as DTensors: m and v placed as their parameters (which
    :func:`shard_model` placed), ``step`` replicated."""
    params = dict(model.named_parameters())
    return {"step": distribute(state["step"], (), mesh),
            **{part: {k: place(v, mesh, params[k].placements)
                      for k, v in state[part].items()}
               for part in ("m", "v")}}


def shard_batch(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, Any]:
    specs = batch_shardings(mesh, batch)
    return {k: distribute(v, specs[k], mesh) for k, v in batch.items()}


def shard_caches(caches: Mapping[str, Any], mesh, *,
                 long_context: bool = False, profile: str = "tp"):
    specs = cache_shardings(mesh, caches, long_context=long_context,
                            profile=profile)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, Mapping)
                else distribute(v, spec[k], mesh) for k, v in tree.items()}
    return walk(caches, specs)
