"""Dry run at production scale: one step of every (arch × shape) pair on a
fake 256- or 512-rank process group (the port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out]

The reference forces 512 XLA host devices and compiles each step for the
production mesh. The port starts a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``: collectives
return at once and move nothing) of 256 or 512 ranks in this process, as
rank 0, builds the model, its AdamW state and the step's inputs on the
``meta`` device (shapes only, nothing allocated), shards them by
``launch.shardings`` and runs the step — a train step (forward + backward
+ AdamW), a prefill or one decode step — under two dispatch modes: one
records every collective rank 0 issues with its output bytes (DTensor's
own redistributions inside an op included), the other counts the FLOPs
rank 0 computes (``flops_per_rank``: a product on DTensors by its global
FLOPs over the mesh dims that split its output, a product on plain tensors
(inside a ``local_map``, or the same on every rank) at its own shapes, so
work that every rank repeats counts on each). ``flops`` is
``torch.utils.flop_counter.FlopCounterMode``'s count of the same step on
the unsharded model (the global work), and ``flops_split`` = flops /
(chips · flops_per_rank) how near the layout comes to a perfect split
(1.0). A process has one default group, so the dry run runs in its own
process (``main`` or a ``python -c``), as the reference's does.

The parameters take the reference's dtype, ``param_dtype`` (bf16 by
default, as the reference's ``lower_pair``), through
``DecoderLM.to_dtype``: the MoE routers and the Mamba2 mixers' ``A_log``,
``D`` and ``dt_bias`` stay f32, as the reference's ``init_params`` keeps
them. A train step's AdamW moments are bf16 where ``d_model >= 7168``
(arctic-480b) and f32 otherwise, as the reference's; decode caches are in
``param_dtype``, the Mamba2 states in f32.

Per-rank memory is the bytes of rank 0's shards of the parameters, the
optimizer state and the inputs (activations are not counted: nothing is
allocated). The roofline terms are H100 spec arithmetic from
``launch.mesh.HW``, not measurements: ``t_compute`` rank 0's FLOPs over
a card's peak for ``param_dtype`` (the bf16 tensor-core peak for bf16
parameters, the f32 peak for f32; with bf16 parameters every product is
counted at the bf16 peak, GQA attention's f32 score and value products
too, so ``t_compute`` is a lower bound), ``t_memory`` rank 0's state read once
from HBM, ``t_collective`` rank 0's collective bytes
over one NVLink direction (an optimistic bound: a 256-card mesh spans hosts,
whose links are slower). The port has no scan, so ``--unroll`` is accepted
and changes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_configs)
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import HW, make_production_mesh, mesh_axes

__all__ = ["input_specs", "arch_for_shape", "dryrun_pair",
           "collective_bytes", "CollectiveRecorder", "RankFlopCounter",
           "run_all", "init_fake_group"]

# Pure full-attention archs get a documented sliding-window serving variant
# for long_500k (the sub-quadratic rule); SSM/hybrid/local:global run
# natively.
LONG_WINDOW = 8192
_NATIVE_LONG = {"mamba2-370m", "zamba2-7b", "gemma3-4b"}
PARAM_DTYPE = torch.bfloat16      # the reference's default param_dtype
BF16_MOMENTS_D_MODEL = 7168       # bf16 AdamW moments from this width up


def arch_for_shape(name: str, shape: InputShape) -> ArchConfig:
    cfg = get_config(name)
    if shape.name == "long_500k" and name not in _NATIVE_LONG:
        cfg = dataclasses.replace(cfg, attention="sliding",
                                  sliding_window=LONG_WINDOW)
    return cfg


def _meta_model(cfg: ArchConfig, dtype=PARAM_DTYPE):
    from repro_torch.models.transformer import DecoderLM

    with torch.device("meta"):
        return DecoderLM(cfg).to_dtype(dtype)


def _opt_state_dtype(cfg: ArchConfig) -> torch.dtype:
    """The AdamW moments' dtype: bf16 for the widest model (the reference's
    480B giant), f32 otherwise."""
    return (torch.bfloat16 if cfg.d_model >= BF16_MOMENTS_D_MODEL
            else torch.float32)


def _tokens(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    shape = ((batch, cfg.num_codebooks, seq) if cfg.num_codebooks
             else (batch, seq))
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape,
                param_dtype=PARAM_DTYPE) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input (no allocation): the
    train batch, the prefill inputs, or a decode step's one new token, its
    caches over ``seq_len`` slots (in ``param_dtype``) and its position."""
    b, s = shape.global_batch, shape.seq_len
    embeds = (torch.empty((b, cfg.vlm_num_patches, cfg.d_model),
                          device="meta") if cfg.mrope else None)
    if shape.mode == "train":
        batch = {"tokens": _tokens(cfg, b, s + 1)}
        if embeds is not None:
            batch["embeds"] = embeds
        return {"batch": batch}
    if shape.mode == "prefill":
        out = {"tokens": _tokens(cfg, b, s)}
        if embeds is not None:
            out["embeds"] = embeds
        return out
    # decode: ONE new token against a seq_len cache
    caches = _meta_model(cfg, param_dtype).init_decode_caches(
        b, s, dtype=param_dtype)
    return {"tokens": _tokens(cfg, b, 1), "caches": caches, "pos": s - 1}


def _leaves(tree) -> Iterable[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _local_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of this rank's shards (a plain tensor counts whole)."""
    total = 0
    for t in tensors:
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


# ------------------------------------------------------------- collectives

_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class CollectiveRecorder(TorchDispatchMode):
    """Records every functional collective dispatched under it as (kind,
    output shape, dtype): what this rank receives. An op on DTensors is
    handed to DTensor (``NotImplemented``, as ``CommDebugMode`` does), so
    the local ops and collectives it runs come back here."""

    def __init__(self):
        super().__init__()
        self.trace = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name.rstrip("_") in _KINDS:
            t = out[0] if isinstance(out, (tuple, list)) else out
            self.trace.append((_KINDS[name.rstrip("_")], tuple(t.shape),
                               t.dtype))
        return out


class RankFlopCounter(TorchDispatchMode):
    """Counts the FLOPs this rank computes in ``flops``, by
    ``torch.utils.flop_counter``'s formulas: an op on DTensors (seen before
    DTensor runs it, at global shapes) by its global FLOPs over the sizes
    of the mesh dims that split its output (``Shard`` or ``Partial``: a
    mesh dim that replicates it repeats the work on each of its ranks); an
    op on plain tensors at its own shapes. Enter it inside a
    :class:`CollectiveRecorder`: the ops DTensor runs for it are not seen
    here."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(getattr(func, "_overloadpacket", None))
        if count is not None:
            n = float(count(*args, **kwargs, out_val=out))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            first = next((o for o in outs if isinstance(o, torch.Tensor)),
                         None)
            if first is not None and _is_dtensor_op((type(first),)):
                for i, p in enumerate(first.placements):
                    if p.is_shard() or p.is_partial():
                        n /= first.device_mesh.size(i)
            self.flops += n
        return out


def collective_bytes(trace) -> Dict[str, Any]:
    """Sum the output bytes of every collective of a trace of (kind,
    shape, dtype) records, per kind."""
    out: Dict[str, Dict[str, float]] = {}
    for kind, shape, dtype in trace:
        n = 1
        for s in shape:
            n *= int(s)
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += n * torch.empty((), dtype=dtype).element_size()
    return {"per_op": out, "total_bytes": sum(v["bytes"]
                                              for v in out.values())}


# --------------------------------------------------------------- the pair

def init_fake_group(world: int) -> None:
    """The fake default process group of ``world`` ranks (this process is
    rank 0), unless a group is up already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def _step(cfg: ArchConfig, shape: InputShape, mesh, cache_profile: str,
          remat: bool, accum_steps: int, param_dtype=PARAM_DTYPE):
    """(a function running the step, {part: state whose shards count}),
    sharded on ``mesh`` (None: the whole step on one device)."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    def batch_of(tree):
        return tree if mesh is None else SH.shard_batch(tree, mesh)

    model = _meta_model(cfg, param_dtype)
    if mesh is not None:
        SH.shard_model(model, mesh)
    specs = input_specs(cfg, shape, param_dtype)
    state = {"params": list(model.parameters())}
    if shape.mode == "train":
        opt_cfg = AdamWConfig(state_dtype=_opt_state_dtype(cfg))
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        if mesh is not None:
            opt = SH.shard_opt_state(opt, model, mesh)
        batch = batch_of(specs["batch"])
        step = make_train_step(cfg, opt_cfg, remat=remat,
                               accum_steps=accum_steps)
        state.update(opt=[opt["step"], *opt["m"].values(),
                          *opt["v"].values()],
                     inputs=list(batch.values()))
        return lambda: step(model, opt, batch), state
    if shape.mode == "prefill":
        inputs = batch_of(specs)
        buf = shape.seq_len + (cfg.vlm_num_patches if cfg.mrope else 0)
        state["inputs"] = list(inputs.values())
        return lambda: model.prefill(inputs["tokens"], buf_len=buf,
                                     embeds=inputs.get("embeds")), state
    caches = specs["caches"]
    if mesh is not None:
        caches = SH.shard_caches(caches, mesh,
                                 long_context=shape.name == "long_500k",
                                 profile=cache_profile)
    tokens = batch_of({"t": specs["tokens"]})["t"]
    state["inputs"] = [tokens, *_leaves(caches)]
    return (lambda: model.decode_step(tokens, caches, specs["pos"]), state)


def dryrun_pair(name: str, shape_name: str, *, multi_pod: bool = False,
                mesh=None, cfg: Optional[ArchConfig] = None,
                verbose: bool = True, remat: bool = True,
                accum_steps: int = 1, unroll: bool = False,
                cache_profile: str = "seq",
                param_dtype=PARAM_DTYPE) -> Dict[str, Any]:
    """One (arch × shape) step on the production mesh (or ``mesh``; ``cfg``
    overrides the arch's config, e.g. a reduced one), with the parameters
    in ``param_dtype``. ``unroll`` is accepted for the reference's
    interface: the port has no scan."""
    del unroll
    from torch.utils.flop_counter import FlopCounterMode

    shape = INPUT_SHAPES[shape_name]
    cfg = cfg or arch_for_shape(name, shape)
    if mesh is None:
        init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    flops = FlopCounterMode(display=False)
    with flops:                     # the global work: the step unsharded
        _step(cfg, shape, None, cache_profile, remat, accum_steps,
              param_dtype)[0]()
    t0 = time.perf_counter()
    run, state = _step(cfg, shape, mesh, cache_profile, remat, accum_steps,
                       param_dtype)
    t1 = time.perf_counter()
    comms, rank_flops = CollectiveRecorder(), RankFlopCounter()
    with comms, rank_flops:
        run()
    t2 = time.perf_counter()
    coll = collective_bytes(comms.trace)
    axes = mesh_axes(mesh)
    nchips = 1
    for size in axes.values():
        nchips *= size
    total_flops = float(flops.get_total_flops())
    mem = {f"{part}_bytes": _local_bytes(ts) for part, ts in state.items()}
    mem["argument_bytes"] = sum(mem.values())
    result = {
        "arch": name,
        "shape": shape_name,
        "mesh": axes,
        "chips": nchips,
        "param_dtype": str(param_dtype).split(".")[-1],
        "build_s": t1 - t0,
        "trace_s": t2 - t1,
        "flops": total_flops,
        "flops_per_rank": rank_flops.flops,
        "flops_split": total_flops / (nchips * rank_flops.flops)
        if rank_flops.flops else None,
        "collectives": coll,
        "memory": mem,
        # roofline terms (seconds), H100 spec arithmetic — rank 0's work
        "t_compute": rank_flops.flops / (
            HW.PEAK_BF16_FLOPS if param_dtype == torch.bfloat16
            else HW.PEAK_F32_FLOPS),
        "t_memory": mem["argument_bytes"] / HW.HBM_BW,
        "t_collective": coll["total_bytes"] / HW.NVLINK_BW,
    }
    terms = {k: result[k] for k in ("t_compute", "t_memory", "t_collective")}
    result["bottleneck"] = max(terms, key=terms.get)
    result["fits_hbm"] = mem["argument_bytes"] <= HW.HBM_BYTES
    if verbose:
        print(f"[dryrun] {name} × {shape_name} mesh={tuple(axes.values())} "
              f"build={result['build_s']:.1f}s trace={result['trace_s']:.1f}s")
        print(f"  FLOPs={total_flops:.3e}  FLOPs/rank="
              f"{rank_flops.flops:.3e} (split {result['flops_split']})"
              f"  state/rank="
              f"{mem['argument_bytes']:.3e}B  coll/rank="
              f"{coll['total_bytes']:.3e}B")
        print(f"  t_comp={result['t_compute'] * 1e3:.2f}ms  "
              f"t_mem={result['t_memory'] * 1e3:.2f}ms  "
              f"t_coll={result['t_collective'] * 1e3:.2f}ms  "
              f"→ {result['bottleneck']} (H100 spec arithmetic)")
    return result


def run_all(archs=None, shapes=None, *, multi_pod: bool = False,
            json_path: Optional[str] = None, unroll: bool = False,
            cache_profile: str = "seq", param_dtype=PARAM_DTYPE) -> list:
    archs = archs or list_configs()
    shapes = shapes or list(INPUT_SHAPES)
    init_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    results = []
    for a in archs:
        for s in shapes:
            try:
                results.append(dryrun_pair(a, s, mesh=mesh, unroll=unroll,
                                           cache_profile=cache_profile,
                                           param_dtype=param_dtype))
            except Exception as e:  # a failure here is a fault of the port
                print(f"[dryrun] FAILED {a} × {s}: {type(e).__name__}: {e}")
                results.append({"arch": a, "shape": s, "error": str(e)})
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=1, default=float)
    ok = sum(1 for r in results if "error" not in r)
    print(f"[dryrun] {ok}/{len(results)} pairs ran OK")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's interface; the port "
                         "has no layer scan to unroll")
    ap.add_argument("--cache-profile", default="seq",
                    choices=["seq", "tp", "dp-cache"],
                    help="decode KV-cache layout (seq = flash-decoding)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.all:
        res = run_all(multi_pod=args.multi_pod, json_path=args.json,
                      unroll=args.unroll, cache_profile=args.cache_profile)
        return 0 if all("error" not in r for r in res) else 1
    if not args.arch:
        ap.error("--arch is required without --all")
    res = dryrun_pair(args.arch, args.shape or "train_4k",
                      multi_pod=args.multi_pod, unroll=args.unroll,
                      cache_profile=args.cache_profile)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
