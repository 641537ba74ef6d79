"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

Counterparts of ``tests/test_system.py``'s input-spec tests (the step
inputs' shapes, the long-context window variant and its bounded cache),
the collective byte count on a known trace, and two ``dryrun_pair`` runs of
reduced configs (llama3's train step, mamba2's decode step) on a fake 2 × 2
process group in a subprocess (a process has one default group): rank 0's
parameter, optimizer and input bytes must equal the arithmetic from the
JAX package's specs (``repro.launch.shardings``) of the same leaves, at
the reference's default ``param_dtype`` (bf16, with the router f32 and
the Mamba2 state f32; each leaf counted at its own dtype's width), the
FLOPs must be counted and the collectives recorded. In the same process,
the per-rank FLOP counter and the collective recorder on single products
of known placements: a split product counts a rank's share, a replicated
one its whole, and DTensor's own redistribution inside an op is recorded.
A meta-only train step at full size takes the reference's dtypes: bf16
parameters, f32 routers, and bf16 AdamW moments from ``d_model`` 7168.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
             num_heads=4, num_kv_heads=2)
MAMBA = dict(num_layers=2, d_model=128, vocab_size=256)
MESH = {"data": 2, "model": 2}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_input_specs_shapes():
    cfg = get_config("llama3-8b")
    sp = dryrun.input_specs(cfg, INPUT_SHAPES["train_4k"])
    assert sp["batch"]["tokens"].shape == (256, 4097)
    assert sp["batch"]["tokens"].is_meta
    sp = dryrun.input_specs(cfg, INPUT_SHAPES["decode_32k"])
    assert sp["tokens"].shape == (128, 1)
    # the caches hold full seq_len buffers for every layer (stacked)
    kv = [leaf for leaf in _leaves(sp["caches"]) if leaf.ndim == 5]
    assert kv and all(leaf.shape[2] == 32768 for leaf in kv)
    # audio tokens carry the codebook axis
    sp = dryrun.input_specs(get_config("musicgen-large"),
                            INPUT_SHAPES["prefill_32k"])
    assert sp["tokens"].shape == (32, 4, 32768)
    # the VLM's patch embeddings ride with its tokens
    sp = dryrun.input_specs(get_config("qwen2-vl-2b"),
                            INPUT_SHAPES["train_4k"])
    assert sp["batch"]["embeds"].shape[:2] == (256, 256)


def test_long_500k_window_variant_for_full_attention():
    long = INPUT_SHAPES["long_500k"]
    cfg = dryrun.arch_for_shape("llama3-8b", long)
    assert cfg.attention == "sliding" and cfg.sliding_window == 8192
    assert dryrun.arch_for_shape("mamba2-370m", long).attention != "sliding"
    assert dryrun.arch_for_shape("gemma3-4b", long).attention == \
        "local_global"
    # decode-cache memory stays bounded for the window variant (bf16, as
    # the reference counts it)
    caches = dryrun.input_specs(cfg, long, param_dtype=torch.bfloat16)[
        "caches"]
    total = sum(leaf.numel() * leaf.element_size()
                for leaf in _leaves(caches))
    assert total < 5e9, "windowed long-context cache must be ≪ full cache"


def test_collective_bytes_on_a_known_trace():
    trace = [("all-gather", (4, 8), torch.float32),
             ("all-gather", (2,), torch.bfloat16),
             ("all-reduce", (3, 3), torch.float64),
             ("reduce-scatter", (), torch.int32)]
    out = dryrun.collective_bytes(trace)
    assert out["per_op"] == {
        "all-gather": {"count": 2, "bytes": 4 * 8 * 4 + 2 * 2},
        "all-reduce": {"count": 1, "bytes": 72},
        "reduce-scatter": {"count": 1, "bytes": 4}}
    assert out["total_bytes"] == 132 + 72 + 4
    assert dryrun.collective_bytes([]) == {"per_op": {}, "total_bytes": 0}


_PAIRS = textwrap.dedent("""
    import json, sys
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    llama, mamba = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    dryrun.init_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {
        "train": dryrun.dryrun_pair(
            "llama3-8b", "train_4k", mesh=mesh, verbose=False,
            cfg=get_config("llama3-8b").reduced(**llama)),
        "decode": dryrun.dryrun_pair(
            "mamba2-370m", "decode_32k", mesh=mesh, verbose=False,
            cfg=get_config("mamba2-370m").reduced(**mamba)),
    }
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with torch.device("meta"):
        a, b = torch.empty(8, 16), torch.empty(16, 32)

    def product(pa, pb):
        comms, flops = dryrun.CollectiveRecorder(), dryrun.RankFlopCounter()
        with comms, flops:
            distribute_tensor(a, mesh, pa) @ distribute_tensor(b, mesh, pb)
        return {"flops": flops.flops,
                "kinds": [kind for kind, _, _ in comms.trace]}

    whole = [Replicate(), Replicate()]
    out["products"] = {
        # rows over data, the contraction over model: a quarter each
        "split": product([Shard(0), Shard(1)], [Replicate(), Shard(0)]),
        "whole": product(whole, whole),
        # b's rows lie over model as a's columns do not: DTensor gathers
        "gathered": product([Shard(0), Replicate()], [Shard(1), Shard(0)]),
    }
    print("RESULT " + json.dumps(out))
""")


def _spec_bytes(tree, specs):
    """Rank 0's bytes of every leaf of a reference tree of
    ``ShapeDtypeStruct`` under its sharding specs, each leaf at its own
    dtype's width."""
    return sum(_local_bytes(leaf.shape, spec, leaf.dtype.itemsize)
               for leaf, spec in zip(
                   jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(
                       specs, is_leaf=lambda x: isinstance(
                           x, jax.sharding.PartitionSpec))))


def _local_bytes(shape, spec, itemsize):
    n = int(np.prod(shape))
    for ax in tuple(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            n //= MESH[a]
    return n * itemsize


@pytest.fixture(scope="module")
def pairs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PAIRS, json.dumps(LLAMA),
                          json.dumps(MAMBA)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _mesh(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    return SimpleNamespace(shape=MESH, axis_names=tuple(MESH))


def test_train_pair_bytes_follow_the_reference_specs(pairs, monkeypatch):
    mesh = _mesh(monkeypatch)
    jcfg = jax_get_config("llama3-8b").reduced(**LLAMA)
    # the reference's default param_dtype (repro.launch.dryrun.lower_pair)
    params = jax.eval_shape(lambda k: jax_T.init_params(k, jcfg,
                                                        dtype=jnp.bfloat16),
                            jax.random.PRNGKey(0))
    specs = JSH.params_shardings(mesh, params)
    res = pairs["train"]
    assert res["param_dtype"] == "bfloat16"
    assert res["memory"]["params_bytes"] == _spec_bytes(params, specs)
    # m and v in float32 (d_model < 7168) as their parameters, and the
    # int32 step whole
    moments = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
    assert res["memory"]["opt_bytes"] == 2 * _spec_bytes(moments, specs) + 4
    # tokens (256, 4097) int32, batch over data
    assert res["memory"]["inputs_bytes"] == 256 * 4097 * 4 // 2
    assert res["mesh"] == MESH and res["chips"] == 4
    assert res["flops"] > 6 * 256 * 4096 * sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(
            params)) * 0.5
    assert res["collectives"]["total_bytes"] > 0
    assert res["bottleneck"] in ("t_compute", "t_memory", "t_collective")


def test_rank_flops_and_collectives_of_known_products(pairs):
    full = 2 * 8 * 16 * 32
    got = pairs["products"]
    assert got["split"]["flops"] == full / 4
    assert got["whole"]["flops"] == full
    assert got["whole"]["kinds"] == []
    # (the output's split depends on the strategy DTensor picks)
    assert got["gathered"]["flops"] in (full / 4, full / 2)
    assert "all-gather" in got["gathered"]["kinds"]
    # the reduced llama3's heads and vocabulary divide the model axis: its
    # step's products split evenly over the four ranks
    res = pairs["train"]
    assert res["flops_per_rank"] == pytest.approx(res["flops"] / 4,
                                                  rel=1e-3)


def test_decode_pair_bytes_follow_the_reference_specs(pairs, monkeypatch):
    mesh = _mesh(monkeypatch)
    jcfg = jax_get_config("mamba2-370m").reduced(**MAMBA)
    caches = jax.eval_shape(lambda: jax_T.init_decode_caches(
        jcfg, 128, 32768, dtype=jnp.bfloat16))
    specs = JSH.cache_shardings(mesh, caches, profile="seq")
    want = _spec_bytes(caches, specs)
    res = pairs["decode"]
    # the one new token (128, 1) int32 over data, and the caches
    assert res["memory"]["inputs_bytes"] == 128 * 4 // 2 + want
    # bf16 weights, the mixers' A_log, D and dt_bias f32
    params = jax.eval_shape(lambda k: jax_T.init_params(k, jcfg,
                                                        dtype=jnp.bfloat16),
                            jax.random.PRNGKey(0))
    assert res["memory"]["params_bytes"] == _spec_bytes(
        params, JSH.params_shardings(mesh, params))
    assert "opt_bytes" not in res["memory"]
    assert res["flops"] > 0


@pytest.mark.parametrize("name,moments", [("arctic-480b", torch.bfloat16),
                                          ("llama3-8b", torch.float32)])
def test_train_state_takes_the_reference_dtypes(name, moments):
    """Meta only, no process group: a train step's parameters and AdamW
    moments at full size in the reference's dtypes (``lower_pair``: bf16
    parameters, the routers f32, and bf16 moments from d_model 7168, the
    480B giant's width), byte for byte."""
    cfg = get_config(name)
    _, state = dryrun._step(cfg, INPUT_SHAPES["train_4k"], None, "seq",
                            True, 1)
    params = jax.eval_shape(lambda k: jax_T.init_params(k, jax_get_config(
        name), dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(params)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert nbytes(state["params"]) == sum(
        leaf.size * leaf.dtype.itemsize for leaf in leaves)
    assert {t.dtype for t in state["opt"][1:]} == {moments}
    assert nbytes(state["opt"][1:]) == 2 * sum(
        leaf.size for leaf in leaves) * torch.empty(
        (), dtype=moments).element_size()
    routers = [p for n, p in dryrun._meta_model(cfg).named_parameters()
               if "router" in n]
    assert bool(routers) == bool(cfg.num_experts)
    assert all(p.dtype == torch.float32 for p in routers)
