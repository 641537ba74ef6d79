"""The port's sharded LM path on a 2 × 2 ("data", "model") gloo mesh of
four CPU ranks, against the port on one device and the JAX package.

Counterparts of ``tests/test_multidevice.py``'s sharded train step,
decode, MoE + MLA forward, MoE FFN alone, MLA attention alone and Mamba2
forward (its raw-XLA ``*_repro`` xfails pin XLA bugs and have none), plus
a reduced Mamba2 train step (kernel 6's autograd Function under
``local_map``, the plain forward on the CPU) and the train launcher with a
mesh. One set of four spawned rank processes (each importing torch and the
port only) meets through a ``file://`` rendezvous and runs every case on
weights the parent draws with the reference's ``init_*`` from the
reference tests' seeds; rank 0 saves what it computed, gathered whole, and
every rank its parameters' local shard shapes. The parent meanwhile runs
the same cases on the port unsharded and on the JAX package.

Float32 throughout, as the reference's multidevice tests run. The model
rounds to float32 inside (RMSNorm, RoPE, the router, the SSM) as the
reference does, so a sharded run, whose partial products are summed in
another order across ranks, cannot equal one device bit for bit, in
float64 either: against the port on one device outputs, gradients and
AdamW moments hold within ``SHARD_TOL`` = 5e-5 of their largest magnitude
(a few float32 ulps carried through two layers), loss and grad norm within
1e-5 relative, and updated parameters at the reference test's own rtol
5e-3, atol 2e-3 (Adam's first step moves an element whose gradient is 0
up to rounding by up to lr either way). The MoE FFN alone (tokens over
``data``, experts over ``model``, everything else replicated, as the
reference test places it) computes each row and each expert as one device
does, and is held exactly, as the reference holds its own. Against the
JAX package: the reference tests' tolerances, and for the MoE FFN
``tests/test_torch_moe.py``'s 2e-5 (two frameworks' sums).
"""

import dataclasses
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
from repro.models import attention as jax_A  # noqa: E402
from repro.models import moe as jax_M  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 2, "model": 2}
SHARD_TOL = 5e-5
LR = 1e-2
LLAMA = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
             num_heads=4, num_kv_heads=2)
# One kv head: the model axis divides the query heads only, so each rank
# attends its own query heads against the kv head they read.
MQA = dict(LLAMA, num_kv_heads=1)
# Three heads: the model axis divides no head count, so each rank attends
# its own half of the queries (along the sequence) against whole k and v.
ODD_HEADS = dict(LLAMA, num_heads=3, num_kv_heads=1, head_dim=16)
DEEPSEEK = dict(num_layers=2, d_model=64, d_ff=64, vocab_size=256)
MAMBA = dict(num_layers=2, d_model=128, vocab_size=256)
PROFILES = ("tp", "seq", "dp-cache")


def _cfgs(name, **kw):
    cfg, jcfg = get_config(name).reduced(**kw), jax_get_config(name).reduced(
        **kw)
    if name == "deepseek-v2-lite-16b":   # no-drop capacity, as the reference
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
        jcfg = dataclasses.replace(jcfg,
                                   capacity_factor=float(jcfg.num_experts))
    return cfg, jcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs():
    """Every case's weights (reference trees) and inputs, from the
    reference tests' seeds."""
    rng = _rng(0)
    return {
        "train": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(0), _cfgs("llama3-8b", **LLAMA)[1])),
            tokens=rng.integers(0, 256, (4, 33), dtype=np.int32)),
        "mqa": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(5), _cfgs("llama3-8b", **MQA)[1])),
            tokens=_rng(5).integers(0, 256, (4, 33), dtype=np.int32)),
        "odd": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(6), _cfgs("llama3-8b", **ODD_HEADS)[1])),
            tokens=_rng(6).integers(0, 256, (4, 33), dtype=np.int32)),
        "decode": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(1), _cfgs("llama3-8b", **LLAMA)[1])),
            tokens=np.ones((4, 16), np.int32), step=np.ones((4, 1), np.int32)),
        "moe_mla": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(3), _cfgs("deepseek-v2-lite-16b",
                                         **DEEPSEEK)[1])),
            tokens=_rng(0).integers(0, 256, (4, 16), dtype=np.int32)),
        "moe_ffn": dict(tree=_np(jax_M.init_moe(
            jax.random.PRNGKey(3), _cfgs("deepseek-v2-lite-16b",
                                         **DEEPSEEK)[1])),
            x=_rng(0).normal(size=(4, 16, 64)).astype(np.float32)),
        "mla": dict(tree=_np(jax_A.init_mla(
            jax.random.PRNGKey(3), _cfgs("deepseek-v2-lite-16b",
                                         **DEEPSEEK)[1])),
            x=_rng(0).normal(size=(4, 16, 64)).astype(np.float32)),
        "mamba": dict(tree=_np(jax_T.init_params(
            jax.random.PRNGKey(4), _cfgs("mamba2-370m", **MAMBA)[1])),
            tokens=_rng(1).integers(0, 256, (4, 32), dtype=np.int32),
            train_tokens=_rng(2).integers(0, 256, (4, 33), dtype=np.int32)),
    }


# ------------------------------------------------------------ the cases
# Source run in the parent (on one device) and in each rank (on the mesh),
# which imports torch and the port only.
_CASES = textwrap.dedent("""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.hints import sharded_scope
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    LR = 1e-2
    PROFILES = ("tp", "seq", "dp-cache")


    def config(name, kw):
        cfg = get_config(name).reduced(**kw)
        if name == "deepseek-v2-lite-16b":   # no-drop capacity
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.num_experts))
        return cfg


    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", torch.tensor(np.asarray(v))


    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x


    def run_cases(inp, kw, mesh=None):
        \"\"\"Every case on the port, sharded on ``mesh`` (None: one device).
        Returns {key: numpy array} and {param name: local shape}.\"\"\"
        out, local = {}, {}

        def model_of(name, case, key=None):
            model = T.from_jax_params(inp[case]["tree"],
                                      config(name, kw[key or name]),
                                      device="cpu")
            return model if mesh is None else SH.shard_model(model, mesh)

        def place(t):
            return t if mesh is None else SH.shard_batch({"t": t}, mesh)["t"]

        def keep(prefix, tensors):
            for k, v in tensors.items():
                out[f"{prefix}{k}"] = full(v).detach().numpy()

        def train(prefix, name, case, tokens, accum, key=None):
            model = model_of(name, case, key)
            opt = AdamWConfig(lr=LR)
            state = adamw_init(dict(model.named_parameters()), opt)
            if mesh is not None:
                state = SH.shard_opt_state(state, model, mesh)
            m = make_train_step(config(name, kw[key or name]), opt,
                                accum_steps=accum)(
                model, state, {"tokens": place(torch.from_numpy(tokens))})
            keep(f"{prefix}.metric.", m)
            params = dict(model.named_parameters())
            keep(f"{prefix}.param.", params)
            keep(f"{prefix}.grad.", {k: p.grad for k, p in params.items()})
            for part in ("m", "v"):
                keep(f"{prefix}.{part}.", state[part])
            return params

        # llama3 train step (test_multidevice.py:28)
        params = train("train", "llama3-8b", "train", inp["train"]["tokens"], 1)
        if mesh is not None:
            local.update({k: list(p.to_local().shape)
                          for k, p in params.items()})
            out["train.grad_placed"] = np.asarray(all(
                tuple(p.grad.placements) == tuple(p.placements)
                for p in params.values()))
        # llama3 with one kv head: query heads over model
        train("mqa_train", "llama3-8b", "mqa", inp["mqa"]["tokens"], 1,
              key="mqa")
        # three heads: queries over model along the sequence
        train("odd_train", "llama3-8b", "odd", inp["odd"]["tokens"], 1,
              key="odd")
        # mamba2 train step in two micro-batches (kernel 6's Function)
        train("mamba_train", "mamba2-370m", "mamba",
              inp["mamba"]["train_tokens"], 2)

        with torch.no_grad():
            # llama3 prefill + decode (test_multidevice.py:72)
            model = model_of("llama3-8b", "decode")
            step_tok = place(torch.from_numpy(inp["decode"]["step"]))
            logits, caches = model.prefill(
                place(torch.from_numpy(inp["decode"]["tokens"])), buf_len=20)
            out["decode.prefill"] = full(logits).numpy()
            for profile in PROFILES if mesh is not None else ("tp",):
                c = {"blocks": {k: full(v).clone()
                                for k, v in caches["blocks"].items()}}
                if mesh is not None:
                    c = SH.shard_caches(c, mesh, profile=profile)
                l1, c = model.decode_step(step_tok, c, 16)
                l2, c = model.decode_step(step_tok, c, 17)
                out[f"decode.{profile}.logits"] = np.stack(
                    [full(l1).numpy(), full(l2).numpy()])
                out[f"decode.{profile}.k"] = full(c["blocks"]["k"]).numpy()

            # deepseek MoE + MLA forward (test_multidevice.py:126)
            model = model_of("deepseek-v2-lite-16b", "moe_mla")
            logits, _ = model.forward_train(
                place(torch.from_numpy(inp["moe_mla"]["tokens"])), remat=False)
            out["moe_mla.logits"] = full(logits).numpy()

            # the MoE FFN alone (test_multidevice.py:167): experts over
            # model, tokens over data, the rest replicated
            cfg = config("deepseek-v2-lite-16b", kw["deepseek-v2-lite-16b"])
            moe = M.MoE(cfg)
            moe.load_state_dict(dict(flat(inp["moe_ffn"]["tree"])),
                                strict=True)
            x = torch.from_numpy(inp["moe_ffn"]["x"])
            if mesh is not None:
                for name, p in list(moe.named_parameters()):
                    owner, _, leaf = name.rpartition(".")
                    spec = ("model", None, None) if p.ndim == 3 else ()
                    setattr(moe.get_submodule(owner), leaf, torch.nn.Parameter(
                        SH.distribute(p.detach(), spec, mesh)))
                x = SH.distribute(x, ("data", None, None), mesh)
            with sharded_scope(x):
                y, aux = moe(x)
            out["moe_ffn.y"] = full(y).numpy()
            out["moe_ffn.aux"] = np.asarray(float(full(aux)))

            # MLA attention alone (test_multidevice.py:241)
            mla = A.MLA(cfg)
            mla.load_state_dict(dict(flat(inp["mla"]["tree"])), strict=True)
            x = torch.from_numpy(inp["mla"]["x"])
            if mesh is not None:
                specs = {"wq": ("data", "model"), "w_dkv": ("data", "model"),
                         "w_uk": ("data", "model"), "w_uv": ("data", "model"),
                         "wo": ("model", "data")}
                for name, lin in mla.named_children():
                    lin.w = torch.nn.Parameter(SH.distribute(
                        lin.w.detach(), specs[name], mesh))
                x = SH.distribute(x, ("data", None, None), mesh)
            with sharded_scope(x):
                out["mla.y"] = full(mla(x, T.make_positions(4, 16))).numpy()

            # mamba2 forward (test_multidevice.py:379)
            model = model_of("mamba2-370m", "mamba")
            logits, _ = model.forward_train(
                place(torch.from_numpy(inp["mamba"]["tokens"])), remat=False)
            out["mamba.logits"] = full(logits).numpy()

        # the train launcher, two steps
        rep = launch_train.train("mamba2-370m", reduced=True, steps=2,
                                 batch=4, seq=32, device="cpu", mesh=mesh)
        out["launcher.loss"] = np.asarray(rep["loss"])
        out["launcher.grad_norm"] = np.asarray(rep["grad_norm"])
        return out, local
""")
CASES = {}
exec(_CASES, CASES)
KW = {"llama3-8b": LLAMA, "deepseek-v2-lite-16b": DEEPSEEK,
      "mamba2-370m": MAMBA, "mqa": MQA, "odd": ODD_HEADS}


# One rank: join the gloo group through a file, run every case on the
# mesh, save what it computed.
_RANK = _CASES + textwrap.dedent("""
    import json, pickle, sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    spec = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method="file://" + spec["rendezvous"],
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out, local = run_cases(inputs, spec["kw"], mesh)
    finally:
        dist.destroy_process_group()
    np.savez(spec["out"] + f"-{rank}.npz", **out)
    with open(spec["out"] + f"-{rank}.json", "w") as f:
        json.dump(local, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, their local shapes, the port on one device,
    the inputs)."""
    import pickle

    tmp = tmp_path_factory.mktemp("multidevice")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spec = json.dumps({"rendezvous": str(tmp / "rdv"),
                       "inputs": str(tmp / "inputs.pkl"),
                       "out": str(tmp / "rank"), "kw": KW})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, spec, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        single, _ = CASES["run_cases"](inputs, KW)   # meanwhile, one device
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    ranks = [dict(np.load(tmp / f"rank-{r}.npz")) for r in range(4)]
    local = [json.load(open(tmp / f"rank-{r}.json")) for r in range(4)]
    return ranks[0], local, single, inputs


def _close(got, want, tol=SHARD_TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _close_to_single(run, single, prefix):
    for key, want in single.items():
        if not key.startswith(prefix):
            continue
        got = run[key]
        if ".metric." in key:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        elif ".param." in key:
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-3,
                                       err_msg=key)
        else:
            _close(got, want, what=key)


def _ref_params(tree, cfg):
    return {k: v.numpy() for k, v in T._state_from_jax(tree, cfg).items()}


# ------------------------------------------------------------------ tests

def test_sharded_train_step_matches_single_device(runs):
    run, local, single, inp = runs
    _close_to_single(run, single, "train.")
    assert bool(run["train.grad_placed"])
    cfg, jcfg = _cfgs("llama3-8b", **LLAMA)
    jopt = JaxAdamWConfig(lr=LR)
    params = jax.tree_util.tree_map(jnp.asarray, inp["train"]["tree"])
    p1, _, m1 = jax.jit(jax_make_train_step(jcfg, jopt))(
        params, jax_adamw_init(params, jopt),
        {"tokens": jnp.asarray(inp["train"]["tokens"])})
    np.testing.assert_allclose(run["train.metric.loss"], float(m1["loss"]),
                               rtol=1e-4)
    for name, want in _ref_params(_np(p1), cfg).items():
        np.testing.assert_allclose(run[f"train.param.{name}"], want,
                                   rtol=5e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case,kw", [("mqa", MQA), ("odd", ODD_HEADS)])
def test_sharded_attention_split_train_step_matches_single_device(runs, case,
                                                                   kw):
    """llama3 with one kv head (query heads over model) and with three
    heads (queries over model along the sequence)."""
    run, _, single, inp = runs
    _close_to_single(run, single, f"{case}_train.")
    cfg, jcfg = _cfgs("llama3-8b", **kw)
    jopt = JaxAdamWConfig(lr=LR)
    params = jax.tree_util.tree_map(jnp.asarray, inp[case]["tree"])
    p1, _, m1 = jax.jit(jax_make_train_step(jcfg, jopt))(
        params, jax_adamw_init(params, jopt),
        {"tokens": jnp.asarray(inp[case]["tokens"])})
    np.testing.assert_allclose(run[f"{case}_train.metric.loss"],
                               float(m1["loss"]), rtol=1e-4)
    for name, want in _ref_params(_np(p1), cfg).items():
        np.testing.assert_allclose(run[f"{case}_train.param.{name}"], want,
                                   rtol=5e-3, atol=2e-3, err_msg=name)


def test_each_rank_holds_its_shards(runs):
    _, local, _, _ = runs
    with torch.device("meta"):
        model = T.DecoderLM(_cfgs("llama3-8b", **LLAMA)[0])
    params = dict(model.named_parameters())
    specs = SH.params_shardings(SimpleNamespace(shape=MESH), params)
    sharded = 0
    for name, p in params.items():
        want = list(p.shape)
        for dim, ax in enumerate(specs[name]):
            if ax is not None:
                want[dim] //= MESH[ax]
        sharded += want != list(p.shape)
        for r in range(4):
            assert local[r][name] == want, (r, name, local[r][name], want)
    assert sharded > 0


def test_sharded_mamba_train_step_matches_single_device(runs):
    run, _, single, inp = runs
    _close_to_single(run, single, "mamba_train.")
    cfg, jcfg = _cfgs("mamba2-370m", **MAMBA)
    jopt = JaxAdamWConfig(lr=LR)
    params = jax.tree_util.tree_map(jnp.asarray, inp["mamba"]["tree"])
    p1, _, m1 = jax.jit(jax_make_train_step(jcfg, jopt, accum_steps=2))(
        params, jax_adamw_init(params, jopt),
        {"tokens": jnp.asarray(inp["mamba"]["train_tokens"])})
    np.testing.assert_allclose(run["mamba_train.metric.loss"],
                               float(m1["loss"]), rtol=1e-4)
    for name, want in _ref_params(_np(p1), cfg).items():
        np.testing.assert_allclose(run[f"mamba_train.param.{name}"], want,
                                   rtol=5e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("profile", PROFILES)
def test_sharded_decode_matches_single_device(runs, profile):
    run, _, single, inp = runs
    _close(run["decode.prefill"], single["decode.prefill"], what="prefill")
    _close(run[f"decode.{profile}.logits"], single["decode.tp.logits"],
           what="logits")
    _close(run[f"decode.{profile}.k"], single["decode.tp.k"], what="k")
    jcfg = _cfgs("llama3-8b", **LLAMA)[1]
    params = jax.tree_util.tree_map(jnp.asarray, inp["decode"]["tree"])
    _, caches = jax_T.prefill(params, jnp.asarray(inp["decode"]["tokens"]),
                              jcfg, buf_len=20)
    l1, _ = jax_T.decode_step(params, jnp.asarray(inp["decode"]["step"]),
                              caches, 16, jcfg)
    np.testing.assert_allclose(run[f"decode.{profile}.logits"][0],
                               np.asarray(l1), rtol=2e-3, atol=2e-3)


def test_sharded_moe_mla_forward_matches_single_device(runs):
    run, _, single, inp = runs
    _close(run["moe_mla.logits"], single["moe_mla.logits"], what="logits")
    jcfg = _cfgs("deepseek-v2-lite-16b", **DEEPSEEK)[1]
    params = jax.tree_util.tree_map(jnp.asarray, inp["moe_mla"]["tree"])
    l1, _ = jax_T.forward_train(params, jnp.asarray(inp["moe_mla"]["tokens"]),
                                jcfg, remat=False)
    np.testing.assert_allclose(run["moe_mla.logits"], np.asarray(l1),
                               rtol=5e-3, atol=5e-3)


def test_sharded_moe_ffn_matches_single_device(runs):
    run, _, single, inp = runs
    np.testing.assert_array_equal(run["moe_ffn.y"], single["moe_ffn.y"])
    assert float(run["moe_ffn.aux"]) == float(single["moe_ffn.aux"])
    jcfg = _cfgs("deepseek-v2-lite-16b", **DEEPSEEK)[1]
    params = jax.tree_util.tree_map(jnp.asarray, inp["moe_ffn"]["tree"])
    y1, aux1 = jax_M.moe_ffn(params, jnp.asarray(inp["moe_ffn"]["x"]), jcfg)
    np.testing.assert_allclose(run["moe_ffn.y"], np.asarray(y1), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(run["moe_ffn.aux"]), float(aux1),
                               rtol=2e-5, atol=2e-5)


def test_sharded_mla_attention_matches_single_device(runs):
    run, _, single, inp = runs
    _close(run["mla.y"], single["mla.y"], what="mla")
    jcfg = _cfgs("deepseek-v2-lite-16b", **DEEPSEEK)[1]
    params = jax.tree_util.tree_map(jnp.asarray, inp["mla"]["tree"])
    pos = jnp.broadcast_to(jnp.arange(16)[None, :], (4, 16)).astype(jnp.int32)
    y1 = jax_A.mla_train(params, jnp.asarray(inp["mla"]["x"]), pos, jcfg)
    np.testing.assert_allclose(run["mla.y"], np.asarray(y1), rtol=1e-4,
                               atol=1e-5)


def test_sharded_mamba_forward_matches_single_device(runs):
    run, _, single, inp = runs
    _close(run["mamba.logits"], single["mamba.logits"], what="logits")
    jcfg = _cfgs("mamba2-370m", **MAMBA)[1]
    params = jax.tree_util.tree_map(jnp.asarray, inp["mamba"]["tree"])
    l1, _ = jax_T.forward_train(params, jnp.asarray(inp["mamba"]["tokens"]),
                                jcfg, remat=False)
    np.testing.assert_allclose(run["mamba.logits"], np.asarray(l1),
                               rtol=5e-3, atol=5e-3)


def test_train_launcher_on_a_mesh_matches_one_device(runs):
    run, _, single, _ = runs
    np.testing.assert_allclose(run["launcher.loss"], single["launcher.loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(run["launcher.grad_norm"],
                               single["launcher.grad_norm"], rtol=1e-4)
