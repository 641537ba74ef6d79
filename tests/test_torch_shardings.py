"""The port's sharding rules (``repro_torch.launch.shardings``) against the
JAX package's (``repro.launch.shardings``), on the CPU.

Counterparts of ``tests/test_system.py``'s rule tests (``fit_spec``, the
name rules, every config's specs dividing the production mesh), then, for
all ten configs at full size on a fake 16 × 16 ("data", "model") mesh and
a fake 2 × 16 × 16 ("pod", "data", "model") one: every port parameter's
fitted spec equals the reference's on the parameter's dims. The port's
model is built on the ``meta`` device; the reference's leaves come from
``jax.eval_shape``; a port name maps to the reference's stacked leaf by
dropping its layer indices (``blocks.3.attn.wq.w`` → ``blocks/attn/wq/w``,
whose leading stack axes, one per index, the rules leave unsharded). The
same for the AdamW moments (which inherit their parameter's spec) and
``step``, a train batch, and the decode caches of every config in all
three profiles, with and without ``long_context`` (the caches keep the
reference's stacked layout, so their specs must be equal whole). The
reference's ``*_shardings`` wrap each spec in a ``NamedSharding``, which
needs a real mesh: the tests read the specs out with ``NamedSharding``
swapped for a function that returns its spec.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

CONFIGS = list_configs()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
FAKE = SimpleNamespace(shape={"data": 16, "model": 16})
DECODE_BATCH, DECODE_SEQ = 128, 32768      # decode_32k


def _mesh(sizes):
    """A stand-in both packages' rules read: ``shape`` and ``axis_names``."""
    return SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding builders with specs in place of
    ``NamedSharding``s."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    return JSH


def _norm(spec, ndim):
    """A spec as a tuple of one entry per dim."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


@functools.lru_cache(maxsize=None)
def _port_model(name):
    with torch.device("meta"):
        return T.DecoderLM(get_config(name))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    cfg = jax_get_config(name)
    sds = jax.eval_shape(lambda k: jax_T.init_params(k, cfg,
                                                     dtype=jnp.bfloat16),
                         jax.random.PRNGKey(0))
    return sds


def _ref_leaves(tree):
    """{dotted name: (path, leaf)} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(p, "key", getattr(p, "name", p))) for p in path]
        out[".".join(names)] = (path, leaf)
    return out


def _ref_name(port_name):
    """(reference name, stack axes) of a port parameter: its layer
    indices dropped, one stack axis each."""
    parts = port_name.split(".")
    kept = [p for p in parts if not p.isdigit()]
    return ".".join(kept), len(parts) - len(kept)


# ---------------------------------------------------- rules (test_system)

def test_fit_spec_drops_nondivisible_axes():
    assert SH.fit_spec(("model", None), (50280, 1024), FAKE) == (None, None)
    assert SH.fit_spec(("model", None), (49152, 1024), FAKE) == \
        ("model", None)
    assert SH.fit_spec((("data",), None), (1, 1), FAKE) == (None, None)
    assert SH.fit_spec(("data", "model"), (256, 4096), FAKE) == \
        ("data", "model")
    # one entry per dim, however short the spec
    assert SH.fit_spec((), (4, 4, 4), FAKE) == (None, None, None)


def test_param_pspec_rules():
    leaf2 = SimpleNamespace(ndim=2)
    leaf3 = SimpleNamespace(ndim=3)
    assert SH.param_pspec("blocks.0.attn.wq.w", leaf2) == ("data", "model")
    assert SH.param_pspec("blocks.0.attn.wo.w", leaf2) == ("model", "data")
    assert SH.param_pspec("blocks.0.ffn.experts.gate", leaf3) == \
        ("model", "data", None)
    assert SH.param_pspec("embed.table", leaf2) == ("model", None)
    assert SH.param_pspec("cb_embed.table", leaf3) == (None, "model", None)
    assert SH.param_pspec("final_norm.scale", SimpleNamespace(ndim=1)) == \
        (None,)
    assert SH.param_pspec("blocks.0.mixer.conv_w", leaf2) == (None, None)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    fake = SimpleNamespace(shape=mesh)
    assert SH.to_placements((("pod", "data"), "model"), fake) == \
        [Shard(0), Shard(0), Shard(1)]
    assert SH.to_placements((None, None), fake) == [Replicate()] * 3
    # a dim of size 1 and a mesh axis of size 1 stay whole
    assert SH.to_placements(("data", "model"), fake, (1, 8)) == \
        [Replicate(), Replicate(), Shard(1)]
    one = SimpleNamespace(shape={"data": 1, "model": 1})
    assert SH.to_placements(("data", "model"), one) == [Replicate()] * 2
    with pytest.raises(ValueError, match="major-to-minor"):
        SH.to_placements((("data", "pod"),), fake)


def test_every_arch_param_has_valid_specs():
    """Fitted specs divide their dims under the production mesh."""
    for name in CONFIGS:
        for pname, p in _port_model(name).named_parameters():
            spec = SH.fit_spec(SH.param_pspec(pname, p), p.shape, FAKE)
            for i, ax in enumerate(spec):
                if ax is not None:
                    assert p.shape[i] % 16 == 0, (name, pname, p.shape)


# ------------------------------------------------ against the reference

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_param_and_opt_specs_equal_the_reference(name, mesh_name,
                                                 ref_specs):
    mesh = _mesh(MESHES[mesh_name])
    model = _port_model(name)
    params = dict(model.named_parameters())
    ref = _ref_leaves(ref_specs.params_shardings(mesh, _ref_params(name)))
    leaves = _ref_leaves(_ref_params(name))
    port = SH.params_shardings(mesh, params)
    seen = set()
    for pname, p in params.items():
        rname, lead = _ref_name(pname)
        _, leaf = leaves[rname]
        assert tuple(leaf.shape[lead:]) == tuple(p.shape), pname
        want = _norm(ref[rname][1], leaf.ndim)
        assert all(ax is None for ax in want[:lead]), (rname, want)
        assert port[pname] == want[lead:], (pname, port[pname], want)
        seen.add(rname)
    assert seen == set(leaves)          # every reference leaf has a twin

    # AdamW moments inherit their parameter's spec; step is replicated.
    opt = adamw_init(params, AdamWConfig())
    o_port = SH.opt_shardings(mesh, opt)
    assert o_port["step"] == ()
    for part in ("m", "v"):
        assert o_port[part] == port
    ref_opt = ref_specs.opt_shardings(mesh, jax.eval_shape(
        lambda p: jax_adamw_init(p, JaxAdamWConfig()), _ref_params(name)))
    assert _norm(ref_opt["step"], 0) == ()
    for part in ("m", "v"):
        ref_part = _ref_leaves(ref_opt[part])
        for pname in params:
            rname, lead = _ref_name(pname)
            assert _norm(ref_part[rname][1], lead + params[pname].ndim)[
                lead:] == port[pname]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_batch_specs_equal_the_reference(name, mesh_name, ref_specs):
    mesh = _mesh(MESHES[mesh_name])
    cfg = get_config(name)
    b, s = 256, 4097                   # train_4k
    shape = (b, cfg.num_codebooks, s) if cfg.num_codebooks else (b, s)
    batch = {"tokens": np.zeros(shape, np.int32)}
    if cfg.mrope:
        batch["embeds"] = np.zeros((b, cfg.vlm_num_patches, cfg.d_model),
                                   np.float32)
    port = SH.batch_shardings(mesh, {k: torch.empty(v.shape, device="meta")
                                     for k, v in batch.items()})
    ref = ref_specs.batch_shardings(mesh, batch)
    assert port == {k: _norm(v, batch[k].ndim) for k, v in ref.items()}
    # a batch of one fits no axis
    one = SH.batch_shardings(mesh, {"t": torch.empty((1, 1), device="meta")})
    assert one == {"t": (None, None)}


def _cache_pairs(tree, ref, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_pairs(v, ref[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v, ref[k]


@pytest.mark.parametrize("profile", ["tp", "dp-cache", "seq"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_specs_equal_the_reference(name, mesh_name, profile,
                                         ref_specs):
    mesh = _mesh(MESHES[mesh_name])
    caches = _port_model(name).init_decode_caches(DECODE_BATCH, DECODE_SEQ)
    jcfg = jax_get_config(name)
    ref_caches = jax.eval_shape(lambda: jax_T.init_decode_caches(
        jcfg, DECODE_BATCH, DECODE_SEQ, dtype=jnp.bfloat16))
    for long_context in (False, True):
        port = SH.cache_shardings(mesh, caches, long_context=long_context,
                                  profile=profile)
        ref = ref_specs.cache_shardings(mesh, ref_caches,
                                        long_context=long_context,
                                        profile=profile)
        pairs = list(_cache_pairs(caches, ref_caches))
        assert pairs
        for key, leaf, ref_leaf in pairs:
            assert tuple(leaf.shape) == tuple(ref_leaf.shape), key
        for key, spec, ref_spec in _cache_pairs(port, ref):
            assert spec == _norm(ref_spec, len(spec)), (key, long_context)


def test_cache_profile_is_checked():
    with pytest.raises(ValueError, match="profile"):
        SH.cache_shardings(FAKE, {}, profile="zz")
