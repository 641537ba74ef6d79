"""The port's Mamba2 language model against the JAX package's, on the CPU.

The reduced ``mamba2-370m`` (2 layers, d_model 256, vocab 512, ssm_state 16,
headdim 16, chunk 8) with the reference's random weights carried across by
``from_jax_params``: prefill logits and caches, decode steps and greedy
``Engine.generate`` must match the JAX package.

Tolerances: ``rtol = atol = 2e-4`` on logits, caches and mixer outputs —
float32 on both sides, with matrix products and cumulative sums reduced in
another order by each framework (about 1e-6 relative per product, carried
through two residual layers). Greedy tokens must be equal: argmax returns
the first maximum in both frameworks, and at this seed no two logits of a
step lie within the tolerance of each other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_configs as jax_list_configs  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402

from repro_torch.configs import ArchConfig, get_config, list_configs  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def cfg():
    return get_config("mamba2-370m").reduced()


@pytest.fixture(scope="module")
def jax_params(cfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("mamba2-370m").reduced())
    params = jax_T.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def model(jax_params, cfg):
    return T.from_jax_params(jax_params, cfg, device="cpu")


def _prompts(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_config_registry_has_only_the_ported_config():
    """The registry holds all ten configs, each equal to the reference's."""
    assert list_configs() == jax_list_configs() and len(list_configs()) == 10
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
    full = get_config("mamba2-370m")
    assert (full.num_layers, full.d_model, full.vocab_size, full.ssm_state,
            full.ssm_headdim, full.ssm_chunk) == (48, 1024, 50280, 128, 64, 256)
    with pytest.raises(KeyError, match="mamba2-370m"):
        get_config("llama3-70b")


def test_other_families_raise_naming_the_roadmap():
    """Every registered family builds; an unknown ``family`` raises."""
    llama = jax_get_config("llama3-8b").reduced()
    port_cfg = ArchConfig(**dataclasses.asdict(llama))
    assert isinstance(T.DecoderLM(port_cfg).blocks[0].attn, torch.nn.Module)
    with pytest.raises(ValueError, match="family"):
        T.DecoderLM(dataclasses.replace(port_cfg, family="diffusion"))


def test_from_jax_params_carries_every_weight(jax_params, model, cfg):
    sd = model.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(jax_params))
    n_block_leaves = len(jax.tree_util.tree_leaves(jax_params["blocks"]))
    assert len(sd) == n_leaves - n_block_leaves + n_block_leaves * cfg.num_layers
    np.testing.assert_array_equal(
        sd["blocks.1.mixer.in_xbc.w"].numpy(),
        jax_params["blocks"]["mixer"]["in_xbc"]["w"][1])
    np.testing.assert_array_equal(sd["lm_head.w"].numpy(),
                                  jax_params["lm_head"]["w"])


@pytest.mark.parametrize("seq", [16, 21])
def test_mixer_forward_matches_mamba2_train(jax_params, model, cfg, seq):
    """Block 0's mixer alone (= ``mamba2_train``): multi-chunk, and S not a
    multiple of the chunk."""
    x = np.random.default_rng(seq).normal(size=(2, seq, cfg.d_model)).astype(
        np.float32)
    mixer_params = jax.tree_util.tree_map(lambda a: a[0],
                                          jax_params["blocks"]["mixer"])
    want_y, want_state = jax_ssm.mamba2_train(mixer_params, jnp.asarray(x), cfg)
    with torch.no_grad():
        got_y, got_state = model.blocks[0].mixer(torch.from_numpy(x))
    _close(got_y, want_y)
    _close(got_state, want_state)


@pytest.mark.parametrize("seq", [16, 13])
def test_prefill_and_decode_match_reference(jax_params, model, cfg, seq):
    tokens = _prompts(cfg, 2, seq)
    want_logits, want_caches = jax_T.prefill(jax_params, jnp.asarray(tokens),
                                             cfg)
    got_logits, got_caches = model.prefill(torch.from_numpy(tokens).long())
    assert got_logits.shape == (2, 1, cfg.vocab_size)
    _close(got_logits, want_logits)
    for key in ("conv", "state"):
        assert got_caches["blocks"][key].shape == want_caches["blocks"][key].shape
        _close(got_caches["blocks"][key], want_caches["blocks"][key])

    # 4 decode steps, feeding both the reference's greedy tokens.
    tok = np.asarray(jnp.argmax(want_logits[:, 0], axis=-1)).astype(np.int32)
    for i in range(4):
        want_logits, want_caches = jax_T.decode_step(
            jax_params, jnp.asarray(tok[:, None]), want_caches, seq + i, cfg)
        got_logits, got_caches = model.decode_step(
            torch.from_numpy(tok[:, None]).long(), got_caches, seq + i)
        _close(got_logits, want_logits)
        for key in ("conv", "state"):
            _close(got_caches["blocks"][key], want_caches["blocks"][key])
        tok = np.asarray(jnp.argmax(want_logits[:, 0], axis=-1)).astype(
            np.int32)


def test_init_decode_caches_match_reference_layout(model, cfg):
    want = jax_T.init_decode_caches(cfg, 3, 8)
    got = model.init_decode_caches(3, 8)
    for key in ("conv", "state"):
        assert tuple(got["blocks"][key].shape) == want["blocks"][key].shape
        assert not got["blocks"][key].any()


def test_engine_greedy_tokens_equal_reference(jax_params, model, cfg):
    prompts = _prompts(cfg, 3, 19, seed=1)
    want = JaxEngine(cfg, jax_params, JaxServeConfig(max_new_tokens=6)) \
        .generate(prompts)
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=6), device="cpu")
    got = eng.generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    assert eng.last_timing["decode_steps"] == 5


def test_engine_sampling_is_seeded(model, cfg):
    prompts = _prompts(cfg, 2, 9)
    runs = [Engine(cfg, model, ServeConfig(max_new_tokens=5, temperature=0.8,
                                           seed=seed), device="cpu")
            .generate(prompts) for seed in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (2, 5)
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()


def test_engine_refuses_kv_bits_and_a_model_on_another_device(model, cfg):
    """``kv_bits`` must divide 32 (a 3-bit code would straddle words)."""
    with pytest.raises(ValueError, match="divide 32"):
        Engine(cfg, model, ServeConfig(kv_bits=3), device="cpu")
    Engine(cfg, model, ServeConfig(kv_bits=8), device="cpu")
    with pytest.raises(ValueError, match="model.to"):
        Engine(cfg, model, device="meta")


def test_init_params_draws_the_reference_distributions(cfg):
    model = T.init_params(cfg, seed=0, device="cpu")
    mixer = model.blocks[0].mixer
    h = mixer.A_log.shape[0]
    np.testing.assert_allclose(mixer.A_log.detach().numpy(),
                               np.log(np.linspace(1.0, 16.0, h)), rtol=1e-6)
    assert torch.all(mixer.D == 1) and not mixer.dt_bias.any()
    assert not mixer.conv_b.any() and torch.all(model.final_norm.scale == 1)
    std = float(mixer.in_xbc.w.detach().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
    assert abs(float(model.embed.table.detach().std()) - 0.02) < 0.002
    again = T.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "mamba2-370m", "--reduced",
                              "--device", "cpu", "--requests", "2",
                              "--prompt-len", "12", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "mamba2-370m on cpu" in out and "ms/token" in out
