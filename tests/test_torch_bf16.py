"""The port's language models with the reference's bf16 parameters, on the
CPU.

bf16 is the reference's production dtype (``repro.launch.dryrun`` lowers
every pair in it). Each of the ten configs at its reduced size (gemma3 and
zamba2 at ``num_layers=7``, as ``tests/test_torch_archs.py``) takes the
reference's ``init_params(..., dtype=jnp.bfloat16)`` tree through
``from_jax_params``:

* every leaf is carried bit for bit in the reference's dtype (bf16, the
  MoE routers and the Mamba2 mixers' ``A_log``, ``D``, ``dt_bias`` f32);
* the prefill logits, every cache leaf (in the reference's dtype) and 4
  decode steps fed the reference's greedy tokens match the JAX package's
  bf16 ``Engine._prefill`` / ``_decode``.

Tolerance of the bf16 parity. The two frameworks round bf16 differently
at many points (XLA's bf16 ``logistic`` alone differs from torch's in a
third of the elements; its matrix products sum in another order), so the
port's bf16 run cannot equal the reference's bit for bit; it lies from it
about as far as the reference's bf16 run lies from its own f32 run of the
same weights. Each quantity (the logits, each cache leaf, each decode
step's logits) is held within ``BF16_GAPS = 2`` times the reference's own
bf16-vs-f32 gap of that quantity, gaps taken as the largest absolute
difference over the largest f32 magnitude. Measured ratios: 0.58-1.59
(the largest at zamba2's fourth decode step); a routing flip in
deepseek-v2-lite-16b's first MoE layer moves one token's second-layer
cache by 0.27 of its largest value, where the reference's own bf16 flip
moves it by 0.23. The port's bf16 prefill logits must also lie no
farther from the reference's f32 logits than 1.5 times the reference's
bf16 logits do (measured 0.64-1.20).

Elsewhere here: GQA attention on identical bf16 inputs against the
reference's ``_attend`` (f32 scores and softmax: at least 99.9 % of the
outputs equal bit for bit and none off by more than one bf16 step of the
largest output; bf16 scores, as the port had them, left 69-78 % of them
off); ``init_params(dtype=bf16)`` is
``init_params()`` rounded, and runs prefill, decode and a train step for
every config; the OSQ KV packer packs the reference's bf16 caches to its
words, bit for bit; mamba2-370m at its full width and 2, 8 and 48 layers
and llama3-8b at its full width and 2 layers, where the reference's own
bf16 gap sets the card's bf16 limits (``chip_smoke.BF16_TOL``); and one
``make_train_step`` step from bf16 parameters against the reference's
(see ``test_train_step_bf16_matches_reference``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_A  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import kv_quant as jax_kvq  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import kv_quant  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ARCHS = list_configs()
ONE_UNIT = {"gemma3-4b": 7, "zamba2-7b": 7}
BATCH, PROMPT, NEW, DECODE_STEPS = 2, 21, 5, 4
BF16_GAPS = 2.0          # × the reference's own bf16-vs-f32 gap
PREFILL_VS_F32 = 1.5     # port bf16 vs ref f32, × ref bf16 vs ref f32
BF16_STEP = 2.0 ** -8    # one bf16 step at a value in [1, 2)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x) -> np.ndarray:
    """A leaf's bit pattern (bf16 as uint16), for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint16) if x.dtype == torch.bfloat16 else
                x).numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _gap(a, b, scale) -> float:
    return float(np.abs(_f32(a) - _f32(b)).max()
                 / max(np.abs(_f32(scale)).max(), 1e-30))


def _bf16_close(name, port, ref_bf16, ref_f32) -> None:
    """``port`` within BF16_GAPS × the reference's own bf16 rounding gap
    of the reference's bf16 value."""
    got, own = _gap(port, ref_bf16, ref_f32), _gap(ref_bf16, ref_f32, ref_f32)
    assert got <= BF16_GAPS * own, (name, got, own)


def _torch_tree(tree):
    """A reference tree of numpy leaves as torch tensors, bf16 bitwise."""
    return {k: _torch_tree(v) if isinstance(v, dict) else
            T._as_tensor(np.asarray(v)) for k, v in tree.items()}


class Case:
    """One reduced config: the reference's bf16 and f32 trees of one key,
    the port's model from the bf16 tree, inputs and both reference
    engines."""

    def __init__(self, name):
        layers = ONE_UNIT.get(name)
        kw = {"num_layers": layers} if layers else {}
        self.name = name
        self.cfg = get_config(name).reduced(**kw)
        self.jcfg = jax_get_config(name).reduced(**kw)
        key = jax.random.PRNGKey(0)
        self.params = {
            dt: jax.tree_util.tree_map(np.asarray, jax_T.init_params(
                key, self.jcfg, dtype=dt))
            for dt in (jnp.bfloat16, jnp.float32)}
        self.model = T.from_jax_params(self.params[jnp.bfloat16], self.cfg,
                                       device="cpu")
        rng = np.random.default_rng(0)
        shape = ((BATCH, self.cfg.num_codebooks, PROMPT)
                 if self.cfg.num_codebooks else (BATCH, PROMPT))
        self.tokens = rng.integers(0, self.cfg.vocab_size, shape,
                                   dtype=np.int32)
        self.embeds = (rng.normal(size=(BATCH, self.cfg.vlm_num_patches,
                                        self.cfg.d_model)).astype(np.float32)
                       if self.cfg.mrope else None)
        self.prefix = self.cfg.vlm_num_patches if self.cfg.mrope else 0
        self.buf_len = self.prefix + PROMPT + NEW
        self.engines = {dt: JaxEngine(self.jcfg, p, JaxServeConfig(
            max_new_tokens=NEW)) for dt, p in self.params.items()}
        self._jax_prefill = {}

    def jax_prefill(self, dt):
        if dt not in self._jax_prefill:
            emb = None if self.embeds is None else jnp.asarray(self.embeds)
            self._jax_prefill[dt] = self.engines[dt]._prefill(
                self.params[dt], jnp.asarray(self.tokens),
                buf_len=self.buf_len, embeds=emb)
        return self._jax_prefill[dt]

    def port_prefill(self):
        emb = None if self.embeds is None else torch.from_numpy(self.embeds)
        return self.model.prefill(torch.from_numpy(self.tokens).long(),
                                  buf_len=self.buf_len, embeds=emb)


_CASES = {}


def _case(name) -> Case:
    """The module's one Case of ``name``."""
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def test_from_jax_params_carries_bf16_tree_bitwise(case):
    sd = case.model.state_dict()
    want = dict(_leaves(case.params[jnp.bfloat16]))
    hybrid = T._schedule(case.cfg)[0] == "hybrid"
    carried = {key: arr for name, leaf in want.items()
               for key, arr in T._unstack(name, leaf, hybrid)}
    assert sd.keys() == carried.keys()
    f32 = case.model.f32_param_names()
    for key, val in sd.items():
        ref = carried[key]
        assert _dtype_name(val) == str(ref.dtype), key
        assert (_dtype_name(val) == "float32") == (key in f32), key
        np.testing.assert_array_equal(_bits(val), _bits(ref), err_msg=key)
    # the f32 islands are the reference's: routers, A_log, D, dt_bias
    assert {k.removesuffix(".w").rsplit(".", 1)[-1] for k in f32} <= {
        "router", "A_log", "D", "dt_bias"}
    assert bool(f32) == bool(case.cfg.num_experts
                             or case.cfg.family in ("ssm", "hybrid"))


def test_bf16_prefill_matches_reference(case):
    want_b, caches_b = case.jax_prefill(jnp.bfloat16)
    want_f, caches_f = case.jax_prefill(jnp.float32)
    got, caches = case.port_prefill()
    assert got.dtype == torch.bfloat16 and got.shape == want_b.shape
    _bf16_close("logits", got, want_b, want_f)
    assert _gap(got, want_f, want_f) <= PREFILL_VS_F32 * _gap(
        want_b, want_f, want_f)
    want_b, want_f = dict(_leaves(caches_b)), dict(_leaves(caches_f))
    got = dict(_leaves(caches))
    assert got.keys() == want_b.keys()
    for key, leaf in got.items():
        assert _dtype_name(leaf) == str(want_b[key].dtype), key
        assert tuple(leaf.shape) == want_b[key].shape, key
        _bf16_close(key, leaf, want_b[key], want_f[key])


def test_bf16_decode_matches_reference(case):
    """4 steps from the prefill, every run fed the reference's bf16 greedy
    tokens; the caches after them too."""
    jb, jf = jnp.bfloat16, jnp.float32
    logits_b, caches = {}, {}
    logits_b, caches[jb] = case.jax_prefill(jb)
    caches[jf] = case.jax_prefill(jf)[1]
    port_caches = case.port_prefill()[1]
    audio = bool(case.cfg.num_codebooks)
    tok = np.asarray(jnp.argmax(logits_b[:, 0], axis=-1)).astype(np.int32)
    for i in range(DECODE_STEPS):
        step = tok[:, :, None] if audio else tok[:, None]
        pos = case.prefix + PROMPT + i
        want = {}
        for dt in (jb, jf):
            want[dt], caches[dt] = case.engines[dt]._decode(
                case.params[dt], jnp.asarray(step), caches[dt], pos)
        got, port_caches = case.model.decode_step(
            torch.from_numpy(step).long(), port_caches, pos)
        assert got.dtype == torch.bfloat16
        _bf16_close(f"decode step {i}", got, want[jb], want[jf])
        tok = np.asarray(jnp.argmax(want[jb][:, 0], axis=-1)).astype(
            np.int32)
    want_b, want_f = dict(_leaves(caches[jb])), dict(_leaves(caches[jf]))
    for key, leaf in _leaves(port_caches):
        assert _dtype_name(leaf) == str(want_b[key].dtype), key
        _bf16_close(key, leaf, want_b[key], want_f[key])


@pytest.mark.parametrize("window", [0, 64])
def test_gqa_attention_scores_in_f32(window):
    """Fault (c): bf16 q, k, v into GQA attention, chunked over 3 query
    blocks, against the reference's ``_attend`` on the same inputs."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    b, s, h, kv, hd = 2, 1100, 8, 2, 64

    def draw(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(ml_dtypes.bfloat16)

    q, k, v = (draw((b, s, h, hd), 1.5), draw((b, s, kv, hd), 1.5),
               draw((b, s, kv, hd)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    want = jax.jit(lambda q, k, v, p: jax_A._attend(q, k, v, p, p, window))(
        q, k, v, pos)
    tp = torch.from_numpy(pos)
    bf16 = lambda a: torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    got = A._attend(bf16(q), bf16(k), bf16(v), tp, tp, window)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    assert float(np.mean(diff == 0)) >= 0.999
    assert float(diff.max()) <= BF16_STEP * float(np.abs(want).max())


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "mamba2-370m"])
def test_init_params_bf16_is_f32_rounded(name):
    cfg = get_config(name).reduced()
    f32 = T.init_params(cfg, seed=3, device="cpu")
    bf16 = T.init_params(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    islands = bf16.f32_param_names()
    assert islands and islands == f32.f32_param_names()
    want = dict(f32.named_parameters())
    for key, p in bf16.named_parameters():
        w = want[key].detach()
        if key in islands:
            assert p.dtype == torch.float32, key
        else:
            assert p.dtype == torch.bfloat16, key
            w = w.to(torch.bfloat16)
        np.testing.assert_array_equal(_bits(p.detach()), _bits(w),
                                      err_msg=key)
    # Module.to would round the islands too; to_dtype back to f32 is the
    # f32 model rounded
    back = dict(bf16.to_dtype(torch.float32).named_parameters())
    assert all(p.dtype == torch.float32 for p in back.values())


def test_init_params_bf16_serves_and_trains_every_config():
    """Fault (b): every config built by ``init_params(dtype=bf16)`` runs a
    prefill, a decode step and a train step; the MoE configs raised in
    all three before their routers stayed f32."""
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import adamw_init

    for name in ARCHS:
        cfg = get_config(name).reduced(**(
            {"num_layers": ONE_UNIT[name]} if name in ONE_UNIT else {}))
        model = T.init_params(cfg, seed=0, device="cpu",
                              dtype=torch.bfloat16)
        batch = make_batch(cfg, 2, 8, 0, "cpu")
        tokens = batch["tokens"][..., :-1]
        emb = batch.get("embeds")
        logits, caches = model.prefill(tokens, buf_len=tokens.shape[-1] + 1
                                       + (cfg.vlm_num_patches
                                          if cfg.mrope else 0), embeds=emb)
        step_tok = torch.argmax(logits[:, 0], dim=-1)[..., None]
        pos = tokens.shape[-1] + (cfg.vlm_num_patches if cfg.mrope else 0)
        logits2, _ = model.decode_step(step_tok, caches, pos)
        opt = AdamWConfig(lr=1e-2)
        state = adamw_init(dict(model.named_parameters()), opt)
        m = make_train_step(cfg, opt)(model, state, batch)
        assert logits.dtype == logits2.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(logits2.float()).all()), name
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        islands = model.f32_param_names()
        for key, p in model.named_parameters():
            assert p.dtype == (torch.float32 if key in islands
                               else torch.bfloat16), (name, key)
            assert state["m"][key].dtype == torch.float32, (name, key)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "gemma3-4b", "zamba2-7b"])
def test_kv_quant_packs_bf16_caches_to_reference_words(name, bits):
    """The reference's bf16 prefill caches packed by both packers: the
    words bit for bit, and the unpacked bf16 caches bit for bit (k/v,
    MLA's latent and k_rope, the local:global and hybrid stacks)."""
    case = _case(name)
    caches = case.jax_prefill(jnp.bfloat16)[1]
    jq, jmeta = jax_kvq.quantize_caches(caches, bits)
    jd = jax_kvq.dequantize_caches(jq, jmeta)
    port = _torch_tree(jax.tree_util.tree_map(np.asarray, caches))
    pq, pmeta = kv_quant.quantize_caches(port, bits)
    pd = kv_quant.dequantize_caches(pq, pmeta)
    packed = 0
    for (key, want), (_, got) in zip(_leaves(jq), _leaves(pq)):
        assert _dtype_name(got) == str(want.dtype), key
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)
        packed += want.dtype == jnp.int32
    assert bool(packed) == (case.cfg.family != "ssm")
    for (key, want), (_, got) in zip(_leaves(jd), _leaves(pd)):
        assert _dtype_name(got) == str(want.dtype), key
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)


# The card's bf16 gate (``chip_smoke.lm_bf16``) holds each model's bf16
# last-token logits against its f32 ones within ``chip_smoke.BF16_TOL``,
# set per model from the reference's own bf16-vs-f32 gap at that model's
# full width, read here: mamba2-370m at its full 48 layers (the card's
# depth), limit 1.5 (``PREFILL_VS_F32``) times the reading; llama3-8b at
# 2 of its 32 layers (its full width holds 1.05 B embedding parameters,
# and more depth does not fit a test's memory), limit 2 (``BF16_GAPS``)
# times the reading, for the depth the card adds. Measured: the
# reference's gap 1.63e-2, 7.00e-2 and 0.688 at 2, 8 and 48 mamba2 layers
# (the port's 1.52e-2, 4.11e-2 and 0.522); 1.60e-2 (1 × 128 tokens) at
# llama3-8b's width. f32 against f32 is held at 2e-4 (the f32 tolerance of
# ``tests/test_torch_archs.py``) up to 8 layers and at 1e-3 at 48, where
# the two frameworks' f32 roundings have compounded (measured 2.97e-4;
# the card's 48-layer f32 check against the CPU, ``chip_smoke``'s LM
# check, allows 5e-3).
CARD_FACTOR = {"mamba2-370m": PREFILL_VS_F32, "llama3-8b": BF16_GAPS}


def _smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _full_width_gaps(name, layers, shape):
    """``name`` at its full width and ``layers`` layers, one prefill of
    seeded tokens of ``shape`` through the reference and the port, in f32
    and bf16 (one reference tree per dtype, the port's carried from it);
    the last-token logits of each, one dtype at a time to bound memory."""
    import dataclasses
    import gc

    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    jcfg = dataclasses.replace(jax_get_config(name), num_layers=layers)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, shape,
                                               dtype=np.int32)
    ref, port = {}, {}
    for dt in (jnp.float32, jnp.bfloat16):
        params = jax_T.init_params(jax.random.PRNGKey(0), jcfg, dtype=dt)
        ref[dt] = _f32(JaxEngine(jcfg, params)._prefill(
            params, jnp.asarray(tokens), buf_len=shape[1], embeds=None)[0])
        model = T.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, device="cpu")
        del params
        with torch.no_grad():
            port[dt] = _f32(model.prefill(torch.from_numpy(tokens).long())[0])
        del model
        gc.collect()
    return ref, port


def _check_gaps(ref, port, f32_tol):
    """The port's bf16 gap within ``PREFILL_VS_F32`` × the reference's
    own, the f32 runs within ``f32_tol``; returns the reference's gap."""
    f32, bf16 = jnp.float32, jnp.bfloat16
    own = _gap(ref[bf16], ref[f32], ref[f32])
    got = _gap(port[bf16], port[f32], ref[f32])
    assert got <= PREFILL_VS_F32 * own, (got, own)
    assert _gap(port[f32], ref[f32], ref[f32]) <= f32_tol
    return own


@pytest.mark.parametrize("layers", [2, 8, 48])
def test_mamba2_full_width_bf16_gap_tracks_the_reference(layers):
    """mamba2-370m at its full width (d_model 1,024, vocab 50,280) and 2, 8
    and 48 layers, 1 × 512 tokens: the port's bf16 prefill logits lie from
    its f32 ones (the same reference tree, in both dtypes) no farther than
    1.5 times the reference's own bf16-vs-f32 gap, and the two f32 runs
    agree. The reference's gap grows with depth, to 0.688 of the largest
    logit at 48: random-weight mamba2 drifts that far in bf16 in either
    framework. At 48 layers the card's limit for mamba2-370m is no looser
    than ``CARD_FACTOR`` times the reference's reading."""
    ref, port = _full_width_gaps("mamba2-370m", layers, (1, 512))
    own = _check_gaps(ref, port, 2e-4 if layers <= 8 else 1e-3)
    if layers == 48:
        tol = _smoke().BF16_TOL["mamba2-370m"]
        assert tol <= CARD_FACTOR["mamba2-370m"] * own, (tol, own)


def test_llama3_full_width_bf16_gap_sets_the_card_limit():
    """llama3-8b at its full width (d_model 4,096, 32 query and 8 kv heads,
    d_ff 14,336, vocab 128,256) and 2 layers, 1 × 128 tokens: the port's
    bf16 prefill logits lie from its f32 ones no farther than 1.5 times the
    reference's own gap, the f32 runs agree, and the card's limit for
    llama3-8b is no looser than ``CARD_FACTOR`` times the reference's
    reading (about 10.5 GB at its peak: one dtype's trees at a time)."""
    ref, port = _full_width_gaps("llama3-8b", 2, (1, 128))
    own = _check_gaps(ref, port, 2e-4)
    tol = _smoke().BF16_TOL["llama3-8b"]
    assert tol <= CARD_FACTOR["llama3-8b"] * own, (tol, own)


# One make_train_step step from the reference's bf16 tree, at lr 1e-2 (a
# step a bf16 weight can show: at lr 3e-4 most weights of these widths
# would round back to themselves). Tolerances: loss and grad norm within
# 5e-3 relative (bf16 forward and backward in each framework's rounding;
# measured 5.4e-6-8.9e-4); an updated weight within 2·lr of the
# reference's, plus one bf16 step of each side's magnitude for the two
# roundings (Adam's first step moves an element by ±lr, and a gradient
# that is zero up to rounding may take either sign), and at least
# TRAIN_EQUAL of them bit for bit (measured 0.987-0.990).
TRAIN_LR = 1e-2
TRAIN_REL = 5e-3
TRAIN_EQUAL = 0.95


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-370m"])
def test_train_step_bf16_matches_reference(name, state_dtype):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    params = jax.tree_util.tree_map(np.asarray, jax_T.init_params(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17),
                                               dtype=np.int32)
    jopt = JaxAdamWConfig(lr=TRAIN_LR, state_dtype=getattr(jnp, state_dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jnew, jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt))(
        jparams, jax_adamw_init(jparams, jopt), {"tokens": tokens})
    model = T.from_jax_params(params, cfg, device="cpu")
    opt = AdamWConfig(lr=TRAIN_LR, state_dtype=getattr(torch, state_dtype))
    from repro_torch.optim import adamw_init
    state = adamw_init(dict(model.named_parameters()), opt)
    m = make_train_step(cfg, opt)(model, state,
                                  {"tokens": torch.from_numpy(tokens).long()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=TRAIN_REL, err_msg=key)
    want = T._state_from_jax(jax.tree_util.tree_map(np.asarray, jnew), cfg)
    islands = model.f32_param_names()
    equal = total = 0
    for key, p in model.named_parameters():
        w = want[key]
        assert p.dtype == w.dtype == (torch.float32 if key in islands
                                      else torch.bfloat16), key
        assert state["m"][key].dtype == getattr(torch, state_dtype), key
        diff = (p.detach().float() - w.float()).abs()
        limit = 2 * TRAIN_LR + BF16_STEP * (w.float().abs()
                                            + p.detach().float().abs())
        assert bool((diff <= limit).all()), (key, float(diff.max()))
        equal += int((diff == 0).sum())
        total += diff.numel()
    assert equal >= TRAIN_EQUAL * total, equal / total
