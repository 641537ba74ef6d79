"""The port's checkpoints, on the CPU.

* a round trip of a model's ``state_dict`` and its AdamW state (float32
  and bfloat16 moments) is bitwise, on the template's device and dtype;
* a train step after a save and restore equals the uninterrupted step
  (loss and every parameter, bitwise: the same CPU arithmetic);
* the format is the reference's: a checkpoint that
  ``repro.checkpoint.save_pytree`` wrote from JAX parameters loads into
  the port through ``restore_pytree`` + ``from_jax_params``, and the port
  writes the same keys in the same order for the same tree;
* a template that does not match the checkpoint is refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint import save_pytree as jax_save_pytree  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402

from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               cosine_schedule)
from repro_torch.train import make_train_step  # noqa: E402

ARCH = "mamba2-370m"


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _trained(state_dtype=torch.float32, steps=1):
    cfg = get_config(ARCH).reduced()
    model = T.init_params(cfg, seed=0, device="cpu")
    opt = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    state = adamw_init(dict(model.named_parameters()), opt)
    step = make_train_step(cfg, opt, cosine_schedule(1e-3, 1, 4))
    for i in range(steps):
        step(model, state, make_batch(cfg, 2, 16, i, "cpu"))
    return cfg, model, state, step


def _fresh(cfg, state_dtype=torch.float32):
    model = T.init_params(cfg, seed=1, device="cpu")
    return model, adamw_init(dict(model.named_parameters()),
                             AdamWConfig(state_dtype=state_dtype))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_bitwise(tmp_path, state_dtype):
    cfg, model, state, _ = _trained(state_dtype)
    tree = {"params": model.state_dict(), "opt": state}
    save_pytree(tree, str(tmp_path), name=cfg.name)
    model2, state2 = _fresh(cfg, state_dtype)
    out = restore_pytree({"params": model2.state_dict(), "opt": state2},
                         str(tmp_path), name=cfg.name)
    got, want = dict(_leaves(out)), dict(_leaves(tree))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].device == w.device
        assert torch.equal(got[key], w), key
    assert int(out["opt"]["step"]) == 1


def test_step_after_restore_equals_uninterrupted_step(tmp_path):
    cfg, model, state, step = _trained(steps=2)
    save_pytree({"params": model.state_dict(), "opt": state}, str(tmp_path))
    model2, state2 = _fresh(cfg)
    out = restore_pytree({"params": model2.state_dict(), "opt": state2},
                         str(tmp_path))
    model2.load_state_dict(out["params"])
    batch = make_batch(cfg, 2, 16, 2, "cpu")
    m_live = step(model, state, batch)
    m_back = step(model2, out["opt"], batch)
    assert float(m_live["loss"]) == float(m_back["loss"])
    assert float(m_live["grad_norm"]) == float(m_back["grad_norm"])
    for (name, p), q in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, q), name


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """``repro.checkpoint.save_pytree`` of reference parameters →
    ``restore_pytree`` (no template) → ``from_jax_params``; and the port
    writes the same keys for the same tree."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jax.tree_util.tree_map(
        np.asarray, jax_T.init_params(jax.random.PRNGKey(0), jcfg))
    jax_save_pytree(params, str(tmp_path / "jax"))
    tree = restore_pytree(None, str(tmp_path / "jax"))
    cfg = get_config(ARCH).reduced()
    got = T.from_jax_params(tree, cfg, device="cpu").state_dict()
    want = T.from_jax_params(params, cfg, device="cpu").state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    save_pytree(params, str(tmp_path / "port"))
    manifests = [json.load(open(tmp_path / d / "ckpt.json"))["order"]
                 for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    with np.load(tmp_path / "jax" / "ckpt.npz") as a, \
            np.load(tmp_path / "port" / "ckpt.npz") as b:
        for key in manifests[0]:
            np.testing.assert_array_equal(a[key], b[key])


def test_mismatched_template_is_refused(tmp_path):
    cfg, model, state, _ = _trained()
    save_pytree({"params": model.state_dict(), "opt": state}, str(tmp_path))
    with pytest.raises(ValueError, match="do not match"):
        restore_pytree({"params": model.state_dict()}, str(tmp_path))
    bad = {"params": dict(model.state_dict()), "opt": state}
    bad["params"]["final_norm.scale"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(bad, str(tmp_path))
