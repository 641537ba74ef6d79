"""``examples/rag_serving_torch.py`` (the torch twin of
``examples/rag_serving.py``) runs on the CPU at the example's reduced size:
it embeds, indexes, retrieves through ``search(backend="torch")`` and
generates with the float and the 8-bit KV cache, whose tokens agree on at
least 75 % (the example asserts it); without ``--device`` it needs the
card. The retrieval is held against the NumPy backend in-process."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "rag_serving_torch.py")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, EXAMPLE, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_example_serves_on_cpu():
    out = _run("--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "on cpu" in out.stdout
    assert "generated (4, 24) tokens" in out.stdout
    agree = [line for line in out.stdout.splitlines()
             if "token agreement" in line]
    assert len(agree) == 1 and "4.0x smaller" in agree[0]


def test_example_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    out = _run()
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_example_retrieval_equals_the_numpy_backend():
    """The example's own embed, index and queries at a small size: the
    torch backend's float64 ids and stats equal the NumPy backend's."""
    spec = importlib.util.spec_from_file_location("rag_serving_torch",
                                                  EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("phi4-mini-3.8b").reduced(vocab_size=1024, d_model=128,
                                               num_layers=2)
    model = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab_size, (256, ex.DOC_LEN), dtype=np.int32)
    embs = ex.embed_documents(model, torch.from_numpy(docs), batch=100)
    assert embs.shape == (256, 128) and np.isfinite(embs).all()
    index = ex.build(embs, rng)
    queries = ex.queries_for(embs, rng).astype(np.float64)
    want = index.search(queries, ex.PREDICATES, k=ex.K, backend="numpy")
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = index.search(queries, ex.PREDICATES, k=ex.K, backend="torch",
                           device="cpu")
    finally:
        torch.set_default_dtype(prev)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]
    prompts = ex.prompts_for(docs, got[0])
    assert prompts.shape == (ex.N_QUERIES, 16)
