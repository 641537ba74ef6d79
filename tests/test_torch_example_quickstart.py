"""``examples/quickstart_torch.py`` (the torch twin of
``examples/quickstart.py``) on the CPU at a tiny scale, held against the
JAX package: the same dataset from the same seed through the reference's
``SquashIndex.search`` gives the twin's ids and ``SearchStats`` in float64,
for both of the example's predicate sets. Without ``--device`` the twin
needs the card."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.attributes import Predicate  # noqa: E402
from repro.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro.data import synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "quickstart_torch.py")
SCALE = 0.003                  # 3,000 rows of the 1M preset


def _load():
    spec = importlib.util.spec_from_file_location("quickstart_torch", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def test_twin_equals_the_reference_in_f64(capsys):
    ex = _load()
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = ex.main(["--device", "cpu", "--scale", str(SCALE)])
    finally:
        torch.set_default_dtype(prev)
    assert "recall@10" in capsys.readouterr().out

    ds = synthetic.make_vector_dataset("sift1m", scale=SCALE,
                                       num_queries=ex.NUM_QUERIES)
    index = SquashIndex.build(ds.vectors, ds.attributes,
                              SquashConfig(num_partitions=10))
    hybrid = [Predicate(**dataclasses.asdict(p)) for p in ex.PREDICATES]
    for name, preds in (("hybrid", hybrid),
                        ("paper", synthetic.default_predicates(
                            ds.attr_cardinality))):
        ids, _, stats = index.search(ds.queries, preds, k=ex.K)
        got_ids, got_stats = got[name]
        np.testing.assert_array_equal(got_ids, ids)
        assert dataclasses.asdict(got_stats) == dataclasses.asdict(stats)
        assert (ids >= 0).any()


def test_twin_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, EXAMPLE, "--scale", str(SCALE)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
