"""``examples/serverless_search_torch.py`` (the torch twin of
``examples/serverless_search.py``) on the CPU at a tiny scale, held against
the JAX package: the same dataset from the same seed through the
reference's ``ServerlessRuntime.search`` at the example's F and l_max gives
the twin's cold and warm ids and ``SearchStats`` in float64. The twin's
process-transport pass (one spawned worker per partition) is left out here;
``tests/test_torch_transport.py`` holds that transport. Without
``--device`` the twin needs the card."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import SquashConfig, SquashIndex  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "serverless_search_torch.py")
SCALE = 0.003                  # 3,000 rows of the 1M preset


def _load():
    spec = importlib.util.spec_from_file_location("serverless_search_torch",
                                                  EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def test_twin_equals_the_reference_runtime_in_f64(capsys):
    ex = _load()
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = ex.main(["--device", "cpu", "--scale", str(SCALE),
                       "--skip-process"])
    finally:
        torch.set_default_dtype(prev)
    out = capsys.readouterr().out
    assert "result cache repeat  = 50/50 hits" in out
    assert "process transport" not in out

    ds = synthetic.make_vector_dataset("sift1m", scale=SCALE,
                                       num_queries=ex.NUM_QUERIES)
    preds = synthetic.default_predicates(ds.attr_cardinality)
    index = SquashIndex.build(ds.vectors, ds.attributes,
                              SquashConfig(num_partitions=10))
    rt = ServerlessRuntime(index, RuntimeConfig(
        branching=ex.N_QA_F, max_level=ex.N_QA_L, warm_prob=0.95))
    for phase in ("cold", "warm"):
        want = rt.search(ds.queries, preds, k=ex.K)
        np.testing.assert_array_equal(got[phase].ids, want.ids)
        assert dataclasses.asdict(got[phase].stats) == \
            dataclasses.asdict(want.stats)
        assert got[phase].trace.invocations("qp") == \
            want.trace.invocations("qp")
    assert got["warm"].trace.dre.s3_gets < got["cold"].trace.dre.s3_gets


def test_twin_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, EXAMPLE, "--scale", str(SCALE)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
