"""The PyTorch port stands alone: no jax, nothing of the JAX package.

* ``repro_torch`` and every submodule import in a subprocess where ``jax``
  and ``repro`` cannot be imported;
* no module of the port, nor ``chip_smoke.py`` or
  ``tools/kernel_variants.py``, names ``jax`` or ``repro`` in an import
  statement;
* entry points default to the card: without CUDA the torch search
  backend, the serverless runtime and the service's serverless route, the
  LM ``Engine``, the model constructors (``init_params``,
  ``from_jax_params``, ``from_jax_opt_state``), ``python -m
  repro_torch.launch.serve`` and ``python -m repro_torch.launch.train`` raise (naming
  ``device="cpu"``) instead of running on the CPU, a QP worker bound to the
  card raises instead of moving to the CPU, a process pool or socket fleet
  of CUDA workers refuses ``fork``, and the kernel wrappers refuse CPU
  tensors.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pipeline, segments  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import adc_lookup, bitpack, build, hamming, ops, ref, ssd  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import Engine, ServiceConfig, VectorSearchService  # noqa: E402
from repro_torch.serverless import RuntimeConfig, ServerlessRuntime  # noqa: E402
from repro_torch.serverless import transport as tp  # noqa: E402
from repro_torch.serverless.socket_transport import SocketTransport  # noqa: E402
from repro_torch.serverless import workers as wk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    for dirpath, dirnames, files in os.walk(PORT):
        dirnames.sort()
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "kernel_variants.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_without_jax_or_reference_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 61      # every module of all slices


# The modules of the live index and the serverless runtime, at the
# reference's paths.
SLICE5_MODULES = [
    "core/live.py", "core/invocation.py", "core/cost_model.py", "core/dre.py",
    "obs/__init__.py", "obs/metrics.py", "obs/spans.py", "obs/export.py",
    "obs/slo.py", "serverless/__init__.py", "serverless/events.py",
    "serverless/payload.py", "serverless/traces.py", "serverless/nodes.py",
    "serverless/workers.py", "serverless/transport.py",
    "serverless/runtime.py"]


# The modules of the socket transport, the mesh path, the obs command-line
# views and the HNSW baseline, at the reference's paths.
SLICE6_MODULES = [
    "serverless/socket_transport.py", "serverless/host.py",
    "core/distributed.py", "core/hnsw.py", "obs/timeline.py", "obs/top.py"]


def _stands_beside_its_reference(rel):
    assert os.path.isfile(os.path.join(PORT, rel))
    assert os.path.isfile(os.path.join(REPO, "src", "repro", rel))
    roots = set(_imported_roots(os.path.join(PORT, rel)))
    assert "jax" not in roots and "repro" not in roots, roots


# The modules of training, at the reference's paths.
SLICE8_MODULES = [
    "optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
    "train/__init__.py", "train/steps.py", "checkpoint/__init__.py",
    "checkpoint/store.py", "launch/train.py"]


@pytest.mark.parametrize("rel", SLICE5_MODULES)
def test_slice5_module_stands_beside_its_reference(rel):
    _stands_beside_its_reference(rel)


@pytest.mark.parametrize("rel", SLICE6_MODULES)
def test_slice6_module_stands_beside_its_reference(rel):
    _stands_beside_its_reference(rel)


@pytest.mark.parametrize("rel", SLICE8_MODULES)
def test_slice8_module_stands_beside_its_reference(rel):
    _stands_beside_its_reference(rel)


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_reference_package(path):
    roots = set(_imported_roots(path))
    assert "jax" not in roots and "repro" not in roots, roots


def test_torch_backend_defaults_to_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.resolve_device(None)
    assert pipeline.resolve_device("cpu") == torch.device("cpu")


def test_search_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(600, 16))
    attrs = rng.integers(0, 4, size=(600, 2)).astype(np.float64)
    index = pipeline.SquashIndex.build(
        vecs, attrs, pipeline.SquashConfig(num_partitions=2, kmeans_iters=2,
                                           lloyd_iters=2, max_bits_per_dim=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index.search(vecs[:2], [], k=3, backend="torch")
    ids, _, _ = index.search(vecs[:2], [], k=3, backend="torch", device="cpu")
    assert ids.shape == (2, 3)
    with pytest.raises(ValueError, match="unknown backend"):
        index.search(vecs[:2], [], k=3, backend="jax")


def _tiny_index():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(600, 16))
    attrs = rng.integers(0, 4, size=(600, 2)).astype(np.float64)
    return pipeline.SquashIndex.build(
        vecs, attrs, pipeline.SquashConfig(num_partitions=2, kmeans_iters=2,
                                           lloyd_iters=2, max_bits_per_dim=4))


def test_serverless_runtime_defaults_to_card_and_raises_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = _tiny_index()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerlessRuntime(index)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerlessRuntime(index, RuntimeConfig(transport="process"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerlessRuntime(index, RuntimeConfig(transport="socket"))
    rt = ServerlessRuntime(index, RuntimeConfig(device="cpu"))
    assert rt.device == torch.device("cpu")
    assert rt.search(np.zeros((2, 16)), [], k=3).ids.shape == (2, 3)


def test_service_serverless_route_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = _tiny_index()
    svc = VectorSearchService(index, ServiceConfig(backend="serverless"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svc.query(np.zeros((2, 16)), [], k=3)
    assert svc.requests == 0
    svc = VectorSearchService(index, ServiceConfig(backend="serverless",
                                                   device="cpu"))
    assert svc.query(np.zeros((2, 16)), [], k=3)[0].shape == (2, 3)
    assert svc.runtime().device == torch.device("cpu")


def test_cuda_workers_refuse_fork_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = _tiny_index()
    init = wk.WorkerInit(role="qp", fn="qp:0", pid=0, dtype="float32",
                         device="cuda",
                         bundle=wk.build_qp_bundle(index, 0, torch.float32))
    with pytest.raises(ValueError, match="fork"):
        tp.ProcessTransport({"qp:0": (init, 1)}, start_method="fork")
    with pytest.raises(ValueError, match="fork"):
        SocketTransport({"qp:0": (init, 1)}, start_method="fork")
    prev = torch.get_default_dtype()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wk.configure_torch(init)
        wk.configure_torch(dataclasses.replace(init, dtype="float64",
                                               device="cpu"))
        assert torch.get_default_dtype() == torch.float64
    finally:
        torch.set_default_dtype(prev)


def test_engine_defaults_to_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-370m").reduced(num_layers=1)
    model = transformer.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model)
    assert Engine(cfg, model, device="cpu").device == torch.device("cpu")


def test_model_constructors_default_to_card_and_raise_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-370m").reduced(num_layers=1)
    tree = {k: v.numpy() for k, v in
            transformer.init_params(cfg, device="cpu").state_dict().items()}
    nested = {"embed": {"table": tree["embed.table"]}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.from_jax_params(nested, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.from_jax_opt_state({"step": 0, "m": nested,
                                        "v": nested}, cfg)


def test_launch_train_defaults_to_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "mamba2-370m", "--reduced"])


def test_launch_serve_defaults_to_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "mamba2-370m", "--reduced"])


@pytest.mark.parametrize("call", ["hamming", "adc_batch", "adc_table",
                                  "adc_direct", "ssd_intra", "ssd_intra_grad",
                                  "extract_codes"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: no quiet CPU fallback."""
    words = torch.zeros((1, 1, 4), dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if call == "hamming":
            hamming.hamming_stacked(words, words)
        elif call == "adc_batch":
            adc_lookup.adc_batch(torch.zeros((1, 3, 4)),
                                 torch.zeros((1, 2, 4), dtype=torch.int32))
        elif call == "adc_table":
            adc_lookup.adc_table(torch.zeros((1, 1, 3, 4)),
                                 torch.zeros((1, 2, 4), dtype=torch.int32),
                                 torch.zeros((1, 1, 2), dtype=torch.int64),
                                 torch.ones((1, 1), dtype=torch.int32))
        elif call == "ssd_intra":
            ssd.ssd_intra(torch.zeros((1, 8, 4)), torch.zeros((1, 8, 4)),
                          torch.zeros((1, 2, 8)), torch.zeros((1, 2, 8, 4)))
        elif call == "ssd_intra_grad":
            ssd.ssd_intra_autograd(
                torch.zeros((1, 8, 4), requires_grad=True),
                torch.zeros((1, 8, 4)), torch.zeros((1, 2, 8)),
                torch.zeros((1, 2, 8, 4)))
        elif call == "extract_codes":
            bitpack.extract_codes(torch.zeros((3, 2), dtype=torch.uint8),
                                  segments.build_layout([4, 4, 8]))
        else:
            adc_lookup.adc_direct(
                torch.zeros((1, 1, 4)), torch.zeros((1, 1, 4), dtype=torch.int32),
                torch.zeros((1, 3, 4)), torch.zeros((1, 2, 4), dtype=torch.int32),
                torch.zeros((1, 1, 2), dtype=torch.int64),
                torch.ones((1, 1), dtype=torch.int32))
    assert ops.launch_counts() == before


def _op_args(name):
    words = torch.zeros((1, 1, 4), dtype=torch.int32)
    codes = torch.zeros((1, 2, 4), dtype=torch.int32)
    return {
        "hamming_distances": (words[0, 0], words[0]),
        "hamming_stacked": (words, words),
        "adc_distances": (torch.ones((3, 4)), codes[0]),
        "adc_batch": (torch.ones((1, 3, 4)), codes),
        "adc_table": (torch.ones((1, 1, 3, 4)), codes,
                      torch.zeros((1, 1, 2), dtype=torch.int64),
                      torch.ones((1, 1), dtype=torch.int32)),
        "adc_direct": (torch.zeros((1, 1, 4)),
                       torch.zeros((1, 1, 4), dtype=torch.int32),
                       torch.zeros((1, 3, 4)), codes,
                       torch.zeros((1, 1, 2), dtype=torch.int64),
                       torch.ones((1, 1), dtype=torch.int32)),
        "extract_codes": (torch.zeros((3, 2), dtype=torch.uint8),
                          segments.build_layout([4, 4, 8])),
        "ssd_intra": (torch.ones((1, 8, 4)), torch.ones((1, 8, 4)),
                      torch.zeros((1, 2, 8)), torch.zeros((1, 2, 8, 4))),
    }[name]


# What each op gives on _op_args: zero words and codes in the query's own
# cell give 0, tables of ones over d=4 give sqrt(4), the direct Stage 4's
# second slot lies past keep = 1 (+inf), as the table Stage 4's does, and
# zero scores give 0.
_EXPECTED = {"adc_distances": 2.0, "adc_batch": 2.0,
             "adc_table": torch.tensor([[[2.0, float("inf")]]]),
             "adc_direct": torch.tensor([[[0.0, float("inf")]]])}


@pytest.mark.parametrize("name,plain", [
    ("hamming_distances", "hamming_ref"),
    ("hamming_stacked", "hamming_stacked_ref"),
    ("adc_distances", "adc_lb_ref"),
    ("adc_batch", "adc_lb_batch_ref"),
    ("adc_table", "adc_table_ref"),
    ("adc_direct", "adc_direct_ref"),
    ("extract_codes", "extract_ref"),
    ("ssd_intra", "ssd_intra_ref")])
def test_ops_route_cpu_tensors_to_the_plain_version(name, plain):
    """The ops take no override: a CPU tensor goes to the plain version and
    launches nothing."""
    args = _op_args(name)
    before = ops.launch_counts()
    got = getattr(ops, name)(*args)
    assert torch.equal(got, getattr(ref, plain)(*args))
    assert torch.all(got == _EXPECTED.get(name, 0))
    assert ops.launch_counts() == before
    with pytest.raises(TypeError):
        getattr(ops, name)(*args, use_kernel=True)


def test_kernel_build_lands_in_the_checkout():
    assert build.build_dir() == Path(REPO) / "build" / "repro_torch"
    for src in build.SOURCES.values():
        assert (build._CSRC / src).is_file()


def test_library_builds_once_for_racing_threads(monkeypatch, tmp_path):
    """Threads that reach an unbuilt library at once (the compute threads of
    one socket host) run one build between them and load one library."""
    import threading
    import time

    target = tmp_path / "libfake.so"
    builds, loads = [], []

    def fake_build_all(names):
        builds.append(list(names))
        time.sleep(0.05)                    # widen the race window
        target.write_bytes(b"")
        return {n: 0.0 for n in names}

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_target", lambda name: target)
    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(16)
        got = []

        def worker():
            barrier.wait()
            got.append(build.library("hamming"))

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert builds == [["hamming"]] and len(loads) == 1
    assert len(got) == 16 and all(lib is got[0] for lib in got)
