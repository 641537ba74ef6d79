"""CPU tests of the benchmark harness: loading by name, the traffic, the
bounds, the reference, the import rules, the trace reduction, and whole
runs at a tiny size with the timed path broken underneath."""

import ast
import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import bounds, devtrace, gen, harness, load  # noqa: E402

CELL = "osq.clients-q512-sel8"
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def tiny_root(tmp: Path, rows=2000, max_bits=5, dtype="float32") -> Path:
    """A checkout with the benchmark's files, its cell cut to a size
    the CPU runs in seconds."""
    shutil.copytree(HERE, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    cfg_path = tmp / "perfbench/configs/sift1m-osq.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["data"]["rows"] = rows
    cfg["index"]["max_bits_per_dim"] = max_bits
    cfg["dtype"] = dtype
    cfg_path.write_text(json.dumps(cfg))
    tr_path = tmp / "perfbench/traffic/clients-q512-sel8.json"
    tr = json.loads(tr_path.read_text())
    tr.update(clients=2, batch=16, query_pool=128, eval_batches=3,
              eval_range=6)
    tr_path.write_text(json.dumps(tr))
    return tmp


def test_cells_find_their_parts_by_name():
    bench = load.benchmark()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert all(set(n) <= NAME_CHARS and len(n) <= 64 for n in names)
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        cfg = load.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        tr = load.traffic(w["traffic"])
        assert tr["batch"] > 0 and tr["clients"] > 0
        readers = load.per_layer(bench, w["name"])
        assert set(readers) == {m["name"] for m in bench["per_layer"]}
        assert all(callable(r) for r in readers.values())
        assert "setup_s" in {m["name"] for m in load.end_to_end(bench,
                                                                w["name"])}


def _digest(folder: Path):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()
                                                       ).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    root = tiny_root(tmp_path)
    before = _digest(root / "perfbench")
    (root / "perfbench/configs/tiny-extra.json").write_text(
        (root / "perfbench/configs/sift1m-osq.json").read_text().replace(
            '"sift1m-osq"', '"tiny-extra"'))
    tr = json.loads((root / "perfbench/traffic/clients-q512-sel8.json"
                     ).read_text())
    tr["batch"] = 8
    (root / "perfbench/traffic/extra-q8.json").write_text(json.dumps(tr))
    (root / "perfbench/metrics/extra_batches.py").write_text(
        "def read(rec):\n    b = rec.get('batches')\n"
        "    return float(len(b)) if b else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-extra", "source": "a test",
                             "file": "perfbench/configs/tiny-extra.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "extra.q8", "config": "tiny-extra",
                               "traffic": "extra-q8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "extra_batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "qps",
                               "workloads": ["extra.q8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(root / "perfbench")
    assert all(after[f] == h for f, h in before.items())
    assert "extra_batches" in load.per_layer(load.benchmark(root), "extra.q8",
                                             root / "perfbench")
    assert "extra_batches" not in load.per_layer(load.benchmark(root), CELL,
                                                 root / "perfbench")
    res = harness.run("extra.q8", 7, 1.0, True, device="cpu", root=root)
    assert res["correct"], res["check"]
    assert res["metrics"]["extra_batches"]["value"] >= 1


def test_a_traffic_setting_nothing_reads_is_refused(tmp_path):
    root = tiny_root(tmp_path)
    tr = json.loads((root / "perfbench/traffic/clients-q512-sel8.json"
                     ).read_text())
    (root / "perfbench/traffic/open-loop.json").write_text(
        json.dumps({**tr, "loop": "open"}))
    with pytest.raises(ValueError, match="loop"):
        load.traffic("open-loop", root / "perfbench")


def test_stage_bytes_by_hand():
    # Q = 2, P = 3, n_max = 5, G = 1, keep_s = 4: codes 3·5·1·4 = 60 B,
    # mask 2·3·5 = 30 B, survivors 2·3·4·8 = 192 B.
    assert bounds.stage3_bytes(2, 3, 5, 1, 4) == 60 + 30 + 192
    # 7 live slots of d = 2 codes: 7·2·4 = 56 B; boundaries 3·4·2·4 = 96 B;
    # rows 2·3·2·8 = 96 B.
    assert bounds.stage4_bytes(2, 3, 4, 2, 7, 2) == 56 + 96 + 96
    assert bounds.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert bounds.roofline_pct(1.0, 0.0) is None
    cfg = {"hamming_perc": 10.0, "min_hamming_keep": 64, "refine_ratio": 2.0}
    assert bounds.static_slots(26250, cfg, 10) == (2625, 20)
    assert bounds.static_slots(30, cfg, 10) == (30, 20)
    assert bounds.keep_count(0, 10.0, 64) == 0


def test_traffic_is_fixed_by_the_seed():
    tr = {"batch": 4, "predicate_widths": [9, 9, 9, 9]}
    pool = np.arange(40, dtype=np.float32).reshape(10, 4)
    big = 2 ** 31 + 12345
    a = gen.batch_inputs(tr, 16, pool, big, 3)
    b = gen.batch_inputs(tr, 16, pool, big, 3)
    c = gen.batch_inputs(tr, 16, pool, big + 1, 3)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert a[1] != c[1] or a[1] != gen.batch_inputs(tr, 16, pool, big, 4)[1]
    assert np.array_equal(a[0], pool[[2, 3, 4, 5]])
    for _, lo, hi in a[1]:
        assert 0 <= lo and hi <= 15 and hi - lo + 1 == 9
    x = gen.make_vector_dataset(1500, 128, 64, 13, 8, 4, 16, big)
    y = gen.make_vector_dataset(1500, 128, 64, 13, 8, 4, 16, big)
    assert np.array_equal(x.vectors, y.vectors)
    assert np.array_equal(x.attributes, y.attributes)


def test_generator_is_the_programs():
    from repro_torch.data import synthetic

    mine = gen.make_vector_dataset(2000, 128, 64, 13, 16, 4, 16, 99)
    prog = synthetic.make_vector_dataset("sift1m", scale=0.002,
                                         num_queries=16, seed=99)
    assert np.array_equal(mine.vectors, prog.vectors)
    assert np.array_equal(mine.attributes, prog.attributes)
    assert np.array_equal(mine.queries, prog.queries)


def _tiny_cell(dtype="float32", **idx):
    cfg = json.loads((HERE / "configs/sift1m-osq.json").read_text())
    cfg["data"]["rows"] = 1500
    cfg["index"].update({"max_bits_per_dim": 5, **idx})
    cfg["dtype"] = dtype
    tr = json.loads((HERE / "traffic/clients-q512-sel8.json").read_text())
    tr.update(batch=24, query_pool=48)
    return harness.Cell(cfg, tr, 5, "cpu")


def test_reference_is_exact_when_nothing_is_pruned():
    # Every partition visited (huge β), every candidate kept and refined:
    # the reference's answer is the brute-force filtered top-k.
    cell = _tiny_cell(beta=1e6, hamming_perc=100.0, refine_ratio=1e4)
    ref = harness.Reference(cell, "cpu")
    for b in range(3):
        ids, dists, stats = ref.answer(b)
        q, preds, _ = cell.batch(b)
        mask = gen.filter_mask(cell.corpus.attributes, preds)
        rows = np.nonzero(mask)[0]
        x = cell.corpus.vectors[rows].astype(np.float64)
        for qi in range(q.shape[0]):
            d = np.sqrt(((x - q[qi]) ** 2).sum(-1))
            best = np.argsort(d, kind="stable")[:cell.k]
            assert set(ids[qi]) == set(rows[best])
            assert np.allclose(dists[qi], d[best], rtol=1e-9)
        assert stats["partitions_visited"] == q.shape[0] * 10


@pytest.mark.parametrize("max_bits", [8, 12])
def test_reference_equals_the_program_in_float64(max_bits):
    import torch

    cell = _tiny_cell(dtype="float64", max_bits_per_dim=max_bits)
    cell.build()
    ref = harness.Reference(cell, "cpu")
    try:
        answers = {}
        for b in range(3):
            q, _, preds = cell.batch(b)
            ids, dists, stats = cell.index.search(
                q, preds, k=cell.k, backend="torch", device="cpu")
            answers[b] = {"ids": ids, "dists": dists,
                          "stats": stats.__dict__}
        j = ref.judge(answers, [0, 1, 2])
    finally:
        torch.set_default_dtype(torch.float32)
    assert j["stats_gap"] == 0 and j["id_miss"] == 0.0
    assert j["dist_gap"] < 1e-12
    rb = ref.dev.index
    assert np.array_equal(rb.assign, cell.index.partitioning.assign)
    for mine, prog in zip(rb.parts, cell.index.parts):
        assert np.array_equal(mine.codes, prog.codes)
        m1 = prog.quant.boundaries.shape[0]
        assert np.allclose(mine.boundaries[:m1], prog.quant.boundaries,
                           rtol=1e-12, atol=0)


def test_control_fails_the_limits():
    """The TF32 control, judged as the program's answers are, fails a
    limit that the float32 search meets."""
    from perfbench import control

    cfg = json.loads((HERE / "configs/sift1m-osq.json").read_text())
    cell = _tiny_cell()
    ref = harness.Reference(cell, "cpu")
    read = control.readings(cell, ref, "cpu")
    limits = cfg["limits"]
    assert any(read["tf32"][n] > limits[n] for n in harness.COMPARED)
    assert all(read["f32"][n] <= limits[n] for n in ("stats_gap", "id_miss"))


def _break(kind):
    from repro_torch.core import pipeline

    orig = pipeline.SquashIndex._search_torch

    def broken(self, *a, **kw):
        ids, dists, stats = orig(self, *a, **kw)
        ids, dists = ids.copy(), dists.copy()
        if kind == "half":
            h = ids.shape[0] // 2
            ids[h:] = -1
            dists[h:] = np.inf
        elif kind == "altered":
            ids[0, 0] = (ids[0, 0] + 1) % self.attr_index.codes.shape[0]
        return ids, dists, stats

    return pipeline, broken


@pytest.mark.parametrize("fault", ["none", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = tiny_root(tmp_path)
    if fault != "none":
        pipeline, broken = _break(fault)
        monkeypatch.setattr(pipeline.SquashIndex, "_search_torch", broken)
    res = harness.run(CELL, 2 ** 31 + 77, 1.0, False, device="cpu",
                      root=root)
    assert res["correct"] == (fault == "none"), res["check"]
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"qps", "batch_p95_ms", "recall_at_10",
                                   "device_gb", "setup_s"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.relative_to(HERE).parts:
            assert "repro_torch" not in tops, path


def test_trace_summary_attributes_device_time(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.select",
         "tid": 2, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "bench.stage3",
         "tid": 2, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "bench.stage5",
         "tid": 3, "ts": 40, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 2, "ts": 12, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 3, "ts": 45, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 50,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.stage3",
         "ts": 20, "dur": 30},
    ]
    f = tmp_path / "trace.json"
    f.write_text(json.dumps({"traceEvents": ev}))
    s = devtrace.summarize(str(f))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(70e-6)          # 20–50, 60–100
    assert s["stage_device_s"]["stage3"] == pytest.approx(30e-6)
    assert s["stage_device_s"]["stage5"] == pytest.approx(50e-6)
    assert s["breakdown"]["device_ops"][0][0] == "k2"
    gaps = dict(s["breakdown"]["idle_gaps"])
    # Each stretch of a gap is labelled by the spans open during it.
    assert gaps == pytest.approx({"bench.select": 10e-6,     # 0–10
                                  "bench.stage3": 10e-6,     # 10–20
                                  "bench.stage5": 10e-6})    # 50–60


def test_readers_return_nothing_without_a_trace():
    for name in ("stage3_roofline_pct", "stage4_roofline_pct",
                 "stage5_merge_ms", "device_idle_pct", "batch_added_gb"):
        assert load.reader(name)({"batches": [], "shape": {}}) is None
