"""The port's squashlint (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

* Every shared-rule case of the reference's own tests (locks, order cycles,
  wallclock, unseeded RNG, set iteration, wire, pragmas, parse errors, the
  baseline ratchet) runs through both analyzers on the same snippet and
  path: equal ``(rule, path, line)`` lists, and the expected rules.
* Both whole trees, ``src/repro`` and ``src/repro_torch``, read with every
  ``# squash: ignore[...]`` pragma stripped, give both analyzers equal
  shared-rule findings, and each finding lies on a line that carried a
  pragma for its rule.
* The port's own rules: ``device-sync`` and ``compile-per-call`` (which
  take the place of the reference's jit rules) and torch's default
  generator under ``unseeded-rng``, true and false positives.
* ``main(["--strict"])`` exits 0 on the port; ``--update-baseline``
  round-trips against a baseline in ``tmp_path`` only.
"""

import io
import json
import os
import re
import subprocess
import sys
import textwrap
import tokenize

import pytest

from repro import analysis as ref_analysis
from repro.analysis import locks as ref_locks
from repro.analysis import runner as ref_runner
from repro.analysis.findings import Finding as RefFinding
from repro_torch import analysis as port_analysis
from repro_torch.analysis import locks as port_locks
from repro_torch.analysis import runner as port_runner
from repro_torch.analysis import sync
from repro_torch.analysis.findings import RULES as PORT_RULES
from repro_torch.analysis.findings import Finding as PortFinding
from repro_torch.analysis.source import parse_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {"repro": os.path.join(REPO, "src", "repro"),
         "repro_torch": os.path.join(REPO, "src", "repro_torch")}

SHARED_RULES = {
    "lock-guarded-access", "lock-order", "wallclock", "unseeded-rng",
    "set-iteration", "wire-pickle", "wire-raw-socket", "bad-pragma",
    "parse-error"}

ANALYZERS = {
    "reference": (ref_runner, ref_locks, RefFinding),
    "port": (port_runner, port_locks, PortFinding),
}


def _triples(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


def _analyze(name, text, rel):
    runner, locks, _ = ANALYZERS[name]
    findings, edges = runner.analyze_source(rel, textwrap.dedent(text))
    return findings + locks.order_cycles(edges)


# ------------------------------------------------------ shared-rule cases

LOCKED_CLASS = """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def bump(self):
            {body}
"""

LOCK_ORDER = """
    import threading

    class A:
        def __init__(self):
            self._lock = threading.Lock()
            self.send_lock = threading.Lock()

        def one(self):
            with self._lock:
                with self.send_lock:
                    pass

        def two(self):
            with {first}:
                with {second}:
                    pass
"""

STAMP = """
    import time

    def stamp():
        return time.perf_counter(){pragma}
"""

# (id, snippet, repo-relative path, the rules both analyzers must give)
SHARED_CASES = [
    ("lock-guarded-access", LOCKED_CLASS.format(body="self.count += 1"),
     "serverless/somefile.py", ["lock-guarded-access"]),
    ("lock-clean-under-with", LOCKED_CLASS.format(
        body="with self._lock:\n                self.count += 1"),
     "serverless/somefile.py", []),
    ("lock-constructor-exempt", LOCKED_CLASS.format(body="pass"),
     "serverless/somefile.py", []),
    ("lock-holds-contract", """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def _bump_locked(self, a_very_long_parameter_name,
                         another_one):  # squash: holds[_lock]
            self.count += 1
    """, "serverless/somefile.py", []),
    ("lock-nested-def", """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0  # guarded-by: _lock

        def go(self):
            with self._lock:
                def worker():
                    self.count += 1
                return worker
    """, "serverless/somefile.py", ["lock-guarded-access"]),
    ("lock-order-cycle", LOCK_ORDER.format(first="self.send_lock",
                                           second="self._lock"),
     "serverless/a.py", ["lock-order", "lock-order"]),
    ("lock-order-consistent", LOCK_ORDER.format(first="self._lock",
                                                second="self.send_lock"),
     "serverless/a.py", []),
    ("wallclock-in-scope", STAMP.format(pragma=""), "core/util.py",
     ["wallclock"]),
    ("wallclock-out-of-scope", STAMP.format(pragma=""),
     "serverless/transport.py", []),
    ("unseeded-rng-numpy", """
    import numpy as np

    def noise(n):
        return np.random.rand(n)
    """, "core/x.py", ["unseeded-rng"]),
    ("seeded-rng-numpy", """
    import numpy as np

    def noise(n, seed):
        return np.random.default_rng(seed).random(n)
    """, "core/x.py", []),
    ("unseeded-rng-stdlib", """
    import random

    def pick(xs):
        return random.choice(xs)
    """, "kernels/x.py", ["unseeded-rng"]),
    ("set-iteration", """
    def order(items):
        return [x for x in set(items)]
    """, "core/x.py", ["set-iteration"]),
    ("set-iteration-sorted", """
    def order(items):
        return [x for x in sorted(set(items))]
    """, "core/x.py", []),
    ("set-iteration-for-and-list", """
    def order(a, b):
        for x in {1, 2}:
            pass
        return list(set(a) | b)
    """, "serverless/nodes.py", ["set-iteration", "set-iteration"]),
    ("wire-pickle", """
    import pickle

    def ship(obj):
        return pickle.dumps(obj)
    """, "serverless/rogue.py", ["wire-pickle"]),
    ("wire-allowlisted-codec", """
    import pickle

    def ship(sock, obj):
        sock.sendall(pickle.dumps(obj))
    """, "serverless/payload.py", []),
    ("wire-raw-socket", """
    def pump(sock):
        return sock.recv(4096)
    """, "serverless/rogue.py", ["wire-raw-socket"]),
    ("pragma-justified", STAMP.format(
        pragma="  # squash: ignore[wallclock] -- trace timing only"),
     "core/x.py", []),
    ("pragma-unjustified", STAMP.format(
        pragma="  # squash: ignore[wallclock]"), "core/x.py",
     ["bad-pragma"]),
    ("pragma-wrong-rule", STAMP.format(
        pragma="  # squash: ignore[wire-pickle] -- wrong rule"), "core/x.py",
     ["wallclock"]),
    ("parse-error", "def broken(:\n", "core/x.py", ["parse-error"]),
]


@pytest.mark.parametrize("analyzer", sorted(ANALYZERS))
@pytest.mark.parametrize("case", SHARED_CASES, ids=[c[0] for c in SHARED_CASES])
def test_shared_rule_case(case, analyzer):
    _, text, rel, want = case
    got = _analyze(analyzer, text, rel)
    assert sorted(f.rule for f in got) == want
    assert _triples(got) == _triples(_analyze("reference", text, rel))


@pytest.mark.parametrize("analyzer", sorted(ANALYZERS))
def test_baseline_ratchet(analyzer):
    runner, _, finding = ANALYZERS[analyzer]
    f, g = finding("core/x.py", 3, "wallclock", "msg"), \
        finding("core/x.py", 9, "wallclock", "msg")
    covered = runner.Report([f], {f.key: 1})
    assert covered.clean and covered.ratchet_ok and covered.baselined == [f]
    one_new = runner.Report([f, g], {f.key: 1})
    assert not one_new.clean and one_new.new == [g]
    stale = runner.Report([], {"wallclock:core/x.py": 2})
    assert stale.clean and not stale.ratchet_ok
    assert stale.stale == {"wallclock:core/x.py": 2}


@pytest.mark.parametrize("analyzer", sorted(ANALYZERS))
def test_guarded_attrs_extracted_from_annotations(analyzer):
    module = {"reference": "repro.analysis.source",
              "port": "repro_torch.analysis.source"}[analyzer]
    src = __import__(module, fromlist=["parse_source"]).parse_source(
        "x.py", textwrap.dedent("""
        class C:
            def __init__(self):
                self.a = 0  # guarded-by: _lock
                self.b = 0
        """))
    assert src.guarded_attrs() == {"a": {"_lock"}}


# ------------------------------------------------------------ whole trees

_PRAGMA = re.compile(r"#\s*squash:\s*ignore\[([A-Za-z0-9_,\-\s]*)\]")


def _strip_pragmas(text):
    """``text`` with every ``# squash: ignore[...]`` comment taken out;
    returns (text, {line → rules the pragma named})."""
    lines = text.splitlines(keepends=True)
    named = {}
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        m = _PRAGMA.search(tok.string) if tok.type == tokenize.COMMENT \
            else None
        if m is None:
            continue
        row, col = tok.start
        named[row] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = lines[row - 1]
        lines[row - 1] = line[:col].rstrip() + line[len(line.rstrip("\r\n")):]
    return "".join(lines), named


@pytest.fixture(scope="module")
def stripped_trees():
    out = {}
    for tree, root in TREES.items():
        files, named = {}, {}
        for rel, path in sorted(ref_runner._iter_py(root)):
            with open(path, encoding="utf-8") as fh:
                text, lines = _strip_pragmas(fh.read())
            files[rel] = text
            named.update({(rel, ln): rules for ln, rules in lines.items()})
        found = {}
        for name, (runner, locks, _) in ANALYZERS.items():
            findings, edges = [], []
            for rel, text in files.items():
                f, e = runner.analyze_source(rel, text)
                findings.extend(f)
                edges.extend(e)
            findings.extend(locks.order_cycles(edges))
            found[name] = findings
        out[tree] = (found, named)
    return out


@pytest.mark.parametrize("tree", sorted(TREES))
def test_stripped_tree_gives_equal_shared_findings(stripped_trees, tree):
    found, named = stripped_trees[tree]
    ref = [f for f in found["reference"] if f.rule in SHARED_RULES]
    port = [f for f in found["port"] if f.rule in SHARED_RULES]
    assert _triples(port) == _triples(ref)
    # Each finding is one a pragma justified, and every pragma naming a
    # shared rule hides one.
    shared_pragmas = {site for site, rules in named.items()
                      if rules & SHARED_RULES}
    assert {(f.path, f.line) for f in port} == shared_pragmas
    for f in port:
        assert f.rule in named[(f.path, f.line)]
    if tree == "repro_torch":
        assert len(port) == 28


# The port's intended syncs, each justified by a pragma at its line.
INTENDED_SYNCS = [
    ("serve/engine.py", "outs = [tok.cpu()]"),
    ("serve/engine.py", "outs.append(tok.cpu())"),
    ("serve/engine.py", "torch.stack(outs, dim=-1).numpy()"),
    ("serve/engine.py", "tokens = torch.as_tensor(np.asarray(prompts)"),
    ("serve/engine.py", "emb = (None if embeds is None else torch.as_tensor("),
    ("core/distributed.py", "return (ids[:qn].cpu().numpy()"),
    ("core/distributed.py", "dists[:qn].cpu().numpy()"),
    ("core/distributed.py", "torch.as_tensor(queries[rows]).to("),
    ("core/distributed.py", "torch.as_tensor(cand_mask[rows, lo:lo + ps])"),
    ("core/distributed.py", "torch.as_tensor(keep[rows, lo:lo + ps])"),
    ("core/distributed.py", "torch.as_tensor(take[rows, lo:lo + ps])"),
    ("core/dataplane.py", "return torch.from_numpy(arr).to(device)"),
    ("kernels/bitpack.py", "torch.from_numpy(table).to(device)"),
    ("kernels/bitpack.py", "torch.from_numpy(starts.astype(np.int32))"),
    ("models/transformer.py", 'return {"step": torch.tensor('),
]


def _line_of(rel, text):
    with open(os.path.join(TREES["repro_torch"], rel), encoding="utf-8") as fh:
        hits = [i for i, ln in enumerate(fh, start=1) if text in ln]
    assert len(hits) == 1, (rel, text, hits)
    return hits[0]


def test_stripped_port_sync_findings_are_its_pragmas(stripped_trees):
    found, named = stripped_trees["repro_torch"]
    syncs = {(f.path, f.line) for f in found["port"]
             if f.rule == "device-sync"}
    assert syncs == {site for site, rules in named.items()
                     if "device-sync" in rules}
    assert syncs == {(rel, _line_of(rel, text))
                     for rel, text in INTENDED_SYNCS}


def test_port_rules_replace_the_jit_rules():
    jit_rules = {r for r in ref_analysis.RULES if r.startswith("jit-")}
    assert set(ref_analysis.RULES) - jit_rules == SHARED_RULES
    assert set(PORT_RULES) == SHARED_RULES | {"device-sync",
                                              "compile-per-call"}
    assert port_analysis.RULES is PORT_RULES


# ------------------------------------------------------- the port's rules

def _port_rules(text, rel):
    findings, _ = port_runner.analyze_source(rel, textwrap.dedent(text))
    return sorted(f.rule for f in findings)


SYNC_FLAGGED = [
    ("item", "def f(x):\n    return x.sum().item()\n"),
    ("cpu", "def f(x):\n    return x.cpu()\n"),
    ("numpy", "def f(x):\n    return x.detach().numpy()\n"),
    ("tolist", "def f(x):\n    return x.tolist()\n"),
    ("nonzero-method", "def f(x):\n    return x.nonzero()\n"),
    ("synchronize", "import torch\n\ndef f():\n    torch.cuda.synchronize()\n"),
    ("torch-nonzero", "import torch\n\ndef f(x):\n    return torch.nonzero(x)\n"),
    ("torch-unique", "import torch\n\ndef f(x):\n    return torch.unique(x)\n"),
    ("masked-select",
     "import torch\n\ndef f(x, m):\n    return torch.masked_select(x, m)\n"),
    ("float-of-reduction", "def f(x):\n    return float(x.sum())\n"),
    ("int-of-torch-call",
     "import torch\n\ndef f(x):\n    return int(torch.argmax(x))\n"),
    ("bool-of-any", "def f(x):\n    return bool((x > 0).any())\n"),
    ("through-a-name", "def f(x):\n    s = x.norm()\n    return float(s)\n"),
    ("through-an-index",
     "import torch\n\ndef f():\n    v = torch.zeros(3)\n    return int(v[0])\n"),
    ("annotated-parameter",
     "import torch\n\ndef f(x: torch.Tensor):\n    return float(x)\n"),
    ("augmented-name",
     "def f(x, y):\n    s = x.sum()\n    s += 1\n    return float(s)\n"),
    ("if-condition", "def f(x):\n    if x.isnan().any():\n        return 0\n"),
    ("while-condition",
     "def f(x):\n    while (x > 1).all():\n        x = x / 2\n"),
    ("assert", "import torch\n\ndef f(x):\n    assert torch.isfinite(x).all()\n"),
    ("boolop-operand", "def f(a, x):\n    return a and x.any()\n"),
    ("not-operand", "def f(x):\n    return not x.all()\n"),
    ("ifexp", "def f(x):\n    return 1 if x.max() > 0 else 2\n"),
    ("from-numpy-to-device", "import torch\n\ndef f(a, device):\n"
     "    return torch.from_numpy(a).to(device)\n"),
    ("from-numpy-to-device-keyword", "import torch\n\ndef f(a, d, t):\n"
     "    return torch.from_numpy(a).to(device=d, dtype=t)\n"),
    ("as-tensor-of-numpy", "import numpy as np\nimport torch\n\n"
     "def f(p, dev):\n"
     "    return torch.as_tensor(np.asarray(p), device=dev)\n"),
    ("tensor-of-a-scalar", "import torch\n\ndef f(dev):\n"
     "    return torch.tensor(3, device=dev)\n"),
    ("tensor-of-host-values", "import torch\n\ndef f(vals, dev):\n"
     "    return torch.tensor(vals, device=dev)\n"),
    ("host-name-to-cuda", "import torch\n\ndef f(a):\n"
     "    t = torch.from_numpy(a)\n    return t.cuda()\n"),
    ("copy-from-host", "import torch\n\ndef f(dst, a):\n"
     "    dst.copy_(torch.from_numpy(a))\n"),
]

SYNC_CLEAN = [
    ("config-scalar", "def f(config):\n"
     "    frac = float(config.hamming_perc)\n"
     "    return int(config.min_hamming_keep), frac\n"),
    ("bool-parameter", "def f(sqrt: bool = True):\n    return int(sqrt)\n"),
    ("shape-arithmetic", "def f(x, xs):\n"
     "    return int(x.shape[0]), float(len(xs)), int(x.size(1))\n"),
    ("shape-of-a-tensor",
     "import torch\n\ndef f():\n    v = torch.zeros(3)\n    return int(v.shape[0])\n"),
    ("constant", "def f():\n    return float('inf'), int(3)\n"),
    ("numpy-reduction", "import numpy as np\n\ndef f(p):\n"
     "    return float(np.max(p.keep_frac))\n"),
    ("numpy-array-methods", "import numpy as np\n\ndef f(x):\n"
     "    a = np.asarray(x)\n    return a.tolist(), np.zeros(3).item()\n"),
    ("dtype-comparison", "import torch\n\ndef f(qt, dtype):\n"
     "    return int(qt.dtype == torch.float64), int(dtype == torch.float32)\n"),
    ("finfo", "import torch\n\ndef f(x):\n"
     "    return float(torch.finfo(x.dtype).max)\n"),
    ("rebound-name",
     "def f(x):\n    s = x.sum()\n    s = 3\n    return float(s)\n"),
    ("name-of-another-function", "def g(x):\n    s = x.sum()\n    return s\n\n"
     "def f(s):\n    return float(s)\n"),
    ("condition-on-a-plain-value",
     "def f(x, n):\n    if n > 0 and x is not None:\n        return x\n"),
    ("from-numpy-to-dtype", "import torch\n\ndef f(a):\n"
     "    return torch.from_numpy(a).to(torch.float32)\n"),
    ("non-blocking-copy", "import torch\n\ndef f(a, dev):\n"
     "    return torch.from_numpy(a).to(dev, non_blocking=True)\n"),
    ("as-tensor-of-an-unknown-value", "import torch\n\ndef f(x, dev):\n"
     "    return torch.as_tensor(x, device=dev), x.to(dev)\n"),
    ("as-tensor-on-the-host", "import torch\n\ndef f(step):\n"
     "    return torch.as_tensor(step).to(torch.float32)\n"),
    ("host-tensor-methods", "import torch\n\ndef f(a):\n"
     "    t = torch.from_numpy(a)\n"
     "    return float(t.sum()), t.numpy(), t.tolist(), t.nonzero()\n"),
    ("copy-between-host-tensors", "import torch\n\ndef f(a, b):\n"
     "    torch.from_numpy(a).copy_(torch.from_numpy(b))\n"),
]


@pytest.mark.parametrize("text", [c[1] for c in SYNC_FLAGGED],
                         ids=[c[0] for c in SYNC_FLAGGED])
def test_device_sync_flags(text):
    assert _port_rules(text, "kernels/k.py") == ["device-sync"]


@pytest.mark.parametrize("rel", ["core/dataplane.py", "core/distributed.py",
                                 "kernels/k.py", "models/ssm.py",
                                 "optim/adamw.py", "train/steps.py",
                                 "serve/engine.py"])
def test_device_sync_applies_across_the_sync_scope(rel):
    assert _port_rules("def f(x):\n    return x.item()\n", rel) == \
        ["device-sync"]


@pytest.mark.parametrize("rel", ["core/pipeline.py", "serve/kv_quant.py",
                                 "train/__init__.py", "serverless/runtime.py"])
def test_device_sync_stays_out_of_host_modules(rel):
    assert _port_rules("def f(x):\n    return x.item()\n", rel) == []


@pytest.mark.parametrize("text", [c[1] for c in SYNC_CLEAN],
                         ids=[c[0] for c in SYNC_CLEAN])
def test_device_sync_clean(text):
    assert _port_rules(text, "kernels/k.py") == []


@pytest.mark.parametrize("rel,text", [
    ("core/dataplane.py", "floor = int(config.min_hamming_keep)"),
    ("kernels/adc_lookup.py", "int(sqrt), stream)"),
])
def test_config_scalar_lines_of_the_port_are_not_flagged(rel, text):
    path = os.path.join(TREES["repro_torch"], rel)
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    line = next(i for i, ln in enumerate(source.splitlines(), start=1)
                if text in ln)
    flagged = {f.line for f in sync.check_sync(parse_source(rel, source))}
    assert line not in flagged


def test_a_copy_to_the_host_is_flagged_once():
    """``x.cpu().numpy()`` waits once: the ``.numpy()`` of a tensor already
    on the host is no sync."""
    findings, _ = port_runner.analyze_source(
        "kernels/k.py", "def f(x):\n    return x.cpu().numpy()\n")
    assert [f.message.split("`")[1] for f in findings] == [".cpu()"]


def test_pragma_justifies_a_sync():
    text = ("def f(x):\n    return x.cpu()  "
            "# squash: ignore[device-sync] -- the answer's copy to the host\n")
    assert _port_rules(text, "serve/engine.py") == []


@pytest.mark.parametrize("text,want", [
    ("import torch\n\ndef f(g, x):\n    return torch.compile(g)(x)\n",
     ["compile-per-call"]),
    ("import torch\n\ndef f(g, x):\n    return torch.jit.script(g)(x)\n",
     ["compile-per-call"]),
    ("import torch\n\ndef f(g, x):\n    return torch.jit.trace(g, x)(x)\n",
     ["compile-per-call"]),
    ("import torch\n\ndef make(g):\n    h = torch.compile(g)\n\n"
     "    def run(x):\n        return h(x)\n    return run\n", []),
], ids=["compile", "jit-script", "jit-trace", "hoisted"])
def test_compile_per_call(text, want):
    assert _port_rules(text, "core/distributed.py") == want


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)", "torch.seed()", "torch.cuda.manual_seed(0)",
    "torch.cuda.manual_seed_all(0)", "torch.rand(3)", "torch.randn(3)",
    "torch.randint(0, 5, (3,))", "torch.randperm(4)", "torch.normal(x, 1.0)",
    "torch.bernoulli(x)", "torch.multinomial(x, 2)", "torch.rand_like(x)",
    "torch.randn_like(x)", "torch.randint_like(x, 5)", "x.uniform_()",
    "x.normal_(0, 1)", "x.random_(5)", "x.bernoulli_(0.5)",
    "x.exponential_()"])
def test_torch_default_generator_is_unseeded_rng(call):
    text = f"import torch\n\ndef f(x):\n    return {call}\n"
    assert _port_rules(text, "core/x.py") == ["unseeded-rng"]


@pytest.mark.parametrize("call", [
    "torch.randn(3, generator=g)", "torch.randint(0, 5, (3,), generator=g)",
    "torch.rand_like(x, generator=g)", "x.normal_(generator=g)",
    "x.uniform_(0, 1, generator=g)", "torch.Generator().manual_seed(0)",
    "g.manual_seed(1)"])
def test_seeded_torch_generator_is_clean(call):
    text = f"import torch\n\ndef f(x, g):\n    return {call}\n"
    assert _port_rules(text, "core/x.py") == []


def test_torch_rng_outside_parity_scope_is_clean():
    text = "import torch\n\ndef f():\n    return torch.randn(3)\n"
    assert _port_rules(text, "serve/engine.py") == []


def test_reference_analyzer_ignores_torch_rng():
    """The torch cases are the port's own: the reference's determinism
    checker knows numpy's and the stdlib's generators only."""
    text = "import torch\n\ndef f():\n    return torch.randn(3)\n"
    findings, _ = ref_runner.analyze_source("core/x.py", text)
    assert findings == []


# ---------------------------------------------------------------- the CLI

def test_cli_strict_exits_zero_on_the_port(capsys):
    assert port_runner.main(["--strict"]) == 0
    assert "squashlint: clean (0 finding(s) total, 0 baselined)" in \
        capsys.readouterr().out
    assert port_runner.default_root() == TREES["repro_torch"]
    assert port_runner.load_baseline() == {}


def test_analyzer_needs_neither_torch_nor_numpy():
    """The analyzer is pure ``ast``: it runs where torch, numpy, jax and
    the JAX package cannot be imported."""
    code = ("import sys\n"
            "for name in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.analysis import main\n"
            "sys.exit(main(['--strict']))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "squashlint: clean" in out.stdout


def test_cli_json_report(capsys):
    assert port_runner.main(["--strict", "--json"]) == 0
    report, _ = json.JSONDecoder().raw_decode(capsys.readouterr().out)
    assert report == {"new": [], "baselined": [], "stale_baseline": {}}


@pytest.mark.parametrize("analyzer", sorted(ANALYZERS))
def test_update_baseline_round_trips_in_tmp_path(analyzer, tmp_path,
                                                 monkeypatch, capsys):
    runner = ANALYZERS[analyzer][0]
    packaged = {name: open(os.path.join(root, "analysis", "baseline.json"),
                           "rb").read() for name, root in TREES.items()}
    baseline = tmp_path / "baseline.json"
    monkeypatch.setattr(runner, "baseline_path", lambda: str(baseline))
    root = tmp_path / "pkg" / "core"
    root.mkdir(parents=True)
    dirty = "import time\n\ndef stamp():\n    return time.time()\n"
    (root / "x.py").write_text(dirty)
    pkg = str(tmp_path / "pkg")

    assert runner.main(["--root", pkg, "--strict"]) == 1
    assert runner.main(["--root", pkg, "--update-baseline"]) == 0
    assert runner.load_baseline() == {"wallclock:core/x.py": 1}
    assert "entries" in json.loads(baseline.read_text())
    assert runner.main(["--root", pkg, "--strict"]) == 0
    (root / "x.py").write_text("def stamp():\n    return 0\n")
    assert runner.main(["--root", pkg]) == 0              # shrank: not new
    assert runner.main(["--root", pkg, "--strict"]) == 1  # but stale
    assert runner.main(["--root", pkg, "--update-baseline"]) == 0
    assert runner.load_baseline() == {}
    assert runner.main(["--root", pkg, "--strict"]) == 0
    capsys.readouterr()
    for name, root_dir in TREES.items():
        with open(os.path.join(root_dir, "analysis", "baseline.json"),
                  "rb") as fh:
            assert fh.read() == packaged[name]


# ------------------------------------------------ the card's sync audit

def test_sync_unseen_names_in_scope_lines_the_rule_misses():
    """``chip_smoke.SYNC_UNSEEN`` lists syncs the card takes on lines the
    rule does not flag: each entry's line still holds its text, lies in
    the sync scope and is not flagged (else the table would hide a line
    the rule already sees)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    flagged = smoke.flagged_sync_lines()
    assert flagged == {f"{rel}:{_line_of(rel, text)}"
                       for rel, text in INTENDED_SYNCS}
    for site, entry in smoke.SYNC_UNSEEN.items():
        assert entry["line"] in smoke._port_text(site), site
        assert smoke.in_sync_scope(site) and site not in flagged, site
        assert entry["why"]
