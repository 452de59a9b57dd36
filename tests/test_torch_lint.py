"""The port's scarlint (``repro_torch.analysis.lint``) against its contracts.

Every case of ``tests/test_scarlint.py`` ported to the port's linter
(rules, aliases, suppressions, baseline round trip and drift, CLI exit
codes, ``--trace-out``, the ``python -m`` entry), with torch positives and
negatives for each rule (the sites in ``src/repro_torch`` the rules were
written for, and the host-numpy look-alikes that must stay clean), parity
with the reference linter on numpy/stdlib-only sources (SL001, SL003 and
SL004 give the same findings), and the repo gate: a fresh run over
``src/repro_torch`` equals the committed ``scarlint-torch-baseline.json``,
every suppression carries a reason, the reference's baseline file is never
read or written, and the linter imports neither JAX, the reference nor
torch.  Pure AST work: no device, a few seconds.
"""
import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_paths as ref_lint_paths
from repro.analysis.lint import lint_source as ref_lint_source

from repro_torch import obs
from repro_torch.analysis.lint import (
    Baseline,
    Finding,
    ModuleContext,
    lint_paths,
    lint_source,
)
from repro_torch.analysis.lint.baseline import (BASELINE_FILENAME,
                                                REFERENCE_BASELINE_FILENAME)
from repro_torch.analysis.lint.cli import main as scarlint_main
from repro_torch.analysis.lint.context import infer_module_name
from repro_torch.analysis.lint.runner import PARSE_ERROR_RULE, discover_files

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC_PORT = REPO_ROOT / "src" / "repro_torch"
SRC_REF = REPO_ROOT / "src" / "repro"


@pytest.fixture(autouse=True)
def _restore_tracing_state():
    was = obs.enabled()
    yield
    if not was:
        obs.disable()


def _src(text):
    return textwrap.dedent(text)


def _rules(findings, *, active_only=False):
    return [f.rule for f in findings if not active_only or f.active]


# ---------------------- SL001: xp-genericity --------------------------------

def test_sl001_flags_bare_np_inside_xp_function():
    findings = lint_source(_src("""
        import numpy as np

        def comm(xp, a):
            return np.sum(a)
    """))
    assert _rules(findings) == ["SL001"]
    assert "numpy.sum" in findings[0].message and "xp.sum" in findings[0].message


@pytest.mark.parametrize("imports,call,name", [
    ("from torch import minimum", "minimum(a, 0)", "torch.minimum"),
    ("import torch.nn.functional as F", "F.softplus(a)",
     "torch.nn.functional.softplus"),
    ("import torch", "torch.where(a > 0, a, 0)", "torch.where"),
])
def test_sl001_flags_torch_via_aliases(imports, call, name):
    findings = lint_source(f"{imports}\n\ndef comm(xp, a):\n"
                           f"    return {call}\n")
    assert _rules(findings) == ["SL001"]
    assert name in findings[0].message


def test_sl001_allows_xp_calls_and_dtype_whitelist():
    findings = lint_source(_src("""
        import numpy as np
        import torch

        def comm(xp, a):
            lo = xp.minimum(a, 0)
            eps = np.finfo(np.float32).eps + torch.finfo(torch.float32).eps
            return xp.asarray(lo, dtype=np.float64) + eps
    """))
    assert findings == []


def test_sl001_ignores_functions_without_xp_param():
    findings = lint_source(_src("""
        import numpy as np
        import torch

        def helper(n):
            return np.arange(n), torch.arange(n)
    """))
    assert findings == []


def test_sl001_nested_closure_flagged_once():
    findings = lint_source(_src("""
        import torch

        def outer(xp, a):
            def inner(b):
                return torch.where(b > 0, b, 0)
            return inner(a)
    """))
    assert _rules(findings) == ["SL001"]


# ---------------------- SL002: sync discipline ------------------------------

_SL002_DIRECT = _src("""
    import torch

    def pull(x: torch.Tensor):
        torch.cuda.synchronize()
        idx = torch.nonzero(x)
        return x.item(), idx
""")


def test_sl002_flags_raw_fetches_in_core_scope():
    findings = lint_source(_SL002_DIRECT, path="core/foo.py")
    assert _rules(findings) == ["SL002", "SL002", "SL002"]


def test_sl002_scoped_to_core_and_kernels_only():
    assert lint_source(_SL002_DIRECT, path="online/foo.py") == []
    assert lint_source(_SL002_DIRECT, path="launch/platform.py") == []
    assert _rules(lint_source(_SL002_DIRECT, path="kernels/foo.py")) == [
        "SL002", "SL002", "SL002"]


def test_sl002_flags_wrappers_on_tensor_results():
    findings = lint_source(_src("""
        import numpy as np
        import torch

        def run(a) -> torch.Tensor:
            return a

        def direct(a):
            return np.asarray(run(a))

        def one_step(a):
            out = run(a)
            return float(out)
    """), path="core/foo.py")
    assert _rules(findings) == ["SL002", "SL002"]
    assert "device_fetch" in findings[0].message


def test_sl002_allows_counted_fetch_and_plain_wrappers():
    findings = lint_source(_src("""
        import numpy as np
        import torch
        from repro_torch.launch.platform import device_fetch

        def run(a) -> torch.Tensor:
            return a

        def pull(a):
            (out,) = device_fetch(run(a))
            return float(np.pi), np.asarray([1, 2]), out.item(), out.tolist()
    """), path="core/foo.py")
    assert findings == []


def test_sl002_cross_module_tensor_fn_via_project_index(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "kernels" / "scar_eval").mkdir(parents=True)
    (pkg / "core").mkdir()
    (pkg / "kernels" / "scar_eval" / "ops.py").write_text(_src("""
        import torch

        def evaluate(x, mode) -> tuple[torch.Tensor, torch.Tensor]:
            return x, x
    """))
    (pkg / "core" / "use.py").write_text(_src("""
        import numpy as np
        from repro_torch.kernels.scar_eval import evaluate

        def pull(x):
            return np.asarray(evaluate(x, mode="a"))
    """))
    report = lint_paths([tmp_path], root=tmp_path)
    sl002 = [f for f in report.findings if f.rule == "SL002"]
    assert len(sl002) == 1
    assert sl002[0].path == "repro_torch/core/use.py"


# ---------------------- SL003: seeded RNG -----------------------------------

def test_sl003_flags_global_numpy_stream_and_stdlib_random():
    findings = lint_source(_src("""
        import random

        import numpy as np

        def draw(n):
            random.shuffle(list(range(n)))
            return np.random.rand(n)
    """))
    assert _rules(findings) == ["SL003", "SL003", "SL003"]


def test_sl003_flags_from_random_import():
    findings = lint_source("from random import choice\n")
    assert _rules(findings) == ["SL003"]


def test_sl003_flags_aliased_numpy_random():
    findings = lint_source(_src("""
        import numpy.random as npr

        def draw(x):
            npr.shuffle(x)
    """))
    assert _rules(findings) == ["SL003"]
    assert "numpy.random.shuffle" in findings[0].message


def test_sl003_allows_seeded_generators_and_torch_generator():
    findings = lint_source(_src("""
        import numpy as np
        import torch

        def draw(seed, dev):
            rng = np.random.default_rng(seed)
            gen = np.random.Generator(np.random.PCG64(seed))
            ss = np.random.SeedSequence(seed)
            g = torch.Generator(device=dev).manual_seed(seed)
            w = torch.randn((4, 4), generator=g, device=dev)
            w.uniform_(0, 1, generator=g)
            return rng.normal(), gen.integers(10), ss, w
    """))
    assert findings == []


# ---------------------- SL004: quantized tie-breaks -------------------------

def test_sl004_flags_raw_argsort_on_scores():
    findings = lint_source(_src("""
        import torch

        def pick(scores):
            return torch.argsort(scores, stable=True)
    """))
    assert _rules(findings) == ["SL004"]
    assert "quantize_scores" in findings[0].message


def test_sl004_flags_topk_on_score_derived_name():
    findings = lint_source(_src("""
        import torch

        def pick(a, k):
            sc = metric_score(a)
            return torch.topk(-sc, k)
    """), path="online/foo.py")
    assert _rules(findings) == ["SL004"]


def test_sl004_quantized_stable_operand_is_clean():
    findings = lint_source(_src("""
        import numpy as np
        import torch

        from repro_torch.core.quantize import (quantize_scores,
                                               quantize_scores_torch)

        def pick(scores):
            return np.argsort(quantize_scores(scores))

        def pick2(scores):
            q = quantize_scores_torch(scores)
            return torch.sort(q, dim=1, stable=True).indices
    """))
    assert findings == []


def test_sl004_non_score_operands_clean():
    findings = lint_source(_src("""
        import torch

        def pick(latencies):
            return torch.sort(latencies).indices
    """))
    assert findings == []


# ---------------------- SL005: memoised-call hygiene ------------------------

_SL005_DEF = """
    import functools

    @functools.lru_cache(maxsize=256)
    def get_model(name, batch=1):
        return name
"""


def test_sl005_flags_fstring_argument():
    findings = lint_source(_src(_SL005_DEF + """
        def bad(i):
            return get_model(f"m{i}")
    """))
    assert _rules(findings) == ["SL005"]
    assert "f-string" in findings[0].message and "'name'" in \
        findings[0].message


def test_sl005_flags_unhashable_arguments_kw_and_positional():
    findings = lint_source(_src(_SL005_DEF + """
        def bad(x):
            a = get_model(x, batch={"a": 1})
            b = get_model([1, 2])
            c = get_model(x, batch=dict(a=1))
            return a, b, c
    """))
    assert _rules(findings) == ["SL005", "SL005", "SL005"]


def test_sl005_hashable_arguments_clean():
    findings = lint_source(_src(_SL005_DEF + """
        def good(x):
            return get_model("unet", batch=2), get_model(x, 4)
    """))
    assert findings == []


def test_sl005_assignment_form():
    findings = lint_source(_src("""
        from functools import cache, lru_cache

        def _inner(x, k):
            return x

        g = lru_cache(maxsize=8)(_inner)
        h = cache(_inner)

        def bad(x):
            return g(x, k=[1]), h({x})
    """))
    assert _rules(findings) == ["SL005", "SL005"]


def test_sl005_cross_module_call_site(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "online").mkdir()
    (pkg / "core" / "modelzoo.py").write_text(_src(_SL005_DEF))
    (pkg / "online" / "use.py").write_text(_src("""
        from repro_torch.core.modelzoo import get_model

        def bad(x):
            return get_model(f"m{x}")
    """))
    report = lint_paths([tmp_path], root=tmp_path)
    assert [f.rule for f in report.findings] == ["SL005"]
    assert report.findings[0].path == "repro_torch/online/use.py"


# ---------------------- suppressions ----------------------------------------

def test_suppression_same_line_and_line_above():
    findings = lint_source(_src("""
        import torch

        def draw(n):
            a = torch.rand(n)  # scarlint: ignore[SL003] -- fixture
            # scarlint: ignore[SL003]
            b = torch.rand(n)
            return a, b
    """))
    assert _rules(findings) == ["SL003", "SL003"]
    assert all(f.suppressed for f in findings)
    assert _rules(findings, active_only=True) == []


def test_suppression_multiline_comment_block():
    findings = lint_source(_src("""
        import numpy as np

        def pick(scores):
            # scarlint: ignore[SL004] -- intentional: host f64 ordering
            # mirrored bit-for-bit by the device program; quantising here
            # would fork the parity
            return np.argsort(scores)
    """))
    assert _rules(findings) == ["SL004"]
    assert findings[0].suppressed


def test_bare_ignore_suppresses_all_rules_on_line():
    findings = lint_source(_src("""
        import torch

        def pick(xp, scores):
            return torch.sort(scores)  # scarlint: ignore
    """))
    assert sorted(_rules(findings)) == ["SL001", "SL004"]
    assert all(f.suppressed for f in findings)


def test_ignore_for_other_rule_does_not_suppress():
    findings = lint_source(_src("""
        import torch

        def draw(n):
            return torch.rand(n)  # scarlint: ignore[SL001]
    """))
    assert _rules(findings, active_only=True) == ["SL003"]


# ---------------------- alias resolution ------------------------------------

def test_resolve_chains_through_torch_aliases():
    ctx = ModuleContext("m.py", _src("""
        import numpy as np
        import torch
        import torch.nn.functional as F
        from torch import sort, topk as tk
        from numpy import asarray
    """))

    def resolve(expr):
        return ctx.resolve(ast.parse(expr, mode="eval").body)

    assert resolve("np.random.default_rng") == "numpy.random.default_rng"
    assert resolve("torch.cuda.synchronize") == "torch.cuda.synchronize"
    assert resolve("F.softplus") == "torch.nn.functional.softplus"
    assert resolve("sort") == "torch.sort"
    assert resolve("tk") == "torch.topk"
    assert resolve("asarray") == "numpy.asarray"
    assert resolve("unknown_local.attr") is None


def test_relative_imports_expand_against_module_name():
    ctx = ModuleContext("src/repro_torch/core/foo.py", _src("""
        from .quantize import quantize_scores_torch
        from ..kernels.scar_search import ops
        from ..launch import platform as p
        from . import cost as c
    """))
    assert ctx.module_name == "repro_torch.core.foo"
    assert ctx.aliases["quantize_scores_torch"] == \
        "repro_torch.core.quantize.quantize_scores_torch"
    assert ctx.aliases["ops"] == "repro_torch.kernels.scar_search.ops"
    assert ctx.aliases["p"] == "repro_torch.launch.platform"
    assert ctx.aliases["c"] == "repro_torch.core.cost"


@pytest.mark.parametrize("path,name", [
    ("src/repro_torch/core/cost.py", "repro_torch.core.cost"),
    ("src/repro_torch/core/__init__.py", "repro_torch.core"),
    ("src/repro_torch/__init__.py", "repro_torch"),
    # the reference's package is not the anchor, though a prefix of it
    ("src/repro/core/cost.py", "cost"),
    ("elsewhere/repro_torchx/snippet.py", "snippet"),
])
def test_infer_module_name(path, name):
    assert infer_module_name(path) == name


# ---------------------- baseline mechanism ----------------------------------

_VIOLATION = _src("""
    import torch

    def draw(n):
        return torch.rand(n)
""")


def test_baseline_roundtrip_and_match(tmp_path):
    (tmp_path / "mod.py").write_text(_VIOLATION)
    first = lint_paths([tmp_path], root=tmp_path)
    assert _rules(first.findings, active_only=True) == ["SL003"]

    bl = Baseline.from_findings(first.findings)
    bl_file = tmp_path / BASELINE_FILENAME
    bl.save(bl_file)
    loaded = Baseline.load(bl_file)
    assert loaded.entries == bl.entries and len(loaded) == 1

    second = lint_paths([tmp_path], baseline=loaded, root=tmp_path)
    assert second.active == [] and len(second.baselined) == 1
    assert second.stale_baseline == []
    assert second.ok(strict_baseline=True)


def test_baseline_fingerprint_survives_line_drift(tmp_path):
    (tmp_path / "mod.py").write_text(_VIOLATION)
    bl = Baseline.from_findings(lint_paths([tmp_path],
                                           root=tmp_path).findings)
    (tmp_path / "mod.py").write_text("'''moved'''\n\n\n" + _VIOLATION)
    report = lint_paths([tmp_path], baseline=bl, root=tmp_path)
    assert report.active == [] and len(report.baselined) == 1


def test_stale_baseline_detected_and_fails_strict(tmp_path):
    (tmp_path / "mod.py").write_text(_VIOLATION)
    bl = Baseline.from_findings(lint_paths([tmp_path],
                                           root=tmp_path).findings)
    (tmp_path / "mod.py").write_text("def draw(n):\n    return n\n")
    report = lint_paths([tmp_path], baseline=bl, root=tmp_path)
    assert report.findings == []
    assert len(report.stale_baseline) == 1
    assert report.stale_baseline[0]["rule"] == "SL003"
    assert report.ok() and not report.ok(strict_baseline=True)


def test_baseline_does_not_cover_new_findings(tmp_path):
    (tmp_path / "mod.py").write_text(_VIOLATION)
    bl = Baseline.from_findings(lint_paths([tmp_path],
                                           root=tmp_path).findings)
    (tmp_path / "mod.py").write_text(
        _VIOLATION + "\ndef more(n):\n    return torch.randn(n + 1)\n")
    report = lint_paths([tmp_path], baseline=bl, root=tmp_path)
    assert len(report.baselined) == 1
    assert _rules(report.active) == ["SL003"]


# ---------------------- runner / discovery / obs ----------------------------

def test_discover_files_skips_pycache_and_dedupes(tmp_path):
    (tmp_path / "a.py").write_text("x = 1\n")
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "a.py").write_text("x = 1\n")
    files = discover_files([tmp_path, tmp_path / "a.py"])
    assert [f.name for f in files] == ["a.py"]


def test_parse_error_becomes_sl000_finding(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    report = lint_paths([tmp_path], root=tmp_path)
    assert _rules(report.findings) == [PARSE_ERROR_RULE]
    with pytest.raises(SyntaxError):
        lint_source("def f(:\n")


def test_lint_paths_emits_obs_counters_and_trace(tmp_path):
    (tmp_path / "mod.py").write_text(_VIOLATION)
    scanned = obs.counter("scarlint.files_scanned")
    per_rule = obs.counter("scarlint.findings.SL003")
    before = (scanned.value, per_rule.value)
    obs.enable()
    lint_paths([tmp_path], root=tmp_path)
    trace = obs.chrome_trace()
    obs.disable()
    assert scanned.value == before[0] + 1
    assert per_rule.value == before[1] + 1
    assert obs.gauge("scarlint.runtime_ms").value > 0
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert "scarlint" in cats


# ---------------------- CLI -------------------------------------------------

def _plant(tmp_path):
    d = tmp_path / "proj" / "core"
    d.mkdir(parents=True)
    (d / "bad.py").write_text(_src("""
        import torch

        def pick(scores, x):
            host = torch.nonzero(x)
            return torch.sort(scores, stable=True), host
    """))
    return tmp_path / "proj", d / "bad.py"


def test_cli_planted_violations_exit_nonzero(tmp_path, capsys):
    proj, _ = _plant(tmp_path)
    rc = scarlint_main([str(proj), "--no-baseline"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "SL002" in out and "SL004" in out


@pytest.mark.parametrize("rule,code", [
    ("SL001", "import torch\ndef f(xp, a):\n    return torch.sum(a)\n"),
    ("SL002", "import torch\ndef f(x):\n    torch.cuda.synchronize()\n"),
    ("SL003", "import torch\nx = torch.rand(3)\n"),
    ("SL004", ("import torch\ndef f(scores):\n"
               "    return torch.argsort(scores)\n")),
    ("SL005", ("import functools\n@functools.cache\ndef g(k):\n"
               "    return k\ny = g([1])\n")),
])
def test_cli_per_rule_planting_each_exits_nonzero(tmp_path, rule, code):
    d = tmp_path / rule.lower() / "core"
    d.mkdir(parents=True)
    (d / "mod.py").write_text(code)
    rc = scarlint_main([str(d.parent), "--no-baseline", "--rules", rule])
    assert rc == 1, rule


def test_cli_clean_tree_exits_zero(tmp_path, capsys):
    d = tmp_path / "clean"
    d.mkdir()
    (d / "ok.py").write_text("def f(a):\n    return a + 1\n")
    rc = scarlint_main([str(d), "--no-baseline"])
    assert rc == 0
    assert "0 active" in capsys.readouterr().out


def test_cli_write_baseline_then_clean_then_strict_drift(tmp_path, capsys):
    proj, bad = _plant(tmp_path)
    bl = str(proj / BASELINE_FILENAME)

    rc = scarlint_main([str(proj), "--baseline", bl, "--write-baseline"])
    assert rc == 0 and Path(bl).is_file()
    capsys.readouterr()

    rc = scarlint_main([str(proj), "--baseline", bl, "--strict-baseline"])
    assert rc == 0
    assert "baselined" in capsys.readouterr().out

    # pay down the debt: strict mode now fails on the stale entries
    bad.write_text("def f(a):\n    return a\n")
    rc = scarlint_main([str(proj), "--baseline", bl, "--strict-baseline"])
    assert rc == 1
    assert "stale baseline" in capsys.readouterr().out
    # ...but the non-strict run still passes
    assert scarlint_main([str(proj), "--baseline", bl]) == 0


def test_cli_json_format_and_out_file(tmp_path, capsys):
    proj, _ = _plant(tmp_path)
    out_file = tmp_path / "report.json"
    rc = scarlint_main([str(proj), "--no-baseline", "--format", "json",
                        "--out", str(out_file)])
    assert rc == 1
    stdout_report = json.loads(capsys.readouterr().out)
    file_report = json.loads(out_file.read_text())
    assert stdout_report == file_report
    assert file_report["tool"] == "scarlint-torch"
    assert file_report["counts"]["active"] == 2
    assert {f["rule"] for f in file_report["findings"]} == {"SL002", "SL004"}


def test_cli_rule_selection_and_catalogue(tmp_path, capsys):
    proj, _ = _plant(tmp_path)
    rc = scarlint_main([str(proj), "--no-baseline", "--rules", "SL003"])
    assert rc == 0                      # planted file has no SL003

    rc = scarlint_main(["--list-rules"])
    assert rc == 0
    listing = capsys.readouterr().out
    for rule in ("SL001", "SL002", "SL003", "SL004", "SL005"):
        assert rule in listing
    assert "torch" in listing


def test_cli_usage_errors_exit_two(tmp_path):
    assert scarlint_main([str(tmp_path / "nope")]) == 2
    (tmp_path / "x.py").write_text("x = 1\n")
    assert scarlint_main([str(tmp_path), "--rules", "SL999"]) == 2


def test_cli_trace_out_writes_chrome_trace(tmp_path):
    d = tmp_path / "clean"
    d.mkdir()
    (d / "ok.py").write_text("x = 1\n")
    trace = tmp_path / "trace.json"
    rc = scarlint_main([str(d), "--no-baseline", "--format", "json",
                        "--out", str(tmp_path / "r.json"),
                        "--trace-out", str(trace)])
    assert rc == 0
    payload = json.loads(trace.read_text())
    assert any(e.get("cat") == "scarlint" for e in payload["traceEvents"])


def test_module_entry_point_runs_without_torch(tmp_path):
    """``python -m repro_torch.analysis.lint`` lists the rules and gates a
    tree, with ``torch`` made unimportable: the linter is host code."""
    env = {"PYTHONPATH": str(REPO_ROOT / "src"),
           "PATH": "/usr/bin:/bin:/usr/local/bin"}
    block = ("import runpy, sys; sys.modules['torch'] = None; "
             "sys.argv = ['scarlint'] + sys.argv[1:]; "
             "runpy.run_module('repro_torch.analysis.lint', "
             "run_name='__main__')")
    rc = subprocess.run([sys.executable, "-c", block, "--list-rules"],
                        capture_output=True, text=True, cwd=REPO_ROOT,
                        env=env)
    assert rc.returncode == 0 and "SL001" in rc.stdout, rc.stderr
    (tmp_path / "bad.py").write_text("import torch\nx = torch.rand(3)\n")
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(tmp_path),
         "--no-baseline"], capture_output=True, text=True, cwd=tmp_path,
        env=env)
    assert rc.returncode == 1 and "SL003" in rc.stdout


# ---------------------- repo-wide integration -------------------------------

def test_repo_matches_committed_baseline_exactly():
    """Fresh run over src/repro_torch == committed baseline, both ways.

    New violations (active findings) fail; paid-down debt the baseline
    still lists (stale entries) also fails.  The port's baseline is empty:
    every finding was repaired or suppressed inline with a reason.
    """
    bl_file = REPO_ROOT / BASELINE_FILENAME
    assert bl_file.is_file(), "committed scarlint-torch-baseline.json missing"
    baseline = Baseline.load(bl_file)
    assert len(baseline) == 0
    report = lint_paths([SRC_PORT], baseline=baseline, root=REPO_ROOT)
    assert report.files_scanned > 50
    assert report.active == [], [f.format_text() for f in report.active]
    assert report.stale_baseline == [], report.stale_baseline
    assert report.ok(strict_baseline=True)


def test_repo_suppressions_are_reasoned():
    """Every inline ignore in src/repro_torch carries a ``--`` reason."""
    report = lint_paths([SRC_PORT], root=REPO_ROOT)
    assert len(report.suppressed) >= 3
    for f in report.suppressed:
        text = (REPO_ROOT / f.path).read_text().splitlines()
        window = "\n".join(text[max(0, f.line - 4):f.line])
        assert "scarlint: ignore" in window
        assert "--" in window, f"unreasoned suppression at {f.path}:{f.line}"


def test_finding_dataclass_semantics():
    f = Finding(rule="SL001", path="a.py", line=3, col=4, message="m",
                snippet="x = 1")
    assert f.active and f.fingerprint == ("SL001", "a.py", "x = 1")
    s = f.with_flags(suppressed=True)
    assert s.suppressed and not s.active and not f.suppressed
    assert "SL001" in f.format_text() and "[suppressed]" in s.format_text()
    assert f.as_dict()["line"] == 3


# ---------------------- torch positives and negatives -----------------------

_SL002_POSITIVES = {
    "item": "def f(x: torch.Tensor):\n    return x.item()\n",
    "cpu": "def f(x: torch.Tensor):\n    return x.cpu()\n",
    "numpy": "def f(x):\n    y = torch.ones(3)\n    return y.numpy()\n",
    "tolist": "def f(x):\n    return torch.sort(x).indices.tolist()\n",
    "to_cpu": "def f(x: torch.Tensor):\n    return x.to('cpu')\n",
    "to_cpu_kw": "def f(x: torch.Tensor):\n    return x.to(device='cpu')\n",
    "float": "def f(x: torch.Tensor):\n    return float(x.sum())\n",
    "int": "def f(x):\n    n = torch.count_nonzero(x)\n    return int(n)\n",
    "bool": "def f(x: torch.Tensor):\n    return bool((x == 0).all())\n",
    "optional_param": ("from typing import Optional\n"
                       "def f(x: Optional[torch.Tensor]):\n"
                       "    return x.tolist()\n"),
    "asarray": "def f(x: torch.Tensor):\n    return np.asarray(x[0])\n",
    "nonzero": "def f(x):\n    return torch.nonzero(x)\n",
    "nonzero_method": "def f(x):\n    return x.nonzero()\n",
    "where_one_arg": "def f(x):\n    return torch.where(x > 0)\n",
    "synchronize": "def f():\n    torch.cuda.synchronize()\n",
    "equal": "def f(a, b):\n    return torch.equal(a, b)\n",
    "tensor_upload": ("def f(v, dev):\n"
                      "    return torch.tensor(v, device=dev)\n"),
    "as_tensor_upload": ("def f(a, dev):\n"
                         "    return torch.as_tensor(a, device=dev)\n"),
    "from_numpy_to": ("def f(a, dev):\n"
                      "    return torch.from_numpy(a).to(dev)\n"),
    "from_numpy_name_cuda": ("def f(a):\n    t = torch.from_numpy(a)\n"
                             "    return t.cuda()\n"),
    "module_table": ("_TAB = torch.from_numpy(np.arange(4))\n"
                     "def f(dev):\n"
                     "    return _TAB.to(device=dev, dtype=torch.float32)\n"),
}

_SL002_NEGATIVES = {
    "np_nonzero": "def f(sel):\n    return np.nonzero(sel), np.flatnonzero(sel)\n",
    "fetched_tolist": ("from repro_torch.launch.platform import device_fetch\n"
                       "def f(x):\n    (a,) = device_fetch(x)\n"
                       "    return a.tolist(), float(a[0]), a.item()\n"),
    "host_array_tolist": ("def f(mw, w):\n    col = mw[:, w].tolist()\n"
                          "    return col\n"),
    "shape_int": "def f(x: torch.Tensor):\n    return int(x.shape[0])\n",
    "cast_only": ("def f(a):\n"
                  "    return torch.from_numpy(a).to(torch.float64)\n"),
    "host_tensor": "def f(a):\n    return torch.as_tensor(a), torch.tensor(1)\n",
    "cpu_upload": "def f(a):\n    return torch.tensor(a, device='cpu')\n",
    "device_fill": ("def f(v, dev):\n"
                    "    return torch.full((), v, device=dev)\n"),
    "device_tensor_to": ("def f(x: torch.Tensor, dev):\n"
                         "    return x.to(dev)\n"),
    "counted_upload": ("from repro_torch.launch.platform import "
                       "device_upload\n"
                       "def f(a, dev):\n"
                       "    return device_upload({'a': a}, dev)['a']\n"),
    "list_len": "def f(xs):\n    return int(len(xs)), float('inf')\n",
}


@pytest.mark.parametrize("case", sorted(_SL002_POSITIVES))
def test_sl002_torch_positive(case):
    src = "import numpy as np\nimport torch\n" + _SL002_POSITIVES[case]
    findings = lint_source(src, path="core/mod.py")
    assert _rules(findings) == ["SL002"], case
    assert lint_source(src, path="online/mod.py") == []


@pytest.mark.parametrize("case", sorted(_SL002_NEGATIVES))
def test_sl002_torch_negative(case):
    src = "import numpy as np\nimport torch\n" + _SL002_NEGATIVES[case]
    assert lint_source(src, path="core/mod.py") == [], case


_SL003_POSITIVES = {
    "manual_seed": "torch.manual_seed(0)\n",
    "seed": "torch.seed()\n",
    "cuda_manual_seed_all": "torch.cuda.manual_seed_all(0)\n",
    "randn": "w = torch.randn((4, 4))\n",
    "randint": "w = torch.randint(0, 9, (4,), device='cuda')\n",
    "randperm": "p = torch.randperm(8)\n",
    "multinomial": "def f(p):\n    return torch.multinomial(p, 1)\n",
    "rand_like": "def f(x):\n    return torch.rand_like(x)\n",
    "uniform_": "def f(w):\n    w.uniform_(-1, 1)\n",
    "normal_": "def f(w):\n    return w.normal_()\n",
    "init": "def f(w):\n    torch.nn.init.normal_(w)\n",
}

_SL003_NEGATIVES = {
    "generator_kw": ("def f(dev):\n    g = torch.Generator(device=dev)"
                     ".manual_seed(0)\n"
                     "    return torch.randn((4, 4), generator=g)\n"),
    "multinomial_gen": ("def f(p, g):\n"
                        "    return torch.multinomial(p, 1, generator=g)\n"),
    "inplace_gen": "def f(w, g):\n    w.normal_(generator=g)\n",
    "init_gen": "def f(w, g):\n    torch.nn.init.normal_(w, generator=g)\n",
    "init_constant": "def f(w):\n    torch.nn.init.zeros_(w)\n",
    "numpy_rng": ("def f(seed):\n    rng = np.random.default_rng(seed)\n"
                  "    return rng.normal(size=3)\n"),
}


@pytest.mark.parametrize("case", sorted(_SL003_POSITIVES))
def test_sl003_torch_positive(case):
    src = "import numpy as np\nimport torch\n" + _SL003_POSITIVES[case]
    assert _rules(lint_source(src, path="models/mod.py")) == ["SL003"], case


@pytest.mark.parametrize("case", sorted(_SL003_NEGATIVES))
def test_sl003_torch_negative(case):
    src = "import numpy as np\nimport torch\n" + _SL003_NEGATIVES[case]
    assert lint_source(src, path="models/mod.py") == [], case


_SL004_POSITIVES = {
    "unquantised_sort": ("def f(scores):\n"
                         "    return torch.sort(scores, stable=True)\n"),
    "quantised_unstable": ("def f(scores):\n"
                           "    q = quantize_scores_torch(scores)\n"
                           "    return torch.sort(q, dim=1).indices\n"),
    "quantised_argsort_unstable": (
        "def f(scores):\n"
        "    return torch.argsort(quantize_scores_torch(scores))\n"),
    "msort": "def f(scores):\n    return torch.msort(scores)\n",
    "topk_any_operand": "def f(x):\n    return torch.topk(x, 3)\n",
    "topk_method": ("def f(x: torch.Tensor):\n"
                    "    return x.topk(3, largest=False)\n"),
    "method_argsort_scores": ("def f(lat, e):\n"
                              "    score = torch.maximum(lat, e)\n"
                              "    return score.argsort(stable=True)\n"),
    "masked_topk_site": (
        "def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k):\n"
        "    inf = scores.new_full((), float('inf'))\n"
        "    s = torch.where(valid, scores, inf)\n"
        "    vals, idx = torch.sort(s, stable=True)\n"
        "    return vals[:k], idx[:k]\n"),
}

_SL004_NEGATIVES = {
    "quantised_stable": (
        "def f(lat, energy, metric):\n"
        "    qs = quantize_scores_torch(metric_score(lat, energy, metric),\n"
        "                               sig=5)\n"
        "    return torch.sort(qs, dim=1, stable=True).indices\n"),
    "list_sort": ("def f(nxt, score_of):\n"
                  "    nxt.sort(key=lambda c: score_of[c])\n"
                  "    return nxt\n"),
    "sorted_builtin": "def f(scores):\n    return sorted(scores)\n",
    "non_score_sort": ("def f(lat):\n"
                       "    return torch.sort(-lat.min(dim=1).values, "
                       "stable=True).indices\n"),
    "beam_stage_sort": ("def f(sc, beam):\n"
                        "    return torch.sort(sc.reshape(-1), "
                        "stable=True).indices[:beam]\n"),
}


@pytest.mark.parametrize("case", sorted(_SL004_POSITIVES))
def test_sl004_torch_positive(case):
    src = ("import torch\n"
           "from repro_torch.core.quantize import quantize_scores_torch\n"
           + _SL004_POSITIVES[case])
    assert _rules(lint_source(src, path="kernels/mod.py")) == ["SL004"], case


@pytest.mark.parametrize("case", sorted(_SL004_NEGATIVES))
def test_sl004_torch_negative(case):
    src = ("import torch\n"
           "from repro_torch.core.quantize import quantize_scores_torch\n"
           + _SL004_NEGATIVES[case])
    assert lint_source(src, path="core/mod.py") == [], case


def test_sl004_topk_allowed_off_the_tie_paths():
    """Outside core/, kernels/ and models/ a topk of a non-score operand
    is not a finding; of a quantised score it still is (no tie order)."""
    src = "import torch\ndef f(x):\n    return torch.topk(x, 3)\n"
    assert lint_source(src, path="online/mod.py") == []
    src = ("import torch\ndef f(s):\n"
           "    return torch.topk(quantize_scores_torch(s), 3)\n")
    assert _rules(lint_source(src, path="online/mod.py")) == ["SL004"]


def test_sl005_torch_site_is_the_modelzoo_cache():
    """``core.modelzoo.get_model`` is the port's memoised callable; a call
    with an f-string name from another module is a finding there."""
    report = lint_paths([SRC_PORT / "core" / "modelzoo.py"], root=REPO_ROOT)
    assert report.findings == []
    from repro_torch.analysis.lint.rules import ProjectIndex, default_rules
    project = ProjectIndex()
    ctx = ModuleContext(str(SRC_PORT / "core" / "modelzoo.py"),
                        (SRC_PORT / "core" / "modelzoo.py").read_text())
    for rule in default_rules():
        rule.collect(ctx, project)
    assert "repro_torch.core.modelzoo.get_model" in project.memoised
    use = ModuleContext("src/repro_torch/online/use.py", _src("""
        from ..core.modelzoo import get_model

        def tenants(names, b):
            return [get_model(f"{n}-v2", b) for n in names]
    """))
    sl005 = [r for r in default_rules() if r.rule_id == "SL005"][0]
    assert [f.rule for f in sl005.check(use, project)] == ["SL005"]


# ---------------------- parity with the reference ---------------------------

# numpy/stdlib-only sources: the two linters must agree finding for finding
# on SL001, SL003 and SL004 (SL002 and SL005 speak of jax in the reference)
_PARITY_SOURCES = {
    "xp_bare_np": """
        import numpy as np

        def comm(xp, a, b):
            lo = np.minimum(a, 0)
            eps = np.finfo(np.float32).eps
            def inner(c):
                return np.where(c > 0, c, 0) + xp.abs(c)
            return inner(lo) + np.sum(b) + eps
    """,
    "rng_streams": """
        import random
        from random import choice

        import numpy as np
        import numpy.random as npr

        def draw(n, seed):
            rng = np.random.default_rng(seed)
            random.shuffle(list(range(n)))
            npr.shuffle(np.arange(n))
            return np.random.rand(n), rng.normal(), choice([1, 2])
    """,
    "orderings": """
        import numpy as np

        from repro_torch.core.quantize import quantize_scores

        def pick(scores, latencies, b_lat, b_e):
            a = np.argsort(scores)
            b = np.argsort(latencies)
            q = quantize_scores(scores)
            c = np.lexsort((q, latencies))
            fitness = b_lat * b_e
            d = np.argsort(fitness, kind="stable")
            # scarlint: ignore[SL004] -- host f64 ordering
            e = np.argsort(-scores)
            return a, b, c, d, e, np.argsort(quantize_scores(scores))
    """,
    "mixed": """
        import numpy as np

        def comm(xp, scores):
            return np.argsort(scores), np.random.randint(3)
    """,
}


def _key(findings, rules=("SL001", "SL003", "SL004")):
    return sorted((f.rule, f.line, f.col, f.suppressed) for f in findings
                  if f.rule in rules)


@pytest.mark.parametrize("case", sorted(_PARITY_SOURCES))
def test_numpy_fixture_findings_match_reference(case):
    src = _src(_PARITY_SOURCES[case])
    ours = _key(lint_source(src, path="core/mod.py"))
    ref = _key(ref_lint_source(src, path="core/mod.py"))
    assert ours == ref
    assert ours, "the parity fixture should exercise the rules"


# ---------------------- the port's own sites --------------------------------

def _port_findings(rel):
    return lint_paths([SRC_PORT / rel], root=REPO_ROOT).findings


def _reason(path, line):
    """The suppression comment block ending at ``line``, its reason."""
    text = Path(path).read_text().splitlines()
    i = line - 1
    while "scarlint: ignore" not in text[i]:
        i -= 1
    block = [text[i].split("--", 1)[1]]
    j = i + 1
    while text[j].lstrip().startswith("#"):
        block.append(text[j].lstrip()[1:])
        j += 1
    return " ".join(" ".join(block).split())


def test_reference_suppressions_carry_over_to_flagged_counterparts():
    """Each of the reference's suppressions whose counterpart the port's
    linter flags carries the same rule id and reason there."""
    ref = ref_lint_paths([SRC_REF], root=REPO_ROOT)
    assert len(ref.suppressed) == 3
    port = lint_paths([SRC_PORT], root=REPO_ROOT)
    by_path = {}
    for f in port.suppressed:
        by_path.setdefault(f.path, []).append(f)
    matched = 0
    for f in ref.suppressed:
        twin = f.path.replace("src/repro/", "src/repro_torch/", 1)
        for g in by_path.get(twin, []):
            matched += 1
            assert g.rule == f.rule
            assert _reason(REPO_ROOT / g.path, g.line) == _reason(
                REPO_ROOT / f.path, f.line).replace("_jax", "_torch")
    # engine's host beam argsort and scar_search's masked_topk; the beam
    # stage's sort in device_search is neither score-named nor unstable
    assert matched == 2


def test_expected_sites_in_the_port():
    """The sites the rules were written for, as the port has them now."""
    ops = _port_findings("kernels/scar_search/ops.py")
    assert [(f.rule, f.suppressed) for f in ops] == [("SL004", True)]
    engine = _port_findings("core/engine.py")
    assert [(f.rule, f.suppressed) for f in engine] == [("SL004", True)]
    assert _port_findings("core/device_search.py") == []
    # the torch backend's uploads go through device_upload: nothing left
    assert _port_findings("core/cost.py") == []
    quant = _port_findings("core/quantize.py")
    assert [(f.rule, f.suppressed) for f in quant] == [("SL002", True)]


# ---------------------- the reference's baseline is off limits --------------

def test_write_baseline_never_touches_reference_file(tmp_path, capsys):
    ref_file = REPO_ROOT / REFERENCE_BASELINE_FILENAME
    before = ref_file.read_bytes()
    proj = tmp_path / "proj"
    (proj / "core").mkdir(parents=True)
    (proj / "core" / "bad.py").write_text(_VIOLATION)
    # a reference-named file beside the tree is neither found nor written
    decoy = proj / REFERENCE_BASELINE_FILENAME
    decoy.write_bytes(before)
    rc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(proj),
         "--write-baseline"], capture_output=True, text=True, cwd=proj,
        env={"PYTHONPATH": str(REPO_ROOT / "src"),
             "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert rc.returncode == 0, rc.stderr
    written = proj / BASELINE_FILENAME
    assert json.loads(written.read_text())["tool"] == "scarlint-torch"
    assert decoy.read_bytes() == before
    # naming the reference's file is a usage error, for reading or writing
    for extra in ([], ["--write-baseline"]):
        assert scarlint_main([str(proj), "--baseline", str(decoy),
                              *extra]) == 2
    assert decoy.read_bytes() == before
    with pytest.raises(ValueError):
        Baseline.load(decoy)
    with pytest.raises(ValueError):
        Baseline().save(decoy)
    # a reference-tool file under the port's name is refused too
    (tmp_path / BASELINE_FILENAME).write_bytes(before)
    with pytest.raises(ValueError, match="scarlint-torch"):
        Baseline.load(tmp_path / BASELINE_FILENAME)
    assert ref_file.read_bytes() == before


# ---------------------- isolation -------------------------------------------

def test_lint_package_imports_neither_jax_nor_reference():
    for path in sorted((SRC_PORT / "analysis").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "repro"} & set(roots), \
                f"{path}:{node.lineno} imports {roots}"
