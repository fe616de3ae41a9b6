"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``tandem_tpu_torch`` starts with
``tandem_tpu`` and is allowed), and nothing in it reads the JAX package's
benchmarks, the repository's tests or ``chip_smoke.py``."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "tandem_tpu"}
NOT_READ = ("bench.py", "bench_runtime", "BENCH_", "MULTICHIP_",
            "chip_smoke", "tests/fixtures", "BASELINE")


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_forbidden_modules_compares_whole_names():
    sys.path.insert(0, str(ROOT))
    from benchmark.run import forbidden_modules
    loaded = ["tandem_tpu_torch", "tandem_tpu_torch.ops._build", "jaxtyping",
              "flaxen", "numpy", "tandem_tpu", "tandem_tpu.models",
              "jax._src.core", "jaxlib", "flax.linen"]
    assert forbidden_modules(loaded) == sorted(
        ["tandem_tpu", "tandem_tpu.models", "jax._src.core", "jaxlib",
         "flax.linen"])


def test_sources_import_no_jax():
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def _code_strings(tree):
    """String constants of the code, docstrings left out."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_sources_read_no_jax_benchmark_or_tests():
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for text in _code_strings(tree):
            for word in NOT_READ:
                assert word not in text, (path, word)


def test_reference_imports_nothing_of_the_program():
    """The references import torch, numpy and each other only."""
    for path in (BENCH / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level <= 1, path
                assert (node.module or "").split(".")[0] != \
                    "tandem_tpu_torch", path
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "tandem_tpu_torch"
                           for a in node.names), path


def test_what_a_run_loads_holds_no_jax():
    """Import everything a run imports (the harness, both drivers and the
    program modules they build the system from) in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as r\n"
        "import benchmark.traffic.slam, benchmark.traffic.mapping\n"
        "import benchmark.control\n"
        "from tandem_tpu_torch.pipeline import full_system, backend, "
        "mvsnet_runner\n"
        "from tandem_tpu_torch.models import cva_mvsnet, convert\n"
        "from tandem_tpu_torch.mapping import tsdf\n"
        "from tandem_tpu_torch.settings import preset\n"
        "from tandem_tpu_torch.tracking import coarse_tracker\n"
        "from tandem_tpu_torch.utils.timer import Timer\n"
        "import glob, importlib.util\n"
        "for p in sorted(glob.glob(%r)):\n"
        "    s = importlib.util.spec_from_file_location('m', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(r.forbidden_modules(sys.modules))\n"
    ) % (str(ROOT), str(BENCH / "metrics" / "*.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without a card the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "mapping.abl04_640x480.kf_stream",
                          "--seed", "4294967296", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program: the run exits non-zero with no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mapping.abl04_640x480.kf_stream", "--seed", "7",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
