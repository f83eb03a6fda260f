"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Imports are compared by whole
top-level name (the part before the first dot): `neutts_tpu_torch` begins
with `neutts_tpu` and is the program, not the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.manifest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "neutts_tpu"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(sub: str = ""):
    return [p for p in (BENCH_DIR / sub).rglob("*.py") if "tests" not in p.parts]


def test_whole_top_level_names():
    src = "import neutts_tpu_torch.models\nfrom neutts_tpu import config\nimport jaxlib\n"
    p = BENCH_DIR / "tests" / "_scratch_imports.py"
    try:
        p.write_text(src)
        assert top_level_imports(p) == {"neutts_tpu_torch", "neutts_tpu", "jaxlib"}
        assert top_level_imports(p) & FORBIDDEN == {"neutts_tpu", "jaxlib"}
    finally:
        p.unlink()


def test_benchmark_imports_no_jax():
    for p in sources():
        assert not top_level_imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        imps = top_level_imports(p)
        assert "neutts_tpu_torch" not in imps and not imps & FORBIDDEN, p
        assert imps <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}, p
    for p in sources("reference"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), p


def test_loading_the_harness_and_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.readings\n"
            "from benchmark.drivers import engine, stream\n"
            "import neutts_tpu_torch.pipeline, neutts_tpu_torch.serving.engine\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
