"""What the benchmark's modules import, by an AST scan (top-level names
compared whole): nothing under ``perfbench/`` imports JAX or the JAX package
``mslesions3d_tpu``; the plain reference imports nothing of the program
``mslesions3d_tpu_torch``; nothing reads the TPU-era benchmark files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(PERFBENCH.rglob("*.py"))
TPU_FILES = ("bench.py", "BENCH_", "BASELINE.json", "MULTICHIP_")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax_and_no_jax_package(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax", "mslesions3d_tpu"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mslesions3d_tpu_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_tpu_benchmark_files_read(path):
    text = path.read_text()
    strings = [n.value for n in ast.walk(ast.parse(text))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if any(s.startswith(f) for f in TPU_FILES)]


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import mslesions3d_tpu_torch.serving\nfrom mslesions3d_tpu import ops\n")
    assert top_level_imports(probe) == {"mslesions3d_tpu_torch", "mslesions3d_tpu"}
