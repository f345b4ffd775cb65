"""Nothing the benchmark runs loads JAX or the JAX package, judged by the
whole top-level module name (``repro_torch`` begins with ``repro``), and
the plain references load nothing of the program."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_level(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}/src:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax_nor_the_jax_package():
    pytest.importorskip("torch")
    mods = _top_level(
        "import servebench.run, servebench.harness, servebench.sweep, "
        "servebench.control\n"
        "from servebench import harness\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[harness.reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "from servebench import serving\n"
        "serving.port_config(harness.load_json('configs', 'qwen2_7b'))\n"
        "import repro_torch.serving.engine, repro_torch.core.policies")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_references_load_nothing_of_the_program():
    pytest.importorskip("torch")
    mods = _top_level("import servebench.reference.decoder, "
                      "servebench.reference.lmetric_router")
    assert "repro_torch" not in mods and not mods & FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    from servebench import run
    assert set(run.FORBIDDEN) == FORBIDDEN
    monkeypatch.setattr(sys, "modules", {"repro_torch": 0, "jaxtyping": 0,
                                         "repro_torch.core": 0})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"repro.core": 0, "jax": 0})
    assert run.forbidden_modules() == ["jax", "repro"]
