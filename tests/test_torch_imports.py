"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` use
neither ``jax`` nor the reference package ``repro``, and an entry point
left at its default device never runs on the CPU in place of a card."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import IndicatorFactory, Router, make_policy  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None        # any import of them now fails
        sys.modules["repro"] = None
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            importlib.import_module(name)
        leaked = [m for m, v in sys.modules.items() if v is not None and (
            m.split(".")[0] in ("jax", "jaxlib", "repro"))]
        assert not leaked, leaked
        print(",".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().split(","))
    for mod in ("core.types", "core.radix", "core.indicators",
                "core.policies", "core.pipeline", "core.router",
                "core.state", "kernels.route_score", "kernels._build",
                "workloads.traces", "kernels.prefill_attention",
                "kernels.paged_attention", "models.config", "models.layers",
                "models.attention", "models.model", "models.convert",
                "configs", "configs.qwen2_7b", "configs.qwen3_4b",
                "serving.block_manager", "serving.engine",
                "cluster.metrics", "kernels.rglru_scan",
                "kernels.mlstm_cell", "models.recurrent",
                "configs.recurrentgemma_9b", "configs.xlstm_350m",
                "core.prefix_index", "core.faults", "core.shard_backends",
                "core.sharded_index", "core.hotspot", "obs",
                "obs.registry", "obs.trace", "obs.provenance",
                "core.fleet", "core.overload", "workloads.sessions",
                "cluster.closed_loop", "configs.qwen3_30b_moe",
                "configs.whisper_medium", "data.pipeline",
                "training.optim", "training.train_loop",
                "training.checkpoint", "launch.train", "launch.serve",
                "launch.shapes", "launch.mesh", "launch.sharding",
                "models.sharding_hooks", "launch.dryrun", "launch.roofline",
                "launch.hlo"):
        assert f"repro_torch.{mod}" in names, mod


def test_worker_slots_have_one_definition():
    """The process workers' fixed-slot schema is defined once, beside
    the backend that writes it; the registry re-exports that tuple."""
    import repro_torch.core.shard_backends as sb
    import repro_torch.obs.registry as reg
    assert reg.WORKER_SLOTS is sb.WORKER_SLOTS
    assert reg.N_WORKER_SLOTS == sb.N_WORKER_SLOTS == len(sb.WORKER_SLOTS)


def test_obs_imports_no_torch():
    """``repro_torch.obs`` is numpy only: importing it (in a fresh
    process, so that nothing loaded here counts) loads no torch."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.obs
        import repro_torch.obs.provenance, repro_torch.obs.trace
        leaked = [m for m in sys.modules if m.split(".")[0] == "torch"]
        assert not leaked, leaked[:5]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_imports_neither_jax_nor_repro():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}, tops


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router(make_policy("lmetric"), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndicatorFactory(4)
    with pytest.raises(ValueError):
        IndicatorFactory(4, device="meta")
    assert Router(make_policy("lmetric"), 4, device="cpu").device.type \
        == "cpu"


def test_serving_entry_points_need_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.engine import EngineCluster, InstanceEngine
    cfg = get_config("qwen2_7b-smoke")
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InstanceEngine(cpu_model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCluster(2, cpu_model, params, make_policy("lmetric"))
    cluster = EngineCluster(2, cpu_model, params, make_policy("lmetric"),
                            device="cpu", max_len=64)
    assert cluster.router.device.type == "cpu"
    assert all(t.device.type == "cpu" for e in cluster.engines
               for c in e.cache for t in c.values())
