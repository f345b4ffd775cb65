"""The port's ``launch/dryrun.py`` against the JAX package's rule tables,
on the CPU.

The reference's own dry run lowers through XLA on a fake 512-device
mesh, and its mini-mesh test fails undiagnosed (ROADMAP Queue C.2), so
the port is held to the reference's specs and arithmetic, not to its
dry-run output:

* per-card parameter, optimizer and cache bytes, for every assigned arch
  at full size on the 16 x 16 and 2 x 16 x 16 meshes, equal the sum over
  the reference's own trees of each leaf's bytes over the product of the
  mesh axes of its ``PartitionSpec`` (the reference's rule functions read
  only ``mesh.shape``, so they get a stand-in).  The one stated
  difference is Whisper's cache (C.16): the port's cross caches have
  ``cross_rows(1500) = 1504`` rows and no ``enc_out`` sits beside them;
* ``analytic_flops`` equals the reference's and ``flops_per_device`` is
  it over the cards;
* the collectives equal a hand count on a smoke config on a 2 x 4 mesh,
  and the link of a group is NVLink only inside a node of 8 cards;
* ``card_check(..., device="cpu")`` places exactly ``argument_bytes`` and
  the step's outputs have the reckoned shapes, for decode, prefill and
  train;
* the sweep: 80 records, all ``ok``, Whisper x ``long_500k`` the
  reference's documented skip; the launchers' ``--dry-run`` write their
  records; no TPU rate appears in the port.
"""
import functools
import json
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as j_configs  # noqa: E402
import repro.launch.shapes as j_shapes  # noqa: E402
import repro.launch.sharding as j_sh  # noqa: E402
import repro.training.optim as j_optim  # noqa: E402
import repro_torch.launch.dryrun as d  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, fsdp_axes, \
    make_production_mesh  # noqa: E402
from repro_torch.models.attention import cross_rows  # noqa: E402

ARCHS = j_configs.ASSIGNED_ARCHS
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _ref_mesh(multi):
    """What the reference's rules read of a mesh: ``shape``."""
    return types.SimpleNamespace(
        shape=dict(make_production_mesh(multi_pod=multi).shape))


def _factor(spec, mesh) -> int:
    n = 1
    for e in spec:
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n *= mesh.shape[a]
    return n


def _bytes(x) -> int:
    return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


def _flat(tree):
    return [(j_sh._path_str(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JModel(j_configs.get_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _port_record(arch, shape, multi):
    return d.run_one(arch, shape, multi_pod=multi, save=False)


def _ref_param_card(arch, multi):
    """(parameter bytes, AdamW moment bytes) per card by the reference's
    specs on its trees (its step counter, a 4-byte device scalar, left
    out: the port's is a host int)."""
    mesh = _ref_mesh(multi)
    params = _ref_params(arch)
    cfg = j_configs.get_config(arch)
    opt = jax.eval_shape(lambda p: j_optim.adamw_init(
        p, j_optim.OptimizerConfig(moment_dtype=cfg.opt_state_dtype)),
        params)
    p_card = m_card = 0
    for (path, x), (_, m), (_, v) in zip(_flat(params), _flat(opt.m),
                                         _flat(opt.v)):
        f = _factor(j_sh.param_pspec(path, x.shape, mesh,
                                     fsdp_axes(multi)), mesh)
        assert _bytes(x) % f == 0 and m.shape == x.shape == v.shape
        p_card += _bytes(x) // f
        m_card += (_bytes(m) + _bytes(v)) // f
    return p_card, m_card


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_bytes_per_card_match_reference(arch, multi):
    p_card, m_card = _ref_param_card(arch, multi)
    rec = _port_record(arch, "train_4k", multi)
    assert rec["ok"], rec.get("error")
    assert rec["bytes"]["params"] == p_card
    assert rec["bytes"]["opt_state"] == m_card
    assert rec["memory"]["alias_bytes"] == p_card + m_card
    for shape in ("prefill_32k", "decode_32k"):
        assert _port_record(arch, shape, multi)["bytes"]["params"] == p_card


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_per_card_match_reference(arch, multi):
    mesh = _ref_mesh(multi)
    for shape in ("decode_32k", "long_500k"):
        jc, skip = j_shapes.resolve_arch_for_shape(
            j_configs.get_config(arch), shape)
        rec = _port_record(arch, shape, multi)
        if skip:
            assert rec.get("skipped") == skip
            continue
        cache = j_shapes.input_specs(jc, shape)["cache"]
        total = cross = enc_out = 0
        for path, x in _flat(cache):
            n = _bytes(x) // _factor(j_sh.cache_pspec(
                path, x.shape, mesh, fsdp_axes(multi)), mesh)
            total += n
            if path == "enc_out":
                enc_out += n
            elif jc.is_encdec and x.ndim == 5 and x.shape[2] == jc.enc_seq:
                cross += n
        got = rec["bytes"]["cache"]
        if not jc.is_encdec:
            assert got == total, (shape, got, total)
            continue
        # C.16: the port's cross caches are whole decode pages (1504 rows,
        # the sequence over model where the reference's 1500 rows shard
        # the KV heads: the same factor), no enc_out beside them
        assert cross and enc_out
        assert got == total - enc_out - cross \
            + cross * cross_rows(jc.enc_seq) // jc.enc_seq


@pytest.mark.parametrize("shape", list(j_shapes.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device(arch, shape):
    jc, skip = j_shapes.resolve_arch_for_shape(j_configs.get_config(arch),
                                               shape)
    for multi, n_dev in ((False, 256), (True, 512)):
        rec = _port_record(arch, shape, multi)
        assert rec["ok"]
        if skip:
            continue
        assert rec["n_devices"] == n_dev
        assert rec["analytic_flops"] == j_shapes.analytic_flops(jc, shape)
        assert rec["model_flops"] == j_shapes.model_flops(jc, shape)
        assert rec["flops_per_device"] == rec["analytic_flops"] / n_dev
        assert rec["roofline"]["t_compute"] == \
            rec["flops_per_device"] / d.PEAK_FLOPS
        assert rec["dominant"] == max(rec["roofline"],
                                      key=rec["roofline"].get)


def test_collectives_equal_a_hand_count():
    """qwen3_4b-smoke (2 layers, d 256, 4 heads of 64 over 4 KV heads, FFN
    512, tied vocab 512, bf16) on data 2 x model 4, FSDP over data.  Every
    projection shards over both axes (wq/wk/wv/wi/wg columns over model,
    wo rows over model, the other dim over data): a 256 x 256 projection
    is 16384 B a card, 32768 B gathered over data; a 256 x 512 one twice
    that.  The embedding shards its vocab over model only (no gather);
    norms are replicated."""
    cfg = get_config("qwen3_4b-smoke")
    mesh = Mesh((2, 4), ("data", "model"))
    per_layer_ag = 4 * 32768 / 2 + 3 * 65536 / 2       # wq wk wv wo; wi wg wo
    per_layer_rs = 4 * 16384 * 1 + 3 * 32768 * 1
    # decode: B 8 -> 4 a card, one token, d 256 bf16: attn/wo and ffn/wo
    rec = d.reckon(d.build(cfg, "decode", 64, 8, mesh, ("data",)))
    c = rec["collectives"]
    assert c["all-gather"] == 2 * per_layer_ag
    assert c["all-reduce"] == 2 * 2 * (2 * (4 * 1 * 256 * 2) * 3 / 4)
    assert c["reduce-scatter"] == 0
    assert c["counts"] == {"all-gather": 14, "all-reduce": 4,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}
    # train: gathers forward and backward, the gradients scattered, two
    # all-reduces per block (forward and backward) of 4 x 32 x 256 bf16
    rec = d.reckon(d.build(cfg, "train", 32, 8, mesh, ("data",)))
    c = rec["collectives"]
    assert c["all-gather"] == 2 * 2 * per_layer_ag
    assert c["reduce-scatter"] == 2 * per_layer_rs
    assert c["all-reduce"] == 2 * 2 * 2 * (2 * (4 * 32 * 256 * 2) * 3 / 4)
    assert c["total"] == c["all-gather"] + c["reduce-scatter"] \
        + c["all-reduce"]
    # both groups lie in one node of 8 cards: NVLink
    assert rec["roofline"]["t_collective"] == pytest.approx(
        c["total"] / d.NVLINK_BW, rel=1e-12)


def test_link_rates_follow_the_node_layout():
    one = make_production_mesh()
    assert d.link_rate(one, ("model",)) == d.NET_BW      # 16 over 2 nodes
    assert d.link_rate(one, ("data",)) == d.NET_BW       # stride 16
    small = Mesh((4, 8), ("data", "model"))
    assert d.link_rate(small, ("model",)) == d.NVLINK_BW
    assert d.link_rate(small, ("data",)) == d.NET_BW
    assert d.link_rate(Mesh((2, 4), ("data", "model")), ("data",)) \
        == d.NVLINK_BW
    multi = make_production_mesh(multi_pod=True)
    assert d.link_rate(multi, ("pod", "data")) == d.NET_BW


@pytest.mark.parametrize("arch,kind", [
    ("qwen3_4b-smoke", "decode"), ("qwen3_4b-smoke", "prefill"),
    ("qwen3_4b-smoke", "train"), ("whisper_medium-smoke", "decode"),
    ("whisper_medium-smoke", "prefill"), ("recurrentgemma_9b-smoke",
                                          "prefill")])
def test_card_check_on_cpu_places_the_reckoned_bytes(arch, kind):
    cfg = get_config(arch)
    rec = d.card_check(cfg, kind, 64, 2, device="cpu", warmup=1, reps=1)
    assert rec["ok"] and rec["mesh"] == "1x1" and rec["device"] == "cpu"
    assert rec["placed"]["bytes"] == rec["memory"]["argument_bytes"]
    assert "allocator_growth" not in rec["placed"]
    want = d.reckon(d.build(cfg, kind, 64, 2, d.make_smoke_mesh(),
                            ("data",)))
    assert rec["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert rec["collectives"]["total"] == 0.0
    assert rec["roofline"]["t_collective"] == 0.0
    m = rec["measured"]
    assert m["device_ms"] is None and m["event_ms"] is None
    assert m["wall_ms"] > 0
    assert m["trace"]["device_ops"] == 0
    assert rec["roofline_share"] == {"device": None, "wall": None}
    assert rec["memory"]["temp_bytes"] is None


def test_card_check_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.card_check(get_config("qwen3_4b-smoke"), "decode", 64, 2)


def test_sweep_of_80_records():
    recs = [_port_record(a, s, multi) for multi in (False, True)
            for a in ARCHS for s in j_shapes.INPUT_SHAPES]
    assert len(recs) == 80
    assert all(r["ok"] for r in recs), [r.get("error") for r in recs
                                        if not r["ok"]]
    skipped = [(r["arch"], r["shape"]) for r in recs if r.get("skipped")]
    assert skipped == [("whisper_medium", "long_500k")] * 2
    for r in recs:
        if r.get("skipped"):
            continue
        mem = r["memory"]
        assert mem["temp_bytes"] is None
        assert mem["peak_bytes"] == mem["argument_bytes"] \
            + mem["output_bytes"] - mem["alias_bytes"]
        assert r["memory_traffic_bytes"] >= mem["argument_bytes"]


def test_run_one_records_the_documented_skip():
    rec = d.run_one("whisper_medium", "long_500k", save=False)
    _, skip = j_shapes.resolve_arch_for_shape(
        j_configs.get_config("whisper_medium"), "long_500k")
    assert rec["ok"] and rec["skipped"] == skip
    assert "roofline" not in rec


def test_run_one_records_a_failure_and_main_saves(tmp_path, monkeypatch):
    monkeypatch.setattr(d, "RESULTS_DIR", str(tmp_path))
    rec = d.run_one("no_such_arch", "train_4k", save=True)
    assert not rec["ok"] and rec["error"].startswith("KeyError")
    assert json.loads((tmp_path / "no_such_arch__train_4k__16x16.json")
                      .read_text())["ok"] is False
    recs = d.main(["--arch", "qwen3_4b", "--shape", "decode_32k"])
    assert recs[0]["ok"]
    again = d.main(["--arch", "qwen3_4b", "--shape", "decode_32k"])
    assert again[0] == json.loads(json.dumps(recs[0]))     # cached
    with pytest.raises(SystemExit):
        d.launch("no_such_arch", "train_4k", False)


def test_no_tpu_rate_in_the_port():
    pat = re.compile(r"\b(197e12|819e9|ICI)\b")
    for base, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    assert not pat.search(fh.read()), f
