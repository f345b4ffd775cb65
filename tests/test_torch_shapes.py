"""The port's ``launch/shapes.py`` against the JAX package's, on the CPU.

* ``INPUT_SHAPES``, ``ARCH_IDS`` and ``ASSIGNED_ARCHS`` equal the
  reference's.
* ``resolve_arch_for_shape`` makes the same skips and sliding-window
  swaps for every arch x shape.
* ``input_specs`` gives the reference's batch shapes and dtypes, as
  ``meta`` tensors (nothing allocated, at full size).  A decode cache is
  the port's own layout: one dict per layer where the reference stacks
  a scan unit, every leaf of the reference's shape and dtype less the
  stacked axis.  Whisper's differ in two stated ways: its cross caches
  have ``cross_rows(1500) = 1504`` rows (whole decode pages) where the
  reference's have 1500, and the port's cache holds no ``enc_out`` (the
  encoder's output, which the reference keeps beside the cross caches
  and the port's decode never reads).  The total cache bytes equal the
  reference's less exactly those two terms.
* ``model_flops`` and ``analytic_flops`` equal the reference's exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as j_configs  # noqa: E402
import repro.launch.shapes as j_shapes  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
import repro_torch.launch.shapes as t_shapes  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import cross_rows  # noqa: E402

SHAPES = tuple(j_shapes.INPUT_SHAPES)
CASES = [(a, s) for a in j_configs.ARCH_IDS for s in SHAPES]


def _dt(x) -> str:
    d = x.dtype
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _nbytes(x) -> int:
    return int(np.prod(x.shape)) * (x.element_size()
                                    if isinstance(x, torch.Tensor)
                                    else np.dtype(x.dtype).itemsize)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def _pair(arch, shape):
    jc, jskip = j_shapes.resolve_arch_for_shape(j_configs.get_config(arch),
                                                shape)
    tc, tskip = t_shapes.resolve_arch_for_shape(t_configs.get_config(arch),
                                                shape)
    return jc, jskip, tc, tskip


def test_tables_equal_the_reference():
    assert t_shapes.INPUT_SHAPES == j_shapes.INPUT_SHAPES
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert len(t_configs.ASSIGNED_ARCHS) == 10


@pytest.mark.parametrize("arch,shape", CASES)
def test_resolve_arch_for_shape_matches(arch, shape):
    jc, jskip, tc, tskip = _pair(arch, shape)
    assert tskip == jskip
    assert (tc.name, tc.block_pattern, tc.window_size) == \
        (jc.name, jc.block_pattern, jc.window_size)
    assert tc.full_attention == jc.full_attention
    assert tc.supports_long_decode() == jc.supports_long_decode()


@pytest.mark.parametrize("arch,shape", CASES)
def test_flops_equal_the_reference(arch, shape):
    jc, _, tc, _ = _pair(arch, shape)
    assert t_shapes.model_flops(tc, shape) == j_shapes.model_flops(jc, shape)
    assert t_shapes.analytic_flops(tc, shape) == \
        j_shapes.analytic_flops(jc, shape)
    assert t_shapes.analytic_flops(tc, shape) > 0


def _ref_layer_cache(jcache, cfg, i):
    """The reference's cache entry of port layer ``i``, with the index of
    the layer along its stacked axis (None for a remainder layer)."""
    unit, n_units, _ = cfg.repeating_unit()
    L = len(unit)
    if i < n_units * L:
        return jcache["units"][i % L], i // L
    return jcache["rest"][i - n_units * L], None


@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_input_specs_match_at_full_size(arch):
    for shape in SHAPES:
        jc, jskip, tc, _ = _pair(arch, shape)
        if jskip:
            continue
        js, ts = j_shapes.input_specs(jc, shape), \
            t_shapes.input_specs(tc, shape)
        assert ts["kind"] == js["kind"]
        assert all(t.device.type == "meta" for t in _tensors(
            {k: v for k, v in ts.items() if k != "kind"}))
        if js["kind"] != "decode":
            assert list(ts["batch"]) == list(js["batch"])
            for k, j in js["batch"].items():
                assert tuple(ts["batch"][k].shape) == j.shape, (shape, k)
                assert _dt(ts["batch"][k]) == _dt(j), (shape, k)
            continue
        for k in ("token", "pos"):
            assert tuple(ts[k].shape) == js[k].shape
            assert _dt(ts[k]) == _dt(js[k])
        # the cache, leaf by leaf
        cache = ts["cache"]
        assert len(cache) == tc.n_layers
        for i, (kind, entry) in enumerate(zip(tc.block_pattern, cache)):
            ref, u = _ref_layer_cache(js["cache"], jc, i)
            if isinstance(ref, tuple):           # (k, v[, xk, xv])
                ref = dict(zip(("k", "v", "xk", "xv"), ref))
            assert sorted(entry) == sorted(ref), (i, kind)
            for name, t in entry.items():
                want = ref[name].shape[1:] if u is not None \
                    else ref[name].shape
                if name in ("xk", "xv"):
                    # the one stated difference: whole decode pages
                    want = (want[0], cross_rows(tc.enc_seq)) + want[2:]
                assert tuple(t.shape) == want, (shape, i, name)
                assert _dt(t) == _dt(ref[name]), (shape, i, name)
        # total bytes: the reference's, less its enc_out, plus the padding
        got = sum(_nbytes(t) for t in _tensors(cache))
        ref_total = sum(_nbytes(x) for x in _tensors(js["cache"]))
        if tc.is_encdec:
            B = ts["token"].shape[0]
            enc_out = js["cache"]["enc_out"]
            assert enc_out.shape == (B, tc.enc_seq, tc.enc_d_model)
            pad = cross_rows(tc.enc_seq) - tc.enc_seq
            assert (tc.enc_seq, pad) == (1500, 4)
            n_x = tc.block_pattern.count("xattn")
            item = torch.finfo(getattr(torch, tc.dtype)).bits // 8
            assert got == ref_total - _nbytes(enc_out) + n_x * 2 * B * pad \
                * tc.n_kv_heads * tc.resolved_head_dim * item, shape
        else:
            assert js["cache"]["enc_out"] == ()
            assert got == ref_total, (shape, got, ref_total)


def test_abstract_params_match_the_reference_at_full_size():
    """``Model.abstract_params`` builds every arch's full tree on
    ``meta`` (nothing allocated): its total elements and dtypes equal
    those of the reference's ``eval_shape`` of ``init``."""
    from repro.models import Model as JModel
    for arch in j_configs.ARCH_IDS:
        tc = t_configs.get_config(arch)
        tp = Model(tc, device="cpu").abstract_params()
        leaves = list(_tensors(tp))
        assert all(t.device.type == "meta" for t in leaves)
        jp = JModel(j_configs.get_config(arch)).abstract_params()
        jl = jax.tree.leaves(jp)
        assert sum(t.numel() for t in leaves) == \
            sum(int(np.prod(x.shape)) for x in jl), arch
        assert {_dt(t) for t in leaves} == {_dt(x) for x in jl}, arch


def test_init_still_refuses_a_generator_on_another_device():
    """The ``meta`` path does not weaken ``Model.init``'s device check."""
    from repro_torch.models.layers import MetaDraws
    cfg = t_configs.get_config("qwen3_4b-smoke")
    with pytest.raises(ValueError, match="generator on"):
        Model(cfg, device="cpu").init(MetaDraws())
    with pytest.raises(ValueError, match="generator on"):
        Model(cfg, device="meta").init(torch.Generator().manual_seed(0))
    p = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert p["embed"]["w"].device.type == "cpu"
