"""The port's ``launch/hlo.py`` on the CPU: its ring factors equal the
reference's (``repro.launch.hlo``, which imports no JAX), ``analyze``
gives hand-counted answers on synthetic event lists, and a profile of a
smoke decode step on the CPU holds no device op."""
import pytest

torch = pytest.importorskip("torch")

import repro.launch.hlo as j_hlo  # noqa: E402
import repro_torch.launch.hlo as t_hlo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

E = t_hlo.Event


def test_wire_bytes_equal_the_reference():
    ops = t_hlo.COLLECTIVES + ("something-else",)
    for op in ops:
        for size in (0, 1, 7, 4096, 3 * 2 ** 30 + 5):
            for g in (0, 1, 2, 3, 8, 16, 256, 512):
                assert t_hlo._wire_bytes(op, size, g) == \
                    j_hlo._wire_bytes(op, size, g), (op, size, g)
    assert set(t_hlo.COLLECTIVES) == set(j_hlo._COLL)


def test_dtype_bytes_are_the_element_sizes():
    for dt, n in t_hlo.DTYPE_BYTES.items():
        assert torch.empty((), dtype=dt).element_size() == n


@pytest.mark.parametrize("name,cat", [
    ("void paged_kernel<128, __nv_bfloat16>(Params)", "paged_attention"),
    ("void prefill_wgmma<128>(Params)", "prefill_attention"),
    ("prefill_kernel<float, 64>(...)", "prefill_attention"),
    ("void route_cluster<8>(State)", "route_score"),
    ("rglru_kernel(float const*)", "rglru_scan"),
    ("void cell_wgmma<2>(Args)", "mlstm_cell"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop>(Params)", "gemm"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevComm*)",
     "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("paged_kernelish_helper", "other"),
])
def test_category_by_name(name, cat):
    assert t_hlo.category(name) == cat


def test_analyze_hand_counted():
    evs = [E("aten::mm", None, 0.0, 100.0),             # host, 0-100 us
           E("void paged_kernel<128, bf16>(P)", 0, 10.0, 20.0),   # 10-30
           E("void paged_kernel<128, bf16>(P)", 0, 25.0, 10.0),   # 25-35
           E("nvjet_tst_64x8_ntn", 0, 40.0, 30.0),              # 40-70
           E("Memcpy DtoH (Device -> Pinned)", 0, 90.0, 20.0),  # 90-110
           E("elementwise_kernel", 0, 80.0, 5.0)]              # 80-85
    a = t_hlo.analyze(evs, 1)
    assert a["device_ops"] == 5
    assert a["launches"] == {"route_score": 0, "prefill_attention": 0,
                             "paged_attention": 2, "rglru_scan": 0,
                             "mlstm_cell": 0}
    c = a["categories"]
    assert c["paged_attention"] == {"us": 30.0, "count": 2}
    assert c["gemm"] == {"us": 30.0, "count": 1}
    assert c["copy"] == {"us": 20.0, "count": 1}
    assert c["other"] == {"us": 5.0, "count": 1}
    assert c["collective"] == {"us": 0.0, "count": 0}
    assert a["device_us"] == 85.0
    # union: 10-35, 40-70, 80-85, 90-110 = 25 + 30 + 5 + 20
    assert a["busy_us"] == 80.0
    assert a["wall_us"] == 110.0
    assert a["busy_share"] == pytest.approx(80.0 / 110.0)


def test_analyze_refuses_a_second_card_and_takes_empty_traces():
    evs = [E("k(", 0, 0.0, 1.0), E("k(", 1, 0.0, 1.0)]
    assert t_hlo.analyze(evs, 2)["device_ops"] == 2
    with pytest.raises(ValueError, match="cards"):
        t_hlo.analyze(evs, 1)
    a = t_hlo.analyze([], 1)
    assert (a["device_ops"], a["wall_us"], a["busy_share"]) == (0, 0.0, None)


def test_cpu_profile_of_a_decode_step_has_no_device_op():
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("qwen3_4b-smoke")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    pos = torch.full((2,), 5, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.decode_step(params, tok, pos, cache)
    evs = t_hlo.events(prof)
    assert evs and all(e.device is None for e in evs)
    a = t_hlo.analyze(prof, 1)
    assert a["device_ops"] == 0 and a["device_us"] == 0.0
    assert all(v == 0 for v in a["launches"].values())
    assert a["wall_us"] > 0 and a["busy_share"] == 0.0
