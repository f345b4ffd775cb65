"""The port's latency model (``repro_torch.core.latency_model``) and the
config's parameter counts against the JAX package's.

The port's ``EngineSpec`` carries the chip's peak rates as fields whose
defaults are the H100's; given the reference's rates explicitly, every
spec field, derived constant and ``LatencyModel`` output — the noise
draws of the 64-bit LCG included — must equal the reference's exactly
(``==`` on floats: both evaluate the same formulas in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.latency_model as rlm  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
import repro_torch.core.latency_model as tlm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402

REF_RATES = dict(peak_flops=rlm.PEAK_FLOPS, hbm_bw=rlm.HBM_BW)
ARCHS = [a + s for a in ARCH_IDS for s in ("", "-smoke")]


def _specs(arch, **kw):
    return (rlm.spec_from_config(ref_config(arch), **kw),
            tlm.spec_from_config(get_config(arch), **REF_RATES, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    ref, port = ref_config(arch), get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("kw", [{}, {"chips": 2},
                                {"chunk_tokens": 512, "max_batch": 8,
                                 "step_overhead": 0.01, "mfu": 0.35}],
                         ids=["defaults", "chips2", "engine"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_spec_equals_reference(arch, kw):
    ref, port = _specs(arch, **kw)
    for f in ("name", "active_params", "n_layers", "kv_bytes_per_token",
              "chips", "chunk_tokens", "max_batch", "kv_capacity_tokens",
              "step_overhead", "mfu"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.c_flops == ref.c_flops
    assert port.c_attn == ref.c_attn
    assert port.prefill_token_cost == ref.prefill_token_cost


#: (prefill tokens, decode batch, context tokens) over the regimes the
#: simulators step through: decode only, prefill only, mixed, idle
STEPS = [(0, 1, 300), (0, 8, 16000), (512, 0, 0), (2048, 0, 9000),
         (1700, 12, 40000), (3, 255, 250000), (0, 0, 0)]


@pytest.mark.parametrize("error_std,seed", [(0.0, 0), (0.15, 7),
                                            (0.4, 123456789)],
                         ids=["exact", "noise", "noise-wide"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_latency_model_equals_reference(arch, error_std, seed):
    rs, ts = _specs(arch, chunk_tokens=1024)
    ref = rlm.LatencyModel(rs, error_std=error_std, seed=seed)
    port = tlm.LatencyModel(ts, error_std=error_std, seed=seed)
    for p, d, c in STEPS:
        assert port.step_time(p, d, c) == ref.step_time(p, d, c)
        # the scalar predictors draw noise one by one: interleave them so
        # the LCG states must stay in step
        assert port.predict_ttft(p, 700, d, c) == \
            ref.predict_ttft(p, 700, d, c)
        assert port.predict_tpot(d, c, p) == ref.predict_tpot(d, c, p)
    q, dbs, ctx = (np.array(x) for x in zip(*STEPS))
    assert np.array_equal(port.step_time_batch(q, dbs, ctx),
                          ref.step_time_batch(q, dbs, ctx))
    assert np.array_equal(port.predict_ttft_batch(q, 300, dbs, ctx),
                          ref.predict_ttft_batch(q, 300, dbs, ctx))
    assert np.array_equal(port.predict_tpot_batch(dbs, ctx, q),
                          ref.predict_tpot_batch(dbs, ctx, q))
    noise = ref.noise_draws(5)
    assert np.array_equal(np.asarray(port.noise_draws(5)), noise)
    assert np.array_equal(port.predict_ttft_batch(q[:5], 1, dbs[:5],
                                                  ctx[:5], noise=noise),
                          ref.predict_ttft_batch(q[:5], 1, dbs[:5],
                                                 ctx[:5], noise=noise))
    assert np.array_equal(np.asarray(port.noise_draws(9)),
                          np.asarray(ref.noise_draws(9)))
    assert port._rng_state == ref._rng_state


def test_h100_defaults():
    """The defaults are the H100 SXM5 data sheet's rates, so the costs
    per token shrink by the ratio of those rates to the reference's (a
    ratio of two floats, within a few ulp)."""
    spec = tlm.spec_from_config(get_config("qwen2_7b"))
    assert (spec.peak_flops, spec.hbm_bw) == (989.4e12, 3.35e12)
    _, at_ref = _specs("qwen2_7b")
    assert at_ref.c_flops / spec.c_flops == pytest.approx(
        989.4e12 / rlm.PEAK_FLOPS, rel=1e-14)
    assert at_ref.c_attn / spec.c_attn == pytest.approx(
        3.35e12 / rlm.HBM_BW, rel=1e-14)
    # Qwen2-7B: 28 layers x 4 KV heads x 128 x 2 (K and V) x 2 bytes
    assert spec.kv_bytes_per_token == 57344
