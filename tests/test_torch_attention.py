"""The port's attention kernels' plain versions and its BlockManager against
the JAX package, on the CPU.

* ``flash_prefill`` / ``paged_attention`` (which run their plain PyTorch
  versions for CPU tensors) against the reference oracles in
  ``repro.kernels.ref`` and the Pallas kernels in interpret mode, on the
  shape sweeps of ``tests/test_kernels.py`` plus G = 7 cases (Qwen2-7B's
  28 query heads over 4 KV heads).  Tolerances are those of
  ``tests/test_kernels.py``: float32 atol 3e-5 / rtol 1e-4, bfloat16
  atol 5e-2 / rtol 5e-2.  Inputs are seeded numpy arrays handed to both.
* ``BlockManager`` against the reference over random allocate / append /
  free sequences: identical tables, lengths, hits and stats (exact).
* The reference's end-to-end wiring of manager block tables into the
  decode kernel (``tests/test_block_manager.py``), through the port.

The CUDA kernels themselves are held against these plain versions on the
card in ``tests/test_torch_attention_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.radix import tokens_to_blocks as j_tokens_to_blocks  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.prefill_attention import flash_prefill as j_flash  # noqa: E402
from repro.serving.block_manager import BlockManager as JBlockManager  # noqa: E402
from repro_torch.core.radix import tokens_to_blocks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as fp  # noqa: E402
from repro_torch.serving.block_manager import BlockError, BlockManager  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def both(x, dtype):
    """One numpy array as a jnp array and a torch CPU tensor of ``dtype``
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


PAGED = [(2, 4, 4, 64, 16, 3),     # MHA
         (3, 8, 2, 64, 16, 4),     # GQA
         (1, 8, 1, 128, 8, 5),     # MQA, wide head
         (2, 4, 2, 128, 32, 2),
         (3, 28, 4, 64, 16, 4)]    # G = 7


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KV,hd,page,npages", PAGED)
def test_paged_plain_matches_jax(B, H, KV, hd, page, npages, dtype):
    rng = np.random.RandomState(B * 97 + H + npages)
    ntotal = npages * B + 2
    q = both(rng.randn(B, H, hd).astype(np.float32) * 0.5, dtype)
    kp = both(rng.randn(ntotal, page, KV, hd).astype(np.float32) * 0.5,
              dtype)
    vp = both(rng.randn(ntotal, page, KV, hd).astype(np.float32) * 0.5,
              dtype)
    bt = rng.randint(0, ntotal, (B, npages)).astype(np.int32)
    ctx = rng.randint(1, npages * page + 1, (B,)).astype(np.int32)
    got = pa.paged_attention(q[1], kp[1], vp[1], torch.from_numpy(bt),
                             torch.from_numpy(ctx))
    assert got.dtype == q[1].dtype and got.shape == (B, H, hd)
    want = ref.paged_attention_ref(q[0], kp[0], vp[0], jnp.asarray(bt),
                                   jnp.asarray(ctx))
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    pallas = j_paged(q[0], kp[0], vp[0], jnp.asarray(bt), jnp.asarray(ctx),
                     interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))


def test_paged_plain_zero_context_matches_pallas():
    """The Pallas kernel skips every page of a zero-length context and
    returns 0; the port's plain version (and kernel) do the same."""
    rng = np.random.RandomState(4)
    q, kp, vp = (rng.randn(*s).astype(np.float32)
                 for s in ((2, 4, 64), (5, 16, 2, 64), (5, 16, 2, 64)))
    bt = np.array([[1, 2], [3, 4]], np.int32)
    ctx = np.array([0, 7], np.int32)
    got = pa.paged_attention(*(torch.from_numpy(a)
                               for a in (q, kp, vp, bt, ctx)))
    pallas = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, ctx)),
                     interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), atol=3e-5, rtol=1e-4)
    assert not got[0].any()


PREFILL = [(2, 24, 16, 4, 2, 64, None, 8, 8),
           (1, 17, 5, 8, 8, 64, None, 16, 16),     # ragged block edges
           (2, 32, 0, 4, 1, 128, None, 16, 32),    # MQA, no cached prefix
           (2, 24, 16, 4, 2, 64, 8, 8, 8),         # sliding window
           (1, 64, 32, 8, 2, 64, 16, 32, 16),
           (1, 19, 9, 28, 4, 64, None, 8, 8)]      # G = 7, ragged


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,off,H,KV,hd,window,bq,bk", PREFILL)
def test_flash_prefill_plain_matches_jax(B, Sq, off, H, KV, hd, window, bq,
                                         bk, dtype):
    rng = np.random.RandomState(B * 131 + Sq + off + H)
    Sk = off + Sq
    q = both(rng.randn(B, Sq, H, hd).astype(np.float32) * 0.4, dtype)
    k = both(rng.randn(B, Sk, KV, hd).astype(np.float32) * 0.4, dtype)
    v = both(rng.randn(B, Sk, KV, hd).astype(np.float32) * 0.4, dtype)
    offs = np.full((B,), off, np.int32)
    got = fp.flash_prefill(q[1], k[1], v[1], torch.from_numpy(offs), window)
    assert got.dtype == q[1].dtype and got.shape == (B, Sq, H, hd)
    want = ref.flash_prefill_ref(q[0], k[0], v[0], jnp.asarray(offs),
                                 window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    pallas = j_flash(q[0], k[0], v[0], jnp.asarray(offs), window=window,
                     block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))


def test_wrappers_reject_bad_inputs():
    z = torch.zeros
    offs = z(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_offset"):
        fp.flash_prefill(z(1, 4, 4, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
                         offs.long())
    with pytest.raises(ValueError, match="do not fit"):
        fp.flash_prefill(z(1, 4, 3, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
                         offs)
    with pytest.raises(ValueError, match="dtype"):
        fp.flash_prefill(z(1, 4, 4, 64, dtype=torch.float16),
                         z(1, 8, 2, 64), z(1, 8, 2, 64), offs)
    with pytest.raises(ValueError, match="window"):
        fp.flash_prefill(z(1, 4, 4, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
                         offs, window=0)
    bt = z((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="block_tables"):
        pa.paged_attention(z(1, 4, 64), z(3, 16, 2, 64), z(3, 16, 2, 64),
                           bt.long(), offs)
    with pytest.raises(ValueError, match="context_lens"):
        pa.paged_attention(z(1, 4, 64), z(3, 16, 2, 64), z(3, 16, 2, 64),
                           bt, z(2, dtype=torch.int32))


def test_build_flags_per_source(tmp_path):
    """Only route_score (bit-identical float64 scores) is built without
    fused multiply-adds; the attention kernels keep them."""
    for name in ("prefill_attention", "paged_attention"):
        src = _build.CSRC / f"{name}.cu"
        cmd = _build.nvcc_command(src, tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert "-fmad=false" not in cmd
        # each source names the TPU kernel it replaces
        assert f"src/repro/kernels/{name}.py::_kernel" in src.read_text()
        assert _build.library_path(name).name.startswith(name + "-")
    cmd = _build.nvcc_command(_build.CSRC / "route_score.cu",
                              tmp_path / "x.so")
    assert "-fmad=false" in cmd
    # each library hash covers its own flags
    hashes = {_build.library_path(n).name.split("-")[-1]
              for n in ("route_score", "prefill_attention",
                        "paged_attention")}
    assert len(hashes) == 3


def test_chip_smoke_attention_bounds_count_the_work_needed():
    """``chip_smoke.py``'s bounds: each input read once, each output written
    once, and only the causal (or in-window, or in-context) work."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    H, KV, hd = 28, 4, 128
    Sq, off = 512, 1024
    nbytes, ops = smoke.prefill_bound(Sq, off)
    assert nbytes == 2 * (2 * Sq * H * hd + 2 * (off + Sq) * KV * hd) + 4
    keys_seen = Sq * off + Sq * (Sq + 1) // 2          # row i sees off+i+1
    assert ops == 4 * hd * H * keys_seen == 9_398_910_976
    assert smoke.prefill_bound(4, 10, window=3)[1] == 4 * hd * H * 4 * 3
    nbytes, ops = smoke.paged_bound([16, 17], 16)      # 1 + 2 pages
    assert nbytes == 2 * 2 * 33 * KV * hd + 2 * 2 * 2 * H * hd + 4 * 3 + 8
    assert ops == 4 * hd * H * 33
    bound, by = smoke._bound(*smoke.prefill_bound(Sq, off))
    assert by == "operations" and abs(bound - 9.3989e9 / 989e12 * 1e3) < 1e-6


# ---------------------------------------------------------------------------
# BlockManager
# ---------------------------------------------------------------------------

def _chain(tokens, ps, fn):
    return [tuple([h]) for h in fn(tokens, ps)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_matches_reference(seed):
    """Random allocate / append / free interleavings over prompts that share
    prefixes: both managers give the same hits, tables, lengths, stats and
    out-of-pages errors at every step."""
    rng = np.random.RandomState(seed)
    ps = 4
    jb, tb = JBlockManager(24, ps), BlockManager(24, ps)
    roots = [list(rng.randint(0, 50, 12)) for _ in range(3)]
    live, next_sid = [], 0
    for _ in range(300):
        op = rng.randint(3)
        if op == 0 or not live:
            toks = roots[rng.randint(3)][:rng.randint(0, 13)] + \
                list(rng.randint(0, 50, rng.randint(0, 9)))
            outs = []
            for bm, fn in ((jb, j_tokens_to_blocks), (tb, tokens_to_blocks)):
                try:
                    outs.append(bm.allocate(next_sid, _chain(toks, ps, fn)))
                except RuntimeError as e:
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
            if isinstance(outs[0], int):
                live.append(next_sid)
            next_sid += 1
        elif op == 1:
            sid = live[rng.randint(len(live))]
            outs = []
            for bm in (jb, tb):
                try:
                    bm.append_token(sid)
                    outs.append("ok")
                except RuntimeError as e:
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
        else:
            sid = live.pop(rng.randint(len(live)))
            jb.free_seq(sid)
            tb.free_seq(sid)
        assert jb.stats() == tb.stats()
        for sid in live:
            assert jb.block_table(sid) == tb.block_table(sid)
            assert jb.context_len(sid) == tb.context_len(sid)
    assert isinstance(BlockError("x"), RuntimeError)


def test_end_to_end_with_paged_attention():
    """Manager-produced block tables drive the port's paged attention and
    match the reference's gather-based oracle (port of
    ``tests/test_block_manager.py::test_end_to_end_with_paged_attention_kernel``)."""
    PS = 16
    rng = np.random.RandomState(0)
    KV, hd, H = 2, 64, 4
    n_pages = 12
    bm = BlockManager(n_pages=n_pages, page_size=PS)
    k_pages = np.zeros((n_pages, PS, KV, hd), np.float32)
    v_pages = np.zeros((n_pages, PS, KV, hd), np.float32)
    shared = list(range(2 * PS))
    seqs = {0: shared + list(range(500, 500 + PS)),
            1: shared + list(range(900, 900 + PS))}
    for sid, toks in seqs.items():
        hit = bm.allocate(sid, _chain(toks, PS, tokens_to_blocks))
        for j, pid in enumerate(bm.block_table(sid)):
            if j * PS < hit:
                continue  # shared pages already hold the prefix KV
            k_pages[pid] = rng.randn(PS, KV, hd) * 0.5
            v_pages[pid] = rng.randn(PS, KV, hd) * 0.5
    max_pages = max(len(bm.block_table(s)) for s in seqs)
    bt = np.asarray([bm.block_table(s, pad_to=max_pages) for s in seqs],
                    np.int32)
    ctx = np.asarray([bm.context_len(s) for s in seqs], np.int32)
    q = (rng.randn(2, H, hd) * 0.5).astype(np.float32)
    out = pa.paged_attention(*(torch.from_numpy(a)
                               for a in (q, k_pages, v_pages, bt, ctx)))
    want = ref.paged_attention_ref(*(jnp.asarray(a)
                                     for a in (q, k_pages, v_pages, bt, ctx)))
    np.testing.assert_allclose(f32(out), f32(want), atol=2e-5)
    assert bm.block_table(0)[:2] == bm.block_table(1)[:2]
