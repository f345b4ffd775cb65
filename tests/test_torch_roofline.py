"""The port's ``launch/roofline.py`` against the JAX package's, on the
CPU: over the same record files (the port's dry-run records of a few
archs at full size, a skip and a failure, written to ``tmp_path``), the
port's ``table()`` and ``dominant_summary()`` equal the reference's
(``repro.launch.roofline`` imports no JAX).  ``NOTES`` is the one
difference: the port's speak of the H100's bottlenecks (HBM, NVLink and
InfiniBand, the tensor cores' peak)."""
import json

import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as j_roof  # noqa: E402
import repro_torch.launch.dryrun as d  # noqa: E402
import repro_torch.launch.roofline as t_roof  # noqa: E402

CASES = [("qwen3_4b", "train_4k"), ("qwen3_4b", "decode_32k"),
         ("xlstm_350m", "prefill_32k"), ("whisper_medium", "long_500k"),
         ("deepseek_67b", "decode_32k"), ("arctic_480b", "long_500k")]


@pytest.fixture(scope="module")
def records():
    return {(a, s, multi): d.run_one(a, s, multi_pod=multi, save=False)
            for a, s in CASES for multi in (False, True)}


@pytest.mark.parametrize("tag", ["", "_opt"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_table_and_summary_equal_the_reference(tmp_path, monkeypatch,
                                               records, mesh, tag):
    for (a, s, multi), rec in records.items():
        m = "2x16x16" if multi else "16x16"
        (tmp_path / f"{a}__{s}__{m}{tag}.json").write_text(json.dumps(rec))
    # a failed record is tabled as FAIL by both
    (tmp_path / f"yi_6b__train_4k__{mesh}{tag}.json").write_text(
        json.dumps({"arch": "yi_6b", "ok": False, "error": "boom"}))
    monkeypatch.setattr(j_roof, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(t_roof, "RESULTS_DIR", str(tmp_path))
    got = t_roof.table(tag, mesh)
    assert got == j_roof.table(tag, mesh)
    assert got.count("\n") == len(CASES) + 2
    assert "| SKIP |" in got and "| FAIL |" in got
    assert set(t_roof.NOTES) == set(j_roof.NOTES)
    summary = t_roof.dominant_summary(tag, mesh)
    assert summary.count("\n") == len(CASES) - 2
    monkeypatch.setattr(t_roof, "NOTES", j_roof.NOTES)
    assert t_roof.dominant_summary(tag, mesh) == \
        j_roof.dominant_summary(tag, mesh)
    assert t_roof.load(tag, mesh).keys() == j_roof.load(tag, mesh).keys()


def test_tables_and_formatting_equal_the_reference(capsys, tmp_path,
                                                   monkeypatch):
    assert t_roof.ARCH_ORDER == j_roof.ARCH_ORDER
    assert t_roof.SHAPE_ORDER == j_roof.SHAPE_ORDER
    for x in (2.5, 1.0, 0.0123, 1e-3, 4.2e-5, 0.0):
        assert t_roof.fmt_s(x) == j_roof.fmt_s(x)
    monkeypatch.setattr(t_roof, "RESULTS_DIR", str(tmp_path))
    t_roof.main(["--tag", "", "--notes"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("| arch | shape | compute")


def test_notes_name_the_cards_bottlenecks():
    text = " ".join(t_roof.NOTES.values())
    for word in ("HBM", "NVLink", "InfiniBand", "tensor cores"):
        assert word in text
    assert "ICI" not in text
