"""The port's report (``repro_torch.report``, ``python -m repro_torch
report``) against the JAX package's ``experiments/make_report.py``, on
the CPU.

The reference script is loaded by path, as ``python -m repro report``
loads it, and only its section functions are called: nothing here
writes under ``experiments/``. Every comparison is exact text:

- at a reduced grid, the dse, roofline (its engine part), network,
  search, serve and thermal sections equal the reference's;
- the whole report on ``device="cpu"`` (``main(out_dir=tmp)``, the
  network section at its decode_32k cells: its train and prefill cells
  take most of a minute on one CPU thread): the dse, search, serve and
  thermal sections equal the committed ``experiments/*_section.md``, the
  network section the committed one's decode rows, the roofline section
  the committed one up to its dry-run heading; the calibrate section has
  the reference's row labels and finite numbers; nothing under
  ``experiments/`` changes;
- the dry-run tables fed the port's 66 artifacts equal the reference's
  functions fed the same dicts, apart from the trace-time column and the
  headings; ``summary.json`` has the reference's rows;
- the CLI's ``report`` writes where ``--out-dir`` says, and raises
  without a card unless ``--device cpu``.
"""

import hashlib
import importlib.util
import json
import math
import os
import pathlib
import re

import pytest
import torch

from repro_torch import cli, report

REPO = pathlib.Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "experiments"
EXACT = ("dse", "network", "search", "serve", "thermal")
DECODE = ("decode_32k",)


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "repro_make_report", EXPERIMENTS / "make_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


def _tree_digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def full_report(tmp_path_factory):
    """Every section on the CPU (the network section at ``DECODE``), once
    for the module, and the digest of ``experiments/`` before and after."""
    before = _tree_digest(EXPERIMENTS)
    out = tmp_path_factory.mktemp("report")
    network = report.network_section
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(report, "network_section",
                   lambda cache=None, device=None: network(DECODE, cache=cache, device=device))
        written = report.main(device="cpu", out_dir=out)
    return out, written, before, _tree_digest(EXPERIMENTS)


def test_report_writes_only_under_out_dir(full_report):
    out, written, before, after = full_report
    assert before == after
    names = {f"{s}_section.md" for s in report.SECTIONS} | {"summary.json"}
    assert {p.name for p in written} == names
    assert {p.name for p in out.iterdir()} == names
    assert all(p.parent == out for p in written)


@pytest.mark.parametrize("section", [s for s in EXACT if s != "network"])
def test_full_section_equals_committed(full_report, section):
    out = full_report[0]
    assert (out / f"{section}_section.md").read_text() == \
        (EXPERIMENTS / f"{section}_section.md").read_text()


def test_network_section_is_the_committed_decode_rows(full_report):
    text = (full_report[0] / "network_section.md").read_text().splitlines()
    committed = (EXPERIMENTS / "network_section.md").read_text().splitlines()
    n = committed.index("|---|---|---|---|---|---|---|---|---|---|") + 1
    decode = [ln for ln in committed[n:] if ln.split(" | ")[1:2] == ["decode_32k"]]
    assert len(decode) == 10 and text == committed[:n] + decode


def test_roofline_equals_committed_up_to_dryrun_table(full_report):
    text = (full_report[0] / "roofline_section.md").read_text()
    committed = (EXPERIMENTS / "roofline_section.md").read_text()
    assert "### TPU dry-run roofline" not in committed  # the reference's had no artifacts
    head, sep, tail = text.partition("\n### Dry-run roofline")
    assert sep and head == committed
    assert "TPU v5e" in tail.splitlines()[0] and "not measured, and not the card's" in tail
    assert len([ln for ln in tail.splitlines() if ln.startswith("| ")]) == 1 + 33


def _table_rows(text):
    return [ln for ln in text.splitlines() if ln.startswith("| ") and not ln.startswith("| ---")]


def test_calibrate_section_on_the_cpu(full_report):
    text = (full_report[0] / "calibrate_section.md").read_text()
    committed = (EXPERIMENTS / "calibrate_section.md").read_text()
    assert "Backend: `cpu`." in text
    rows, ref_rows = _table_rows(text), _table_rows(committed)
    assert rows[0] == ref_rows[0]  # the header
    assert [r.split(" | ")[0] for r in rows[1:]] == [r.split(" | ")[0] for r in ref_rows[1:]]
    for r in rows[1:]:
        nums = [float(x) for x in re.findall(r"[-+]?\d+\.\d+", r)]
        assert len(nums) == 5 and all(math.isfinite(x) for x in nums), r


def test_summary_json_has_the_reference_rows(full_report, tmp_path, monkeypatch):
    """The reference's own ``main`` pointed at the port's artifacts and a
    scratch directory, its roofline tables stubbed out (only the summary
    is compared)."""
    monkeypatch.setattr(ref, "HERE", tmp_path)
    monkeypatch.setattr(ref, "ART", report.ART)
    monkeypatch.setattr(ref, "roofline_section", lambda arts, cache=None: "")
    ref.main(sections=["roofline"])
    got = json.loads((full_report[0] / "summary.json").read_text())
    want = json.loads((tmp_path / "summary.json").read_text())
    assert got == want and len(got) == 33


def _small(name):
    if name == "dse":
        return {"mac_budgets": (2**14, 2**16), "max_tiers": 4}
    if name == "network":
        return {"shapes": DECODE}
    return {}


@pytest.mark.parametrize("section", EXACT)
def test_section_equals_reference_at_a_reduced_size(section):
    kw = _small(section)
    got = getattr(report, f"{section}_section")(device="cpu", **kw)
    assert got == getattr(ref, f"{section}_section")(**kw)


def test_roofline_engine_part_equals_reference_at_a_reduced_size():
    kw = {"mac_budgets": (2**14, 2**16), "max_tiers": 4}
    assert report.roofline_section({}, device="cpu", **kw) == ref.roofline_section({}, **kw)


def _drop_column(row, i):
    cells = row.split(" | ")
    return " | ".join(cells[:i] + cells[i + 1:])


def test_dryrun_tables_equal_reference_fed_the_same_artifacts():
    arts = report.load()
    assert len(arts) == 66
    assert report._artifact_roofline_table(arts) == ref._artifact_roofline_table(arts)
    got, want = report.dryrun_section(arts), ref.dryrun_section(arts)
    assert got.splitlines()[0] == "**33 single-pod + 33 multi-pod cells traced OK; 0 failures.**"
    assert want.splitlines()[0] == "**33 single-pod + 33 multi-pod cells compiled OK; 0 failures.**"
    g_rows, w_rows = _table_rows(got), _table_rows(want)
    assert len(g_rows) == len(w_rows) == 1 + 66
    assert "trace s" in g_rows[0] and "compile" in w_rows[0]
    # column 3 is the trace's host seconds (the port) or compile seconds (the reference)
    assert [_drop_column(r, 3) for r in g_rows[1:]] == [_drop_column(r, 3) for r in w_rows[1:]]
    lower = {(a["arch"], a["shape"], a["mesh"]): a["lower_s"] for a in arts.values()}
    for r in g_rows[1:]:
        arch, shape, mesh, t = r[2:].split(" | ")[:4]
        assert t == f"{lower[(arch, shape, mesh)]:.2f}s"


def test_cli_report_writes_the_section(tmp_path, capsys):
    assert cli.main(["report", "--sections", "dse", "--device", "cpu",
                     "--out-dir", str(tmp_path)]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["dse_section.md"]
    assert (tmp_path / "dse_section.md").read_text() == \
        (EXPERIMENTS / "dse_section.md").read_text()
    assert "dse_section.md" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_cli_report_needs_a_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["report", "--sections", "dse", "--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_report_imports_neither_jax_nor_the_reference():
    src = (REPO / "src" / "repro_torch" / "report.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M)
    assert "import jax" not in src


def test_cli_report_cache_and_unknown_sections(tmp_path):
    with pytest.raises(ValueError, match="unknown report sections"):
        report.main(sections=["tables"], device="cpu", out_dir=tmp_path)
    cache = tmp_path / "cache"
    for _ in range(2):
        assert cli.main(["report", "--sections", "search", "--device", "cpu", "--cache",
                         str(cache), "--out-dir", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "search_section.md").read_text() == \
        (EXPERIMENTS / "search_section.md").read_text()
    assert any(cache.glob("*/spec.json"))
    assert os.listdir(tmp_path / "out") == ["search_section.md"]
