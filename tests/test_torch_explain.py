"""The port's plan-explain and obs report against the reference's.

* ``obs.explain`` renders the reference's text, byte for byte, for every
  entry of the golden plan DB (``tests/data/plan_db_golden.json``) and
  refuses what the reference refuses (selector grammar, unknown names);
  a rung that carries a ``card`` record (a card ladder's B1 tile plan)
  adds the card's table with its measured and predicted milliseconds.
* ``python -m repro_torch.obs.report`` (``--explain``, ``--trace``,
  ``--metrics``) and the reference's ``scripts/obs_report.py`` both accept
  the files the port's CPU ``serve --metrics-out / --trace-out`` writes,
  and both exit non-zero on schema drift.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import pytest

from repro.obs import explain as ref_explain
from repro_torch.launch import serve as port_serve
from repro_torch.obs import explain as port_explain
from repro_torch.obs import report as port_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "plan_db_golden.json")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_LOG", "quiet")


def _ref_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "scripts", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden():
    with open(FIXTURE) as f:
        return json.load(f)


def _selectors():
    out = []
    for entry in _golden().values():
        if isinstance(entry, dict) and entry.get("spec"):
            sel = (f"{entry['spec']['name']}@"
                   f"{port_explain.entry_shape(entry)}")
            out += [sel, f"{sel}@dtype={entry['dtype']}"]
    return sorted(set(out))


@pytest.mark.parametrize("selector", _selectors())
def test_explain_renders_the_references_text(selector):
    got = port_explain.explain(FIXTURE, selector)
    assert got == ref_explain.explain(FIXTURE, selector)
    assert got.startswith(f"plan {selector.split('@dtype')[0]}")
    assert port_explain.match_entries(_golden(), selector) == \
        ref_explain.match_entries(_golden(), selector)


@pytest.mark.parametrize("sel", [
    "matmul@512x512x512@mesh=2x4@dtype=bfloat16", "matmul.dA", "a@1x2",
])
def test_selector_grammar_matches_reference(sel):
    assert port_explain.parse_selector(sel) == ref_explain.parse_selector(sel)


@pytest.mark.parametrize("sel,err", [
    ("matmul@bogus=1", ValueError), ("", ValueError),
])
def test_selector_refusals_match_reference(sel, err):
    for mod in (port_explain, ref_explain):
        with pytest.raises(err):
            mod.parse_selector(sel)


def test_unknown_selector_lists_names():
    with pytest.raises(LookupError, match="matmul") as got:
        port_explain.explain(FIXTURE, "nope@1x1x1")
    with pytest.raises(LookupError) as want:
        ref_explain.explain(FIXTURE, "nope@1x1x1")
    assert str(got.value) == str(want.value)


def _with_card(tmp_path):
    data = _golden()
    key, entry = next((k, e) for k, e in data.items()
                      if isinstance(e, dict) and e.get("spec", {}).get(
                          "name") == "matmul")
    entry = copy.deepcopy(entry)
    entry["ranked"][0].update(
        card={"body": "ring", "tile_n": 128, "splits": 4},
        measured_s=2.24e-05, score=2.1e-05)
    entry["ranked"][0]["explain"]["waves"] = 2
    data[key] = entry
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(data))
    return str(path), "matmul@" + port_explain.entry_shape(entry)


def test_a_card_rung_renders_its_ms(tmp_path):
    path, sel = _with_card(tmp_path)
    got = port_explain.explain(path, sel)
    want = ref_explain.explain(path, sel)
    card = [line for line in got.splitlines()
            if line not in want.splitlines()]
    assert card[0].split() == ["card", "#", "plan", "measured_ms",
                               "predicted_ms", "waves"]
    assert card[1].split() == ["0", "ring", "128x4", "0.0224", "0.0210", "2"]
    assert [line for line in got.splitlines() if line not in card] == \
        want.splitlines()


def test_report_explain_and_its_refusals(tmp_path, capsys):
    path, sel = _with_card(tmp_path)
    port_report.main(["--explain", sel, "--plan-db", path])
    assert "measured_ms" in capsys.readouterr().out
    for argv in (["--explain", sel, "--plan-db", str(tmp_path / "none")],
                 ["--explain", "nope@1x1", "--plan-db", path]):
        with pytest.raises(SystemExit) as e:
            port_report.main(argv)
        assert e.value.code == 1


def test_serve_artifacts_pass_both_reports(tmp_path, capsys):
    metrics, trace = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    port_serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--prompt-len", "8", "--max-new", "2",
                     "--metrics-out", metrics, "--trace-out", trace])
    ref = _ref_report()
    for run in (ref.run_metrics, port_report.run_metrics):
        run(metrics)
    for run in (ref.run_trace, port_report.run_trace):
        run(trace)
    port_report.main(["--metrics", metrics, "--trace", trace])
    out = capsys.readouterr().out
    assert "counters:" in out and "serve.prefill" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x"}]}))
    for run in (ref.run_trace, port_report.run_trace):
        with pytest.raises(SystemExit):
            run(str(bad))
    bad.write_text(json.dumps({"counters": {}, "gauges": {}}))
    for run in (ref.run_metrics, port_report.run_metrics):
        with pytest.raises(SystemExit):
            run(str(bad))
