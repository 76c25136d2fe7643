"""Repairs of the card's checks, on the CPU.

* ``chip_smoke._judge_take``: a profiled check (a row that must run one
  kernel alone, a profiled serving step) counts only a whole trace.  Its
  session opens with a marker (``MARKERS`` float64 fills: a session can
  lose a prefix of its records, from one to all of them,
  ``scripts/profiler_window.py``), and an empty trace also holds "no
  other device work".  Synthetic Chrome
  traces hold each verdict: whole; the marker lost (taken again); records
  short with the marker kept, an extra record, other work, an int fill
  (each a failure).  ``_alone`` fails when no take is whole, and the
  serving profile reads its numbers without the marker's records.
* ``chip_smoke._kernel_of`` names B1's tc32 kernels and B4's ring kernel
  (a name it misses would count as other device work), and ``_alone``
  counts B4 by its own launcher.
* ``cuda_gen._Scratch``: B1's split and row-reduce counters and B2's tile
  counter are zeroed once, when a (device, stream) pair is allocated; a
  launch that fails may leave them set, so its launcher drops the pair,
  and the next launch on that stream gets freshly zeroed counters.
"""

from __future__ import annotations

import json
import os
import sys
import types

import pytest
import torch

from repro_torch.codegen import cuda_gen, fused_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKER = "void at::native::FillFunctor<double>"
B1 = ("void (anonymous namespace)::contract_bf16_ring_kernel<256>"
      "(CUtensorMap_st, CUtensorMap_st, void*, int)")
B7 = ("void (anonymous namespace)::baseline_bf16_ring_kernel<__nv_bfloat16, "
      "2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
      "int, int, int)")
INT_FILL = "void at::native::FillFunctor<int>"
COPY = "void at::native::elementwise_kernel<copy>"


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _trace(tmp_path, names, name="trace.json"):
    """A Chrome trace of one device record each, in this order, beside a
    host record."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i,
               "dur": 5.0} for i, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": 0.0, "dur": 1.0})
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _names(tmp_path, names):
    cs = _chip_smoke()
    return [n for _, _, n in cs._device_events(_trace(tmp_path, names))]


# --------------------------------------------------------------------------
# the verdict on one take
# --------------------------------------------------------------------------


@pytest.mark.parametrize("names,kernel,counted,want", [
    # whole: marker records (all, or the last few where the session lost
    # a prefix), then as many records as launches, nothing else
    ([MARKER] * 32 + [B1, B1, B1], "contract", 3, "whole"),
    ([MARKER, MARKER, B1, B1, B1], "contract", 3, "whole"),
    ([MARKER, B1, B1, B1], "contract", 3, "whole"),
    ([MARKER, B7, B7, B7], "fused_rnz", 3, "whole"),
    # every marker record lost: whatever else was kept, taken again
    ([B1, B1], "contract", 3, "lost"),
    ([B1, B1, B1], "contract", 3, "lost"),
    ([], "contract", 3, "lost"),
    # records short with the marker kept: a failure
    ([MARKER, B1, B1], "contract", 3, "short"),
    ([MARKER], "fused_rnz", 3, "short"),
    # an extra record: more than the launcher counted
    ([MARKER, B1, B1, B1, B1], "contract", 3, "more"),
    ([B1, B1, B1, B1], "contract", 3, "more"),
    # other device work, with or without the marker: a failure
    ([MARKER, B1, INT_FILL, B1, B1], "contract", 3, "other"),
    ([B1, COPY, B1, B1], "contract", 3, "other"),
    ([MARKER, B7, B7, B7, B1], "fused_rnz", 3, "other"),
    # a float64 fill after the calls began, or one more than the marker's
    # at the start, is other work
    ([MARKER, B1, MARKER, B1, B1], "contract", 3, "other"),
    ([MARKER] * 33 + [B1, B1, B1], "contract", 3, "other"),
], ids=["whole", "whole-prefix-lost", "whole-one-marker", "whole-b7",
        "lost",
        "lost-all-kept", "lost-empty",
        "short", "short-empty", "extra", "extra-no-marker", "int-fill",
        "copy-no-marker", "other-kernel", "late-marker", "extra-marker"])
def test_each_take_gets_its_verdict(tmp_path, names, kernel, counted, want):
    cs = _chip_smoke()
    verdict = cs._judge_take(_names(tmp_path, names), kernel, counted)
    if want in ("whole", "lost"):
        assert verdict == {"whole": cs.WHOLE, "lost": cs.LOST}[want]
        return
    assert verdict not in (cs.WHOLE, cs.LOST)
    assert {"short": "a marker record kept", "more": "records for",
            "other": "other device work"}[want] in verdict


def test_the_decode_step_allows_other_work_but_no_int_fill(tmp_path):
    """The profiled decode step: B1's records as many as its counter
    after the marker's, any other kernel but no int fill (B1's split
    counters are zeroed once, by the pool)."""
    cs = _chip_smoke()
    no_int_fill = lambda k: "FillFunctor<int>" not in k  # noqa: E731
    step = [MARKER, B1, COPY, B1, "void rms_norm_kernel", B1]
    assert cs._judge_take(_names(tmp_path, step), "contract", 3,
                          no_int_fill) == cs.WHOLE
    filled = step + [INT_FILL]
    assert "other device work" in cs._judge_take(
        _names(tmp_path, filled), "contract", 3, no_int_fill)
    assert cs._judge_take(_names(tmp_path, step[1:]), "contract", 3,
                          no_int_fill) == cs.LOST
    assert "a marker record kept" in cs._judge_take(
        _names(tmp_path, step[:-1]), "contract", 3, no_int_fill)


def test_the_step_numbers_leave_out_the_markers_record(tmp_path):
    """``_device_time(..., marker=True)``: busy time and records by name
    without the marker's leading records; a later float64 fill counts."""
    cs = _chip_smoke()
    path = _trace(tmp_path, [MARKER, MARKER, B1, MARKER, B1])
    busy, events, by_name = cs._device_time(path, marker=True)
    assert events == 3 and by_name[B1][1] == 2 and by_name[MARKER][1] == 1
    assert busy == pytest.approx(0.015)
    assert cs._device_time(path)[1] == 5


# --------------------------------------------------------------------------
# _alone over its takes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("traces,passes,takes", [
    ([[MARKER, B7, B7, B7]], True, 1),
    ([[B7, B7], [], [MARKER, B7, B7, B7]], True, 3),
    # no take whole (the last trace repeats): fails, where it used to pass
    ([[B7, B7], []], False, "TAKES"),
    ([[MARKER, B7, B7]], False, 1),
    ([[MARKER, B7, B7, B7, COPY]], False, 1),
], ids=["whole", "lost-lost-whole", "never-whole", "short", "copy"])
def test_alone_passes_only_on_a_whole_take(monkeypatch, tmp_path, traces,
                                           passes, takes):
    cs = _chip_smoke()
    launcher = types.SimpleNamespace(launches=0)
    taken = []

    def fake(run, reps=3):
        launcher.launches += 1 + reps  # the warm-up call, then reps
        taken.append(reps)
        return _names(tmp_path, traces[min(len(taken), len(traces)) - 1])

    monkeypatch.setattr(cs, "_marker_records", fake)
    monkeypatch.setattr(cs, "_launcher", lambda kernel: launcher)
    if passes:
        assert cs._alone(None, "fused_rnz", 1, "case") == takes
        assert cs.TAKEN["case"] == takes
    else:
        with pytest.raises(AssertionError):
            cs._alone(None, "fused_rnz", 1, "case")
    assert len(taken) == (cs.TAKES if takes == "TAKES" else takes)


def test_the_launcher_and_kernel_names_of_the_baselines():
    """``_alone`` reads B5, B6 and B7 by their own launchers and their
    records by the kernel's kind, on every body."""
    cs = _chip_smoke()
    from repro_torch.kernels import _baselines

    assert cs._launcher("matmul") is _baselines.MATMUL
    assert cs._launcher("fused_dense_act") is _baselines.FUSED_DENSE_ACT
    assert cs._launcher("fused_rnz") is _baselines.FUSED_RNZ
    ns = "void (anonymous namespace)::"
    assert cs._kernel_of(B7) == "fused_rnz"
    assert cs._kernel_of(ns + "baseline_bf16_ring_kernel<float, 0>(...)") \
        == "matmul"
    assert cs._kernel_of(ns + "baseline_bf16_kernel<__nv_bfloat16, 1, "
                         "true>(BaselineParams)") == "fused_dense_act"
    assert cs._kernel_of(ns + "baseline_f32_kernel<float, 2>"
                         "(BaselineParams)") == "fused_rnz"


@pytest.mark.parametrize("name,kernel", [
    ("contract_f32_tc_kernel<false>(CUtensorMap_st, CUtensorMap_st, void*, "
     "int, int, int, long long, long long, long long, int)", "contract"),
    ("contract_f32_tc_fused_kernel<true>(CUtensorMap_st, CUtensorMap_st, "
     "ContractParams)", "contract"),
    ("contract_f32_fused_kernel<float>(ContractParams)", "contract"),
    ("contract_f32_kernel<__nv_bfloat16>(float const*, float const*, "
     "__nv_bfloat16*, int, int, int)", "contract"),
    ("grouped_dw_bf16_ring_kernel<__nv_bfloat16>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int const*, int, "
     "int, int, long long, long long, long long)", "grouped_dw"),
    ("grouped_dw_bf16_ring_kernel<float>(...)", "grouped_dw"),
    ("grouped_dw_bf16_mma_kernel<float, true>(...)", "grouped_dw"),
    ("grouped_dw_f32_kernel<float>(...)", "grouped_dw"),
    ("grouped_bf16_ring_kernel<float>(...)", "grouped"),
])
def test_the_new_bodies_kernel_names(name, kernel):
    """``_kernel_of`` gives B1's tc32 kernels and B4's ring kernel to their
    port kernel, not to "other device work", beside the older names."""
    cs = _chip_smoke()
    assert cs._kernel_of("void (anonymous namespace)::" + name) == kernel
    assert cs._category("void (anonymous namespace)::" + name) == kernel


def test_grouped_dw_has_its_launcher_for_alone():
    """``_alone`` counts B4 by its own launcher (the grouped-dw rows' check
    that one launch runs and nothing else, no fill of the output)."""
    cs = _chip_smoke()
    assert cs._launcher("grouped_dw") is fused_gen.GROUPED_DW
    assert cs.DW_BODIES == {"bfloat16": "ring", "float32": "fma"}
    assert cs.MODE_BODIES == {"bfloat16": "ring", "float32": "tc32"}


# --------------------------------------------------------------------------
# the scratch pool's repair
# --------------------------------------------------------------------------


def test_a_dropped_scratch_entry_is_allocated_anew_with_zeroed_counters():
    pool = cuda_gen._Scratch()
    cpu = torch.device("cpu")
    part, count = pool.get(cpu, 7, 64, 16)
    count.fill_(1)  # a launch cut off, its counters left set
    assert pool.get(cpu, 7, 64, 16)[1] is count
    pool.drop(cpu, 7)
    part2, count2 = pool.get(cpu, 7, 64, 16)
    assert count2 is not count and part2 is not part
    assert count2.numel() >= 16 and not bool(count2.any())
    # the other streams' pairs stay
    other = pool.get(cpu, 8, 0, 4)[1]
    pool.drop(cpu, 7)
    assert pool.get(cpu, 8, 0, 4)[1] is other
    pool.drop(cpu, 99)  # an unknown pair: nothing to drop


def test_both_launchers_keep_their_counters_in_a_droppable_pool():
    """B1's launcher and B2's hold their counters in a ``_Scratch``
    (the gpu tests force a failed launch of each and read the pool)."""
    assert isinstance(cuda_gen.CONTRACT._scratch, cuda_gen._Scratch)
    assert isinstance(fused_gen.ATTENTION._scratch, cuda_gen._Scratch)
