"""Device ops credited to the program's spans, host waits and idle gaps
named by them (`kmerbench.program_spans`), on synthetic kineto-like
events; and the window with the program's recording on the CPU path."""

import types

import pytest

from kmerbench import kernels, program_spans as ps
from kmerbench.tests.tiny import CELLS, CPU, tiny_cell
from kmerbench.trace import merge_intervals

WINDOW = (0, 10_000)
# the program's records: (name, start, end, parent, call id)
PROGRAM = [
    ("cbl.dynamic_round", 100, 5000, -1, 1),  # 0
    ("words", 200, 900, 0, 1),  # 1
    ("sort", 1000, 2000, 0, 1),  # 2
    ("sort", 1100, 1900, 2, 1),  # 3
    ("join", 2100, 4000, 0, 1),  # 4
    ("index", 4100, 4900, 0, 1),  # 5
    ("sync.n", 4500, 4800, 5, 1),  # 6
]
HARNESS = [("port.dynamic_round", 90, 5010), ("harness.wait", 6000, 9000)]
# runtime and driver calls: (name, start, end, correlation id)
CALLS = [
    ("cudaLaunchKernel", 300, 310, 1),  # in words
    ("cudaLaunchKernel", 1050, 1060, 2),  # in the outer sort
    ("cudaLaunchKernel", 1200, 1210, 3),  # in the inner sort
    ("cuLaunchKernel", 2200, 2280, 4),  # in join, slow (80 ns here)
    ("cudaMemcpyAsync", 2300, 2310, 5),  # in join
    ("cudaLaunchKernel", 4200, 4210, 6),  # in index
    ("cudaStreamSynchronize", 4550, 4790, 0),  # inside sync.n
    ("cudaStreamSynchronize", 3000, 3500, 0),  # in join: a hidden wait
    ("cudaMalloc", 950, 990, 0),  # in cbl.dynamic_round itself
    ("cudaLaunchKernel", 5005, 5008, 7),  # in the harness's port span
    ("cudaMemcpyAsync", 5500, 5510, 8),  # between harness spans
    ("cudaStreamSynchronize", 7000, 8000, 0),  # outside the program
]
# device ops: (name, start, end, correlation id)
OPS = [
    ("necklace_pos_kernel", 400, 1400, 1),
    ("elementwise_kernel", 1400, 1500, 2),
    ("DeviceRadixSortOnesweepKernel", 1500, 2500, 3),
    ("merge_tiles", 2500, 3000, 4),
    ("Memcpy HtoD", 2900, 3100, 5),  # overlaps merge_tiles by 100
    ("index_kernel", 4600, 4700, 6),
    ("stack_kernel", 5100, 5200, 7),
    ("Memcpy DtoH", 5600, 5700, 8),
    ("lost_kernel", 9000, 9100, 99),  # its call was not traced
]
SLOW = 50  # ns: the synthetic calls are short


@pytest.fixture(autouse=True)
def _short_launches(monkeypatch):
    monkeypatch.setattr(ps, "SLOW_LAUNCH_NS", SLOW)


def _group_of(name):
    return {"necklace_pos_kernel": "B1", "merge_tiles": "B3",
            "DeviceRadixSortOnesweepKernel": "library_sort"}.get(name)


def test_each_op_goes_to_the_innermost_span_of_its_launch():
    got = ps.credit(OPS, CALLS, PROGRAM, HARNESS, WINDOW, _group_of)
    assert dict(got["busy"]) == {
        "words": 1000, "sort": 1100, "join": 500 + 100, "index": 100,
        "port.dynamic_round": 100, "harness": 100, "uncredited": 100}
    busy = merge_intervals([(a, b) for _, a, b, _ in OPS])
    assert sum(got["busy"].values()) == sum(b - a for a, b in busy)
    # eager ops (no kernel group), summed as `torch_ops_ms` sums them
    assert dict(got["other"]) == {"sort": 100, "join": 200, "index": 100,
                                  "port.dynamic_round": 100, "harness": 100,
                                  "uncredited": 100}
    assert got["top_other"]["join"] == {"Memcpy HtoD": 200}


def test_self_time_leaves_the_outer_span_what_its_children_do_not_hold():
    calls = [("cudaLaunchKernel", 950, 960, 1),  # dynamic_round itself
             ("cudaLaunchKernel", 1950, 1960, 2)]  # outer sort, after inner
    ops = [("a", 1000, 1100, 1), ("b", 2000, 2300, 2)]
    got = ps.credit(ops, calls, PROGRAM, HARNESS, WINDOW)
    assert dict(got["busy"]) == {"cbl.dynamic_round": 100, "sort": 300}


def test_ops_are_clipped_to_the_window():
    ops = [("a", -50, 50, 1), ("b", 9950, 10_500, 2)]
    calls = [("cudaLaunchKernel", 300, 301, 1),
             ("cudaLaunchKernel", 6500, 6501, 2)]
    got = ps.credit(ops, calls, PROGRAM, HARNESS, WINDOW)
    assert dict(got["busy"]) == {"words": 50, "harness.wait": 50}


def test_host_waits_by_kind():
    got = ps.host_waits(CALLS, PROGRAM, WINDOW)
    assert dict(got["ns"]) == {
        "sync.n": 300,
        "cudaStreamSynchronize@join": 500,
        "launch>50us@join": 80,
        "cudaMalloc@cbl.dynamic_round": 40,
    }
    assert dict(got["count"]) == {k: 1 for k in got["ns"]}


def test_a_launch_below_the_limit_is_no_wait(monkeypatch):
    monkeypatch.setattr(ps, "SLOW_LAUNCH_NS", 80)
    assert "launch>50us@join" not in ps.host_waits(CALLS, PROGRAM,
                                                   WINDOW)["ns"]


def test_idle_gaps_by_program_span():
    busy = merge_intervals([(a, b) for _, a, b, _ in OPS])
    got = ps.idle_by_program_span(busy, CALLS, PROGRAM, HARNESS, WINDOW)
    # gap by gap, by its middle: [0, 400) 200 words; [3100, 4600) 3850
    # join, no call held; [4700, 5100) 4900 index, sync.n has ended;
    # [5200, 5600) 5400 and [9100, 10000) 9550 no span; [5700, 9000) 7350
    # harness.wait (the sync held then is not the program's)
    assert dict(got) == {"words": 400, "join": 1500, "index": 400,
                         "harness": 400 + 900, "harness.wait": 3300}
    assert sum(got.values()) == WINDOW[1] - sum(b - a for a, b in busy)


def test_an_idle_gap_inside_a_blocking_call_names_the_call():
    ops = [("a", 0, 3200, 1), ("b", 3400, 10_000, 2)]
    calls = [("cudaLaunchKernel", 2150, 2160, 1),
             ("cudaStreamSynchronize", 3000, 3500, 0),
             ("cudaLaunchKernel", 3600, 3610, 2)]
    got = ps.idle_by_program_span(merge_intervals([(0, 3200), (3400,
                                                                10_000)]),
                                  calls, PROGRAM, HARNESS, WINDOW)
    assert dict(got) == {"join/cudaStreamSynchronize": 200}
    assert ps.credit(ops, calls, PROGRAM, HARNESS, WINDOW)["busy"] == {
        "join": 3200 + 6600}


def test_spans_lookup_walks_out_of_ended_children():
    s = ps.Spans(PROGRAM, nested=True)
    assert [s.name_at(t) for t in (50, 150, 950, 1950, 2050, 4700, 4850,
                                   5001)] == [
        None, "cbl.dynamic_round", "cbl.dynamic_round", "sort",
        "cbl.dynamic_round", "sync.n", "index", None]
    assert s.within(s.at(4700), "sync.") and not s.within(s.at(4850),
                                                           "sync.")
    open_span = ps.Spans([("cbl.x", 10, None, -1, 1)], nested=True)
    assert open_span.name_at(10 ** 12) == "cbl.x"
    loop = ps.Spans([("a", 10, 20, 1, 1), ("b", 12, 14, 1, 1)], nested=True)
    assert loop.name_at(13) == "b" and loop.name_at(16) is None  # ends


def _holder(program):
    return types.SimpleNamespace(ops=OPS, calls=CALLS, program=program,
                                 spans=HARNESS)


def test_report_reads_zero_for_a_span_that_never_ran_and_none_without_spans():
    groups = kernels.Groups()
    r = ps.report(_holder(PROGRAM), WINDOW, 2, groups)
    assert r["metrics"]["span_words_ms"] == pytest.approx(1000 * 1e-6 / 2)
    assert r["metrics"]["host_wait_ms"] == pytest.approx(920 * 1e-6 / 2)
    no_join = [("cbl.x", *s[1:]) if s[0] == "join" else s for s in PROGRAM]
    r = ps.report(_holder(no_join), WINDOW, 2, groups)
    assert r["metrics"]["span_join_ms"] == 0.0
    r = ps.report(_holder([]), WINDOW, 2, groups)
    assert set(r["metrics"].values()) == {None}
    assert r["credited_pct"] == pytest.approx(100 * (1 - 100 / 3100))


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("name", CELLS)
def test_the_window_on_the_cpu_path(name, record):
    r = ps.run(tiny_cell(name), 2**31 + 11, 0.3, CPU, record=record,
               profile=False)
    assert r["correct"] and r["batches"] > 0
    assert (r["spans_recorded"] > 0) == record
    assert r["folds_per_batch"] is not None
    if "window" in name:
        assert r["counters"]["rounds"] == 1.0
