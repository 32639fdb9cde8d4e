"""Kernel-name classification and the per-layer metric arithmetic on a
synthetic trace."""

import types

import pytest

from kmerbench import kernels, spec
from kmerbench.trace import HBM_BYTES_PER_S, TraceView, merge_intervals

NAMES = {
    "(anonymous namespace)::necklace_pos_kernel(long long const*, long long*, int*, long long, int)": "B1",
    "(anonymous namespace)::necklace_pos_wide_kernel(long long const*, long long const*)": "B1",
    "cbl::(anonymous namespace)::blank_lookback(int const*, int*, long long)": "B2",
    "void cbl::(anonymous namespace)::merge_tiles<1>(cbl::(anonymous namespace)::Cols<1>)": "B3",
    "void cbl::(anonymous namespace)::merge_tiles<3>(cbl::(anonymous namespace)::Cols<3>)": "B3",
    "void cbl::(anonymous namespace)::partition<1>(cbl::(anonymous namespace)::Cols<1>)": "B3",
    "cbl::(anonymous namespace)::slog_lookback(long long const*, long long, int)": "B4",
    "void cbl::(anonymous namespace)::slog_tag_lookback<3>(cbl::SlogCols<3>)": "B4",
    "void cbl::(anonymous namespace)::tile_sort_keyed<3>(cbl::Cols<3>)": "B5",
    "void cbl::(anonymous namespace)::multiway_partition<1>(cbl::Cols<1>)": "B5",
    "void cbl::(anonymous namespace)::merge_multi<2>(cbl::Cols<2>)": "B5",
    "void cbl::(anonymous namespace)::keyed_cross<1>(cbl::MutKeys<1>)": "B6",
    "void cbl::(anonymous namespace)::merge_tile<1>(cbl::Cols<1>)": "B7",
    "void cbl::(anonymous namespace)::tile_coranks<2>(cbl::Cols<2>)": "B7",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<long>>": "library_sort",
    "void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<long>": "library_sort",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<bool>>": None,
    "void at_cuda_detail::cub::DeviceScanKernel<long>": None,
    "Memcpy DtoH (Device -> Pinned)": None,
    "Memset (Device)": None,
}


GROUPS = kernels.Groups()


@pytest.mark.parametrize("name,group", NAMES.items())
def test_kernel_groups(name, group):
    assert GROUPS.group_of(name) == group


def test_groups_are_declared_in_the_metric_files_that_read_them():
    where = {g: m for m in spec.names("metrics")
             for g in getattr(spec.module("metrics", m), "GROUPS", {})}
    assert where == {"B1": "necklace_ms", "B2": "necklace_ms",
                     "B3": "merge_ms", "B4": "merge_ms", "B7": "merge_ms",
                     "B5": "sort_ms", "B6": "sort_ms",
                     "library_sort": "sort_ms", "B8": "probe_ms"}
    assert GROUPS.launched({"necklace_wide": 2, "blank": 1, "x": 5}, "B1") == 2


def _view(ops, spans=(), launches=None, batches=4):
    # each op with a correlation id of its own; no call, no program span
    trace = types.SimpleNamespace(ops=[(*o, i) for i, o in enumerate(ops)],
                                  spans=list(spans), calls=[], program=[])
    return TraceView.build(trace, (0, 1000), batches=batches, port_s=0.002,
                           latencies_s=[0.001 * i for i in range(1, 101)],
                           least_bytes=HBM_BYTES_PER_S * 1e-7,
                           launches=launches or {}, groups=GROUPS)


OPS = [
    ("necklace_pos_kernel(x)", 100, 200),
    ("void cbl::(anonymous namespace)::merge_tiles<1>(y)", 150, 300),
    ("DeviceRadixSortOnesweepKernel<z>", 400, 500),
    ("Memset (Device)", 600, 620),
    ("elementwise_kernel<w>", -50, 20),  # clipped to the window's start
    ("late_kernel", 990, 1500),  # clipped to its end
    ("outside", 2000, 2100),  # dropped
]
SPANS = [("port.query_codes_stream", 0, 320), ("harness.wait", 500, 990)]


def _read(metric, view):
    return spec.reader(metric)(view)


def test_metric_arithmetic():
    v = _view(OPS, SPANS, {"necklace": 1})
    assert merge_intervals([(5, 9), (0, 2), (1, 3)]) == [[0, 3], [5, 9]]
    assert v.busy() == [[0, 20], [100, 300], [400, 500], [600, 620],
                        [990, 1000]]
    assert v.busy_s == pytest.approx(350e-9)
    assert v.window_s == pytest.approx(1000e-9)
    ms = 1e3 * 1e-9 / 4
    assert _read("necklace_ms", v) == pytest.approx(100 * ms)  # B1 + B2
    assert _read("merge_ms", v) == pytest.approx(150 * ms)
    assert _read("sort_ms", v) == pytest.approx(100 * ms)
    assert _read("torch_ops_ms", v) == pytest.approx((20 + 20 + 10) * ms)
    assert _read("launches_per_batch", v) == pytest.approx(6 / 4)
    assert _read("device_idle_pct", v) == pytest.approx(65.0)
    assert _read("enqueue_ms", v) == pytest.approx(0.5)
    assert _read("kernels_roofline", v) == pytest.approx(
        100 * 1e-7 / (350e-9 / 4))
    idle = v.idle_by_span()
    assert idle["port.query_codes_stream"] == pytest.approx(80e-9)
    assert idle["harness.wait"] == pytest.approx(100e-9 + 370e-9)
    assert idle["harness"] == pytest.approx(100e-9)
    b = v.breakdown()
    assert b["device_ops"][0] == [OPS[1][0], pytest.approx(1.5e-7)]
    assert len(b["device_ops"]) == 6 and len(b["idle_gaps"]) == 3


def test_nothing_to_read_is_left_out_not_zero():
    v = _view([], batches=4)
    for m in ("necklace_ms", "sort_ms", "merge_ms", "torch_ops_ms",
              "kernels_roofline", "launches_per_batch", "device_idle_pct"):
        assert _read(m, v) is None


def test_a_launched_group_that_reads_no_time_is_an_error():
    v = _view([("renamed_kernel", 0, 10)], launches={"merge_3col": 3})
    with pytest.raises(RuntimeError, match="B3"):
        _read("merge_ms", v)


def test_the_query_cell_needs_no_particular_join():
    """`query_reads` names the kernels that run whichever join the port
    picks for a clean index (the words, the blanking, the query's sort),
    and the join's own groups are read only where they are listed."""
    mix = spec.cell(spec.load(), "k25_p24.query_reads").mix
    assert mix["kernels"] == ["B1", "B2", "B5"]
    words_and_sort = {"necklace": 1, "blank": 1, "sort": 1}
    for join in ({"merge": 1}, {"probe": 1}):  # B3 or B8
        assert GROUPS.missing({**words_and_sort, **join}, mix["kernels"]) == 0
    assert GROUPS.missing({**words_and_sort, "probe": 1},
                          ["B1", "B2", "B3"]) == 1
    per_layer = {m["name"]: m for m in spec.load()["per_layer"]}
    assert "k25_p24.query_reads" not in per_layer["merge_ms"]["workloads"]
    assert "k25_p24.query_reads" in per_layer["span_join_ms"]["workloads"]
