"""The busy and idle arithmetic on made-up intervals."""

import pytest

from benchmark import trace


def test_union_is_not_the_sum():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert trace.union_length(ivs, 0.0, 5.0) == pytest.approx(3.0)
    assert sum(e - s for s, e in ivs) == pytest.approx(3.5)


def test_union_clips_to_the_window():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert trace.union_length(ivs, 0.5, 3.5) == pytest.approx(2.0)
    assert trace.union_length([(6.0, 7.0)], 0.0, 5.0) == 0.0
    assert trace.union_length([], 0.0, 5.0) == 0.0


def test_nested_and_touching_intervals():
    ivs = [(1.0, 4.0), (2.0, 3.0), (4.0, 5.0)]
    assert trace.union_length(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.gaps(ivs, 0.0, 10.0) == [(0.0, 1.0), (5.0, 10.0)]


def test_gaps_complement_the_union():
    ivs = [(0.2, 0.3), (0.25, 0.6), (0.9, 1.5)]
    lo, hi = 0.0, 1.2
    idle = sum(e - s for s, e in trace.gaps(ivs, lo, hi))
    assert idle + trace.union_length(ivs, lo, hi) == pytest.approx(hi - lo)


def test_gaps_are_labelled_by_the_innermost_open_host_range():
    host = [(0.0, 10.0, "round"), (1.0, 3.0, "aten::item"), (5.0, 5.5, "aten::mm")]
    gap_list = [(2.0, 2.5), (6.0, 7.0), (11.0, 12.0)]
    assert trace.label_gaps(gap_list, host) == {"aten::item": 0.5, "round": 1.0, "after round": 1.0}
    assert trace.label_gaps([(0.5, 1.0)], [(1.0, 2.0, "aten::mm")]) == {"host": 0.5}


def test_top_orders_by_seconds():
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_idle_share_of_the_stretch():
    assert trace.idle_pct({"busy_s": 3.0, "trace_window_s": 4.0}) == pytest.approx(25.0)
    assert trace.idle_pct({}) is None
