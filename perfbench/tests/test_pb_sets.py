"""sets.py reads the spreads of a cell's runs as the bounds are set:
the interquartile distance over the median, per set, without the run
farthest from the median, and over all runs."""

import pytest

from perfbench import sets


def rows(values):
    return [{"set": s, "seed": i, "rc": 0,
             "result": {"correct": True,
                        "metrics": {"step_ms": {"value": v, "unit": "ms"}}}}
            for s, vs in values.items() for i, v in enumerate(vs)]


def test_spread():
    v = [10.0, 10.1, 10.2, 10.3, 10.4, 10.5]
    q1, _, q3 = __import__("statistics").quantiles(v, n=4)
    assert sets.spread(v) == pytest.approx((q3 - q1) / 10.25)
    assert sets.without_farthest([10.0, 10.1, 10.2, 13.0, 10.15]) == \
        [10.0, 10.1, 10.2, 10.15]


def test_read_prints_each_set(capsys):
    sets.read(rows({1: [10.0, 10.1, 10.2, 10.3, 10.4, 10.5],
                    2: [10.2, 10.3, 10.2, 10.3, 10.4, 10.6]}))
    out = capsys.readouterr().out
    assert "runs 12" in out and "all correct True" in out
    assert "set 1 median 10.25" in out and "set 2 median 10.3" in out
    assert "last / first median 1.00488" in out
