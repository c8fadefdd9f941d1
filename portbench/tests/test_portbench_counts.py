"""Each configuration's stored counts equal a recount on the frozen plain
copy at one world (``python -m portbench.counts`` rewrites them)."""

import pytest

from portbench.counts import bound_s, count_config
from portbench.registry import Benchmark

BENCH = Benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH.spec["configs"]])
def test_stored_counts_equal_a_recount(name):
    cfg = BENCH.config(name)
    assert cfg["counts"] == count_config(cfg)


def test_bound_names_what_binds():
    assert bound_s(67e12, 0.0) == (1.0, "operations")
    assert bound_s(0.0, 3.35e12) == (1.0, "bytes")
