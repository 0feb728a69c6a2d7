"""The roofline counts on hand-worked shapes."""

import pytest

from benchmark.roofline import voting as RV


def test_full_g6_table_is_bound_by_operations():
    # 20,608 rows, 4,096 points, 804 active
    b = 4096 * 12 + 4096 + 20608 * 24 + 12 + 20608 * 12
    assert RV.launch_bytes(20608, 4096) == b == 795_148
    assert RV.launch_ops(20608, 804) == 24 * 20608 * 804 == 397_651_968
    sec, kind = RV.least_seconds(20608, 4096, 804)
    assert kind == "operations"
    assert sec == pytest.approx(397_651_968 / 33.5e12, rel=1e-12)


def test_few_rows_and_no_active_points_are_bound_by_bytes():
    # 256 gathered rows with nothing active: the inputs and outputs alone
    sec, kind = RV.least_seconds(256, 4096, 0)
    assert kind == "bytes"
    assert sec == pytest.approx((4096 * 13 + 256 * 36 + 12) / 3.35e12, rel=1e-12)


def test_least_total_sums_the_launches():
    launches = [(20608, 4096, 804), (256, 4096, 804)]
    want = RV.least_seconds(20608, 4096, 804)[0] + RV.least_seconds(256, 4096, 804)[0]
    assert RV.least_total(launches) == pytest.approx(want)
