"""A run's result line, driven on the CPU at a small size."""
import json
import time

from cudabench import run


def test_result_line_shape(small):
    res = run.measure(small, 2**31 + 101, 1.0, False, "cpu",
                      time.perf_counter())
    json.dumps(res)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {m["name"] for m in small.end_to_end} == set(res["metrics"])
    for name, m in res["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # the kernel build, recorded apart from set-up (none on the CPU)
    assert res["build_s"] == 0.0


def test_traced_result_line_shape(small):
    res = run.measure(small, 5, 1.0, True, "cpu", time.perf_counter())
    assert list(res)[-1] == "checks"
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    names = {s["name"] for s, _ in small.per_layer}
    # the CPU runs no kernel: the device readers find nothing to read
    assert set(res["metrics"]) <= names
    assert "walk_ms.colony" not in res["metrics"]
