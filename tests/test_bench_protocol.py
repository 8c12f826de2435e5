"""Contract tests for bench.py's measurement protocol layer: one JSON
line on stdout, a time budget with recorded skips, latency forensics, the
drift metric — pure host logic, no device, no jax."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench


class TestSnapshotJson:
    def _args(self, config=0):
        class A:
            pass

        a = A()
        a.config = config
        return a

    def test_single_line_valid_json(self):
        results = {
            1: {"name": "cfg1", "fps_per_chip": 100.0,
                "vs_baseline": 10.0, "p50_latency_ms": 5.0},
            2: {"name": "cfg2", "error": "boom"},
        }
        s = bench.snapshot_json(results, self._args())
        assert "\n" not in s
        d = json.loads(s)
        assert d["value"] == 100.0
        assert d["unit"] == "fps"
        assert set(d["configs"]) == {"1", "2"}

    def test_headline_follows_config_flag(self):
        results = {3: {"name": "cfg3", "fps_per_chip": 50.0,
                       "vs_baseline": 5.0}}
        d = json.loads(bench.snapshot_json(results, self._args(config=3)))
        assert d["value"] == 50.0
        assert "cfg3" in d["metric"]


class TestBudget:
    def test_reserves_for_remaining_configs(self):
        b = bench.Budget(10_000)
        assert b.have(100, n_left=0)
        # 10_000 - (300*30 + 60) = 940 < 1000
        assert not b.have(1000, n_left=30)

    def test_section_records_skip_reason(self):
        bench.BUDGET = bench.Budget(10)     # nearly exhausted budget
        result = {}
        out = bench.section(result, "expensive_thing", 500, 4, lambda: 1)
        assert out is None
        assert any("expensive_thing" in s for s in result["skipped"])

    def test_section_runs_and_returns(self):
        bench.BUDGET = bench.Budget(100_000)
        result = {}
        assert bench.section(result, "cheap", 1, 0, lambda x: x + 1, 41) == 42
        assert "skipped" not in result

    def test_section_failure_is_recorded_not_raised(self):
        bench.BUDGET = bench.Budget(100_000)
        result = {}

        def boom():
            raise RuntimeError("nope")

        assert bench.section(result, "fragile", 1, 0, boom) is None
        assert any("fragile" in s for s in result["skipped"])


class TestLatencyStats:
    def test_stall_forensics(self):
        lat = np.full(100, 10.0)
        lat[7] = 400.0                       # one host stall
        stats = bench._latency_stats(lat)
        assert stats["p50"] == 10.0
        assert "1/100" in stats["note"] and "sample 7" in stats["note"]
        assert stats["p99_excl_stalls"] == pytest.approx(10.0)

    def test_clean_window_has_no_note(self):
        stats = bench._latency_stats(np.full(50, 20.0))
        assert "note" not in stats


class TestCornerDrift:
    def test_identity_zero(self):
        hs = [np.eye(3)] * 10
        assert bench.corner_drift(hs, hs, 64, 48) == 0.0

    def test_translation_measures_pixels(self):
        # |dx|=2 on every corner, |dy|=0; the metric averages both
        # coordinate components -> 1.0
        t = np.eye(3)
        t[0, 2] = 2.0
        hs_a = [np.eye(3)] * 10
        hs_b = [t] * 10
        assert bench.corner_drift(hs_a, hs_b, 64, 48) == pytest.approx(1.0)
