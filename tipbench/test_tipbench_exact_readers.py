"""CPU tests of the readers of ``count_s.decompose`` and
``wide_mb.decompose``: a traced small cell reports both, and each gives
None without the window or without the program's span and counter, as a
program that lacks them does."""
import time
from pathlib import Path

import pytest

from tipbench import harness

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("count_s.decompose", "wide_mb.decompose")


def _run_of(stats_list):
    return {"records": [{"round_trips": int(s.host_round_trips),
                         "time_count": float(s.time_count),
                         "time_cd": float(s.time_cd),
                         "time_fd": float(s.time_fd)}
                        for s in stats_list]}


def _stats(k, counted=True):
    from repro_torch.core.engine import RunStats

    s = RunStats(host_round_trips=k, time_cd=0.5 * k)
    if counted:
        s.trace.add("count", 0.25 * k)
        s.trace.wide_bytes = 2_000_000 * k
    return s


@pytest.mark.parametrize("cell", ["chunglu_marvel.decompose",
                                  "chunglu_youtube_groups.decompose"])
def test_a_traced_small_cell_reports_both(cell):
    spec = harness.load_cell(cell)
    assert [m["name"] for m in spec["per_layer"]
            if m["name"] in NAMES] == list(NAMES)
    spec["config"] = dict(spec["config"], n_u=40, n_v=50, m=220)
    spec["traffic"] = dict(spec["traffic"], pool=4)
    r = harness.run_cell(spec, 2 ** 31 + 31, 0.01, True, "cpu",
                         time.perf_counter(), log=lambda *a, **k: None)
    assert r["correct"] is True
    m = r["metrics"]
    assert m["count_s.decompose"]["value"] > 0
    assert m["wide_mb.decompose"]["value"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_reads_the_window_or_none(name):
    from repro_torch.utils import spans

    spans.clear_recent_runs()
    runs = [_stats(1), _stats(2)]
    run = _run_of(runs)
    read = harness._reader(ROOT, name)
    assert read(run) is None
    assert read({"records": []}) is None
    for s in runs:
        spans.note_run(s)
    assert read(run) == {"count_s.decompose": 0.375,
                         "wide_mb.decompose": 3.0}[name]
    spans.clear_recent_runs()


def test_count_s_is_none_where_no_run_has_the_span():
    from repro_torch.utils import spans

    spans.clear_recent_runs()
    runs = [_stats(1, counted=False), _stats(2, counted=False)]
    for s in runs:
        spans.note_run(s)
    assert harness._reader(ROOT, "count_s.decompose")(_run_of(runs)) is None
    spans.clear_recent_runs()
