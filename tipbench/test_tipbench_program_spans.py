"""CPU tests of the readers of the program's own spans and counters
(``tipbench/program_spans.py`` and the metrics that use it): a traced
small cell reports them, and a reader gives None when the program's
recent runs do not hold the window."""
import time
from pathlib import Path

import pytest

from tipbench import harness, program_spans

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_u": 40, "n_v": 50, "m": 220}
DECOMPOSE = ("dgm_s.decompose", "upload_mb.decompose",
             "read_wait_s.decompose")
REFRESH = ("route_ms.refresh", "delta_s.refresh", "repeel_s.refresh",
           "read_wait_s.refresh")


def _traced(cell):
    spec = harness.load_cell(cell)
    spec["config"] = dict(spec["config"], **SMALL)
    spec["traffic"] = dict(spec["traffic"], pool=4, cycles=8)
    return harness.run_cell(spec, 2 ** 31 + 23, 0.01, True, "cpu",
                            time.perf_counter(), log=lambda *a, **k: None)


@pytest.mark.parametrize("cell,names", [
    ("chunglu_marvel.decompose", DECOMPOSE),
    ("chunglu_marvel.refresh", REFRESH)])
def test_a_traced_small_cell_reports_the_program_spans(cell, names):
    r = _traced(cell)
    assert r["correct"] is True
    m = r["metrics"]
    for name in names:
        assert name in m and m[name]["value"] >= 0, name
    if cell.endswith("decompose"):
        assert m["upload_mb.decompose"]["value"] > 0
        assert (m["dgm_s.decompose"]["value"]
                + m["read_wait_s.decompose"]["value"]
                <= m["cd_s.decompose"]["value"]
                + m["fd_s.decompose"]["value"])
    else:
        assert m["repeel_s.refresh"]["value"] > 0


def _run_of(stats_list):
    return {"records": [{"round_trips": int(s.host_round_trips),
                         "time_count": float(s.time_count),
                         "time_cd": float(s.time_cd),
                         "time_fd": float(s.time_fd)}
                        for s in stats_list]}


def _stats(k):
    from repro_torch.core.engine import RunStats

    s = RunStats(host_round_trips=k, time_cd=0.5 * k)
    s.trace.add("read", float(k))
    return s


def test_the_window_is_the_latest_matching_stretch_of_recent_runs():
    from repro_torch.utils import spans

    spans.clear_recent_runs()
    runs = [_stats(k) for k in (1, 2, 3, 2, 3, 4)]
    for s in runs:
        spans.note_run(s)
    got = program_spans.window_runs(_run_of([runs[1], runs[2]]))
    assert got[0] is runs[3] and got[1] is runs[4]
    assert program_spans.mean(_run_of(runs[3:5]),
                              program_spans.seconds("read")) == 2.5
    assert program_spans.mean(_run_of(runs[3:5]),
                              program_spans.seconds("none")) == 0.0
    # a window the ring does not hold in order: no reading
    assert program_spans.window_runs(_run_of([runs[5], runs[0]])) is None
    spans.clear_recent_runs()


@pytest.mark.parametrize("name", DECOMPOSE + REFRESH)
def test_each_reader_gives_none_without_the_window(name):
    from repro_torch.utils import spans

    spans.clear_recent_runs()
    run = _run_of([_stats(1), _stats(2)])
    assert harness._reader(ROOT, name)(run) is None
    assert harness._reader(ROOT, name)({"records": []}) is None
    for s in (_stats(1), _stats(2)):
        spans.note_run(s)
    assert harness._reader(ROOT, name)(run) is not None
    spans.clear_recent_runs()


def test_the_refresh_spans_lie_inside_each_cycles_flush():
    """Per cycle, ``flush.route + refresh.delta + refresh.repeel`` (in
    seconds) is at most the flush's wall on the harness's clock, and the
    reads on the cycle's run are the served result's round trips."""
    import torch

    from tipbench import loops

    spec = harness.load_cell("chunglu_marvel.refresh")
    cfg = dict(spec["config"], **SMALL)
    loop = loops.RefreshLoop(cfg, dict(spec["traffic"], cycles=6), 5,
                             torch.device("cpu"))
    loop.prepare()
    loop.setup()
    for _ in range(4):
        loop.timed()
        runs = program_spans.window_runs({"records": loop.records[-1:]})
        sec = runs[0].trace.seconds
        assert (sec["flush.route"] + sec["refresh.delta"]
                + sec["refresh.repeel"]) <= loop.records[-1]["flush_s"]
        assert runs[0].trace.calls["read"] == loop.records[-1]["round_trips"]
    loop.release()
