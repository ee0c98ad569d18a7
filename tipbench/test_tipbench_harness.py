"""CPU tests of the harness: a cell runs end to end at a small size and
comes out correct; each fault a cell can have makes it come out not
correct; the control does; and a new configuration, traffic mix and
per-layer metric come in as new files, with no existing file edited."""
import filecmp
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from tipbench import control, harness

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_u": 40, "n_v": 50, "m": 220}
# the cells by short label (test ids)
CELLS = {"marvel.decompose": "chunglu_marvel.decompose",
         "marvel.refresh": "chunglu_marvel.refresh",
         "condmat.decompose": "chunglu_condmat.decompose"}


def _spec(cell, root=ROOT, **traffic):
    spec = harness.load_cell(CELLS.get(cell, cell), root=root)
    spec["config"] = dict(spec["config"], **SMALL)
    spec["traffic"] = dict(spec["traffic"], pool=4, cycles=8, **traffic)
    return spec


def _run(spec, traced=False, seed=2 ** 31 + 11):
    return harness.run_cell(spec, seed, 0.01, traced, "cpu",
                            time.perf_counter(), log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", ["marvel.decompose", "marvel.refresh",
                                  "condmat.decompose"])
def test_a_small_cell_runs_correct(cell):
    r = _run(_spec(cell))
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", json.loads(
        (ROOT / "tipbench" / "traffic" / f"{cell.split('.')[1]}.json")
        .read_text())["metric"]}
    assert list(r)[-1] == "checks"
    assert list(r["checks"]) == ["failed_requests", "theta_mismatches",
                                 "max_support"]
    assert r["checks"]["theta_mismatches"] == {"value": 0, "limit": 0}
    # no configuration states an exact limit: the float32 regime's
    assert "exact_limit" not in _spec(cell)["config"]
    assert r["checks"]["max_support"]["limit"] == 2 ** 24 - 1 == 16777215


@pytest.mark.parametrize("cell", ["marvel.decompose", "marvel.refresh"])
def test_a_traced_small_cell_reports_its_program_metrics(cell):
    r = _run(_spec(cell), traced=True)
    assert r["correct"] is True
    names = set(r["metrics"])
    if cell.endswith("decompose"):
        assert {"plan_ms.decompose", "cd_s.decompose", "fd_s.decompose",
                "round_trips.decompose"} <= names
    else:
        assert {"delta_share.refresh", "round_trips.refresh"} <= names
        assert r["metrics"]["delta_share.refresh"]["value"] == 100.0
    # device metrics read nothing on the CPU, and are left out
    assert not any(n.startswith(("device_idle", "kernel_roofline"))
                   for n in names)
    assert "window_s" in r["device"] and "breakdown" in r


def _decompose_fault(monkeypatch, kind):
    from repro_torch.api.executor import Executor

    real = Executor.decompose
    first = []

    def broken(self, graph, plan=None, **kw):
        td = real(self, graph, plan=plan, **kw)
        if kind == "altered":
            td.theta = td.theta.copy()
            td.theta[np.argmax(td.theta)] += 1
        elif kind == "unchanged":
            if first:
                td.theta = first[0].copy()
            first.append(td.theta.copy())
        return td

    monkeypatch.setattr(Executor, "decompose", broken)


def _refresh_fault(monkeypatch, kind):
    from repro_torch.service import DecompositionService
    from repro_torch.service import scheduler

    real = scheduler.refresh_dataset
    if kind == "half_batch":
        monkeypatch.setattr(DecompositionService, "insert_edges",
                            lambda self, name, eu, ev: None)
        return

    def broken(ds, executor, scfg, *, force_full=False):
        if kind == "unchanged" and ds.result is not None and not force_full:
            ds.result_version = ds.version      # served as fresh, unchanged
            ds.base_graph = ds.graph
            return None
        stats = real(ds, executor, scfg, force_full=force_full)
        if kind == "altered" and ds.result_version > 1:
            ds.result.theta = ds.result.theta.copy()
            ds.result.theta[np.argmax(ds.result.theta)] += 1
        return stats

    monkeypatch.setattr(scheduler, "refresh_dataset", broken)


@pytest.mark.parametrize("cell,kind", [
    ("marvel.decompose", "altered"),
    ("marvel.decompose", "unchanged"),
    ("marvel.refresh", "altered"),
    ("marvel.refresh", "unchanged"),
    ("marvel.refresh", "half_batch"),
])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, cell, kind):
    """The run with the timed path broken underneath: an answer altered
    where it is produced, a step that returns its state unchanged (the
    previous graph's numbers, a flush that refreshes nothing) and half of
    each batch left out (the insertions)."""
    if cell.endswith("decompose"):
        _decompose_fault(monkeypatch, kind)
    else:
        _refresh_fault(monkeypatch, kind)
    r = _run(_spec(cell, warm=1))
    assert r["correct"] is False
    assert r["checks"]["theta_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["marvel.decompose", "marvel.refresh"])
def test_the_bfloat16_control_comes_out_not_correct(cell):
    """The reference in the program's place, in bfloat16, on three seeds:
    every seed reads mismatches above the limit 0 that sound runs meet."""
    spec = _spec(cell)
    spec["config"] = dict(spec["config"], n_u=60, n_v=80, m=500)
    for seed in (1, 2, 3):
        numbers = control.control_readings(spec, seed, 3, "cpu")
        assert numbers["theta_mismatches"]["value"] > \
            numbers["theta_mismatches"]["limit"]


def test_new_config_mix_and_metric_come_from_new_files(tmp_path):
    """A copy of the benchmark's folders takes a configuration, a traffic
    mix and a per-layer metric as new files and new entries in
    ``BENCHMARK.json``, and runs the new cell with no existing file of the
    folders edited."""
    shutil.copytree(ROOT / "tipbench", tmp_path / "tipbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "tipbench/configs/chunglu_marvel.json")
                     .read_text())
    cfg.update(name="tiny", n_u=30, n_v=40, m=150)
    (tmp_path / "tipbench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "tipbench/traffic/decompose_twice.json").write_text(
        json.dumps({"loop": "decompose", "metric": "decompose_s",
                    "pool": 2, "warm": 2, "check_answers": 8,
                    "trace_seconds": 60}))
    (tmp_path / "tipbench/metrics/requests.tiny.py").write_text(
        "def read(run):\n    return len(run['records'])\n")
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "tipbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.decompose_twice",
                               "config": "tiny",
                               "traffic": "decompose_twice", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "decompose_s":
            m["workloads"].append("tiny.decompose_twice")
    bench["per_layer"].append({"name": "requests.tiny", "unit": "requests",
                               "better": "higher",
                               "source": "program_counter", "layer": "api",
                               "moves": "decompose_s",
                               "workloads": ["tiny.decompose_twice"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.load_cell("tiny.decompose_twice", root=tmp_path)
    assert spec["config"]["n_u"] == 30 and spec["traffic"]["warm"] == 2
    timed = harness.run_cell(spec, 4, 0.01, False, "cpu",
                             time.perf_counter(), log=lambda *a, **k: None)
    traced = harness.run_cell(spec, 4, 0.01, True, "cpu",
                              time.perf_counter(), log=lambda *a, **k: None)
    assert timed["correct"] and traced["correct"]
    assert set(timed["metrics"]) == {"setup_s", "decompose_s"}
    assert traced["metrics"]["requests.tiny"]["value"] >= 1
    assert "plan_ms.decompose" not in traced["metrics"]
    cmp = filecmp.dircmp(ROOT / "tipbench", tmp_path / "tipbench",
                         ignore=["out", "__pycache__"])
    stack = [cmp]
    while stack:
        d = stack.pop()
        assert d.diff_files == [] and d.left_only == []
        stack.extend(d.subdirs.values())


def _with_configs(tmp_path, configs):
    """A copy of the benchmark's folders with each of ``configs`` (name to
    the keys it changes in Marvel's file) as a new file, and a cell
    ``<name>.decompose`` of it, as new entries in ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "tipbench", tmp_path / "tipbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "tipbench/configs/chunglu_marvel.json")
                      .read_text())
    for name, keys in configs.items():
        (tmp_path / f"tipbench/configs/{name}.json").write_text(
            json.dumps(dict(base, name=name, **keys)))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"tipbench/configs/{name}.json",
                                 "reduced": [], "why": "a test"})
        bench["workloads"].append({"name": f"{name}.decompose",
                                   "config": name, "traffic": "decompose",
                                   "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("limit,loads", [
    (2 ** 25, True), (2 ** 53, True), (2 ** 53 + 1, False),
    (2 ** 64, False), (0, False), (2.0 ** 30, False), (True, False)])
def test_a_configuration_states_its_exact_limit(tmp_path, limit, loads):
    """A stated limit, a whole number up to 2^53, reaches the check; one
    past what the float64 reference holds exactly is refused at load."""
    _with_configs(tmp_path, {"stated": {"exact_limit": limit}})
    if not loads:
        with pytest.raises(harness.CellError, match="exact_limit"):
            harness.load_cell("stated.decompose", root=tmp_path)
        return
    spec = harness.load_cell("stated.decompose", root=tmp_path)
    spec["config"] = dict(spec["config"], **SMALL)
    spec["traffic"] = dict(spec["traffic"], pool=2)
    r = _run(spec)
    assert r["correct"] is True
    assert r["checks"]["max_support"]["limit"] == limit - 1


@pytest.mark.parametrize("stated", [True, False])
def test_a_graph_past_2_24_is_correct_only_under_a_stated_limit(
        tmp_path, monkeypatch, stated):
    """K_{2,6000}: both supports are C(6000, 2) = 17,997,000 > 2^24.  With
    the reference's own answers in the program's place, as the control
    puts its own, the check comes out correct under a configuration
    (new files only) that states a larger limit, and not correct on
    ``max_support`` under one without the key."""
    from tipbench import loops

    keys = {"n_u": 2, "n_v": 6000, "m": 12000}
    if stated:
        keys.update(exact_limit=2 ** 53, precision="a test: exact below "
                    "2^53 (DESIGN.md, the section that says so)")
    _with_configs(tmp_path, {"k2_6000": keys})
    spec = harness.load_cell("k2_6000.decompose", root=tmp_path)
    loop = loops.LOOPS["decompose"](spec["config"],
                                    dict(spec["traffic"], pool=2),
                                    2 ** 31 + 5, "cpu")
    k26 = (np.repeat(np.arange(2), 6000), np.tile(np.arange(6000), 2))
    monkeypatch.setattr(loop, "draw", lambda seed: k26)
    loop.prepare()
    got = {k: loop.expected(k)[0] for k in range(2)}
    assert got[0].tolist() == [17997000, 17997000]
    numbers = harness.check(loop, [0, 1], answer_of=got.get)
    assert numbers["theta_mismatches"] == {"value": 0, "limit": 0}
    assert numbers["max_support"] == {
        "value": 17997000,
        "limit": (2 ** 53 if stated else 2 ** 24) - 1}
    assert harness.passes(numbers) is stated


def test_roofline_divides_by_the_device_time_inside_the_wrapped_calls():
    """The probe's time is that of the device operations launched inside
    a wrapped call's host range, by the host time of their launch
    (whatever the device's clock says of their interval): not the host's
    time in the entry point, and no operation launched outside a call."""
    from tipbench import trace

    dev = [(13, 23, "a", 1), (28, 43, "b", 2), (44, 53, "c", 3),
           (73, 83, "d", 4), (98, 102, "e", 5), (99, 100, "f", 6)]
    launched = {1: 9, 2: 11, 3: 41, 4: 66, 5: 91}
    calls = [(65, 90), (5, 42)]
    assert trace.inside(dev, calls, launched) == pytest.approx(44e-9)
    assert trace.inside(dev, [], launched) == 0.0


def test_busy_time_is_the_union_of_the_device_operations():
    from tipbench import trace

    name = "void (anonymous namespace)::peel_update_kernel<128>(float*)"
    busy_s, ops = trace.busy([(0, 10, name), (5, 20, name),
                              (30, 40, "Memcpy HtoD (Pageable -> Device)")])
    assert busy_s == pytest.approx(30e-9)
    assert ops[0] == ("peel_update_kernel", pytest.approx(25e-9))
    gaps = trace.idle_gaps([(0, 10, "k"), (30, 40, "k")],
                           [(5, 45, "tipbench.flush", 1),
                            (12, 28, "aten::item", 1)], 0)
    assert dict(gaps) == {"tipbench.flush/aten::item": pytest.approx(20e-9),
                          "tipbench.flush": pytest.approx(5e-9)}


def test_idle_share_sets_traced_busy_time_against_untraced_walls():
    """Busy 3 s over two traced requests against untraced requests of
    6 s: 75% idle, whatever the traced requests' own (slowed) walls."""
    from tipbench import trace

    records = [{"request_s": 9.0}, {"request_s": 9.0}, {"request_s": 5.0},
               {"request_s": 7.0}]
    run = {"device": "cuda", "busy_s": 3.0, "traced_requests": 2,
           "records": records}
    assert trace.idle_share(run) == pytest.approx(75.0)
    assert trace.idle_share(dict(run, records=records[:2])) is None
    assert trace.idle_share(dict(run, device="cpu")) is None
