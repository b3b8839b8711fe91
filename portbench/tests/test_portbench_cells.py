"""The harness driven end to end on the CPU at tiny sizes (its look for a
card skipped): each cell proves correct against the plain reference, the
plain reference agrees with the program's CPU path, the float32 control
and every fault a cell can have come out not correct, and a cell made of
added files alone (configuration, traffic, metric reader, entries) runs
with no edit to a file that is there.  The held-out cells
(``portbench/held_out/``) run from a checkout whose ``BENCHMARK.json``
gains their entries."""

import contextlib
import json
import shutil
import time

import pytest
import torch

from portbench import harness
from portbench.compare import gaps
from portbench.control import ETA_FAULTS
from portbench.harness import ROOT, load_module

TINY = {
    "pol2d-n256-screen32": ({"N": 8, "dt": 0.0025}, {"members": 4}),
    "expsin3d-n128-level": ({"N": 8, "dt": 0.005}, {}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the held-out cells,
    added by their entries alone."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for held in sorted((ROOT / "portbench" / "held_out").glob("*.json")):
        entries = json.loads(held.read_text())
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += entries[key]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root, workload, fault=None):
    """One whole unit in the window, however fast the host."""
    cfg, traffic = TINY[workload]
    return harness.run_cell(workload, 2**33 + 17, 60.0, False, t_process=time.perf_counter(),
                            device="cpu", root=root, overrides=cfg, traffic_overrides=traffic,
                            fault=fault, units=1)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_is_correct_on_the_cpu(root, workload):
    res = run(root, workload)
    assert res["correct"] is True
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    assert set(res["metrics"]) == {"setup_s"}  # the window's rates need a card


@pytest.mark.parametrize("workload, members", [("pol2d-n256-screen32", 2),
                                               ("expsin3d-n128-level", 1)])
def test_reference_agrees_with_the_programs_cpu_path(root, workload, members):
    _b, _c, cfg, _t = harness.load_cell(workload, root)
    cfg = {**cfg, **TINY[workload][0]}
    etas = [37.5, 160.0][:members]
    driver = load_module(ROOT, "drivers", cfg["entry"])
    work = driver.build(cfg, etas, torch.device("cpu"), lambda name: contextlib.nullcontext())
    got = work["unit"]()
    ref = driver.reference(cfg, etas, torch.device("cpu"), torch.float64)
    g = gaps(got, ref)
    assert g["field_gap"] < 1e-11
    if "error_gap" in g:
        assert g["error_gap"] < 1e-12


def _float32_control(work, cfg, etas, driver):
    low = driver.reference(cfg, etas, torch.device("cpu"), torch.float32)
    unit = work["unit"]
    work["unit"] = lambda: (unit(), low)[1]


def _state_unchanged(work, cfg, etas, driver):
    for integ in work["integrators"]:
        step = integ.step_fn
        integ.step_fn = lambda g, ops, s, t, dt, _step=step: (s, _step(g, ops, s, t, dt)[1])


def _half_batch_left_out(work, cfg, etas, driver):
    """Each step advances the first half of the stack; the rest keep their
    state."""
    for integ in work["integrators"]:
        step = integ.step_fn

        def half(g, ops, s, t, dt, _step=step):
            new, diag = _step(g, ops, s, t, dt)
            k = s.T.shape[0] // 2
            return type(s)(*(torch.cat([n[:k], o[k:]]) for n, o in zip(new, s))), diag

        integ.step_fn = half


def _answer_altered(work, cfg, etas, driver):
    unit = work["unit"]

    def altered():
        out = unit()
        out["state"]["T"] = out["state"]["T"].clone()
        out["state"]["T"][0] *= 1.0 + 1e-6
        return out

    work["unit"] = altered


def _etas_put_wrong(name):
    """The program built on the members' η put wrong (``ETA_FAULTS``), the
    reference on the seed's own."""

    def plant(work, cfg, etas, driver):
        wrong = ETA_FAULTS[name](list(etas))
        assert wrong != list(etas)
        work.update(driver.build(cfg, wrong, torch.device("cpu"),
                                 lambda span: contextlib.nullcontext()))

    plant.__name__ = name
    return plant


@pytest.mark.parametrize("workload, fault", [
    ("pol2d-n256-screen32", _float32_control),
    ("expsin3d-n128-level", _float32_control),
    ("pol2d-n256-screen32", _state_unchanged),
    ("expsin3d-n128-level", _state_unchanged),
    ("pol2d-n256-screen32", _half_batch_left_out),
    ("pol2d-n256-screen32", _answer_altered),
    ("expsin3d-n128-level", _answer_altered),
    ("pol2d-n256-screen32", _etas_put_wrong("etas_rolled")),
    ("pol2d-n256-screen32", _etas_put_wrong("etas_doubled")),
    ("expsin3d-n128-level", _etas_put_wrong("etas_doubled")),
])
def test_control_and_faults_are_not_correct(root, workload, fault):
    res = run(root, workload, fault=fault)
    assert res["correct"] is False
    assert res["attempted"] == 1 and res["failed"] == 1


def test_an_added_cell_needs_no_edit(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files,
    and entries added to BENCHMARK.json, make a new cell."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "portbench/configs/pol2d.json").read_text())
    cfg.update(name="pol2d_tiny", N=8, dt=0.0025)
    (tmp_path / "portbench/configs/pol2d_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/screen32.json").read_text())
    traffic.update(name="screen2", members=2)
    (tmp_path / "portbench/traffic/screen2.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/members_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['members'])\n")
    bench["configs"].append({"name": "pol2d_tiny", "source": "https://example.org/x",
                             "file": "portbench/configs/pol2d_tiny.json", "reduced": ["N"],
                             "why": "test"})
    bench["workloads"].append({"name": "pol2d_tiny-screen2", "config": "pol2d_tiny",
                               "traffic": "screen2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "members_traced", "unit": "members", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "member_steps_per_s",
                               "workloads": ["pol2d_tiny-screen2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell("pol2d_tiny-screen2", 5, 60.0, True, t_process=time.perf_counter(),
                           device="cpu", root=tmp_path, units=1)
    assert res["correct"] is True
    assert res["metrics"] == {"members_traced": {"value": 2.0, "unit": "members"}}
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_on_the_card(card, root, workload):
    """A short window of each cell, as the benchmark runs it on the card."""
    res = harness.run_cell(workload, 2**33 + 3, 35.0, False, t_process=time.perf_counter(),
                           root=root)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert {"member_steps_per_s", "step_ms_p90", "setup_s"} <= set(res["metrics"])
