"""Whole runs of every cell at a tiny size on the CPU, the harness's look
for a card skipped: the reference against the port, the control, and the
check coming out false with the timed path broken underneath."""

import importlib

import pytest
import torch

from windbench import drive_serve, drive_train, inputs
from windbench import run as wb_run
from windbench.calibrate import FAULTS
from windbench.reference.model import Precision
from windbench.reference.train import run_steps
from windbench.tests import tiny

CPU = torch.device("cpu")
TRAIN = ["train.milestone9k", "train.fullvol8x3k"]
SERVE = ["serve.milestone9k.steady", "serve.fullvol8x3k.archive"]
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    tiny.install(monkeypatch)
    torch.set_num_threads(4)


def _f32(monkeypatch):
    load = inputs.load_json

    def f32(kind, name):
        d = load(kind, name)
        if kind == "configs":
            d["sections"]["DEFAULT"]["compute_dtype"] = "float32"
        return d

    monkeypatch.setattr(inputs, "load_json", f32)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_float32_port_matches_the_reference(monkeypatch, workload):
    """With the configuration's compute dtype set to float32 the port and
    the reference draw the same numbers and do the same arithmetic."""
    _f32(monkeypatch)
    res = wb_run.run(tiny.bench(), workload, SEED, 0.5, False, CPU)
    for name, c in res["checks"].items():
        assert c["value"] <= 1e-4, (name, c)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_a_run_as_configured_is_correct_and_complete(workload):
    res = wb_run.run(tiny.bench(), workload, SEED + 1, 0.5, True, CPU)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert res["metrics"]  # the readers found something on the CPU too


def test_untraced_run_reports_the_end_to_end_metrics():
    res = wb_run.run(tiny.bench(), "serve.milestone9k.steady", SEED, 0.5,
                     False, CPU)
    assert set(res["metrics"]) == {"serve_p50_ms", "serve_p95_ms", "setup_s"}


def test_the_training_control_reads_higher_than_the_program(monkeypatch):
    """The reference in fp8 in the program's place, against the float32
    reference, reads well above the bf16 program on the same seed, and
    fails the cell's limits."""
    keep = {}
    orig = drive_train.run

    def spy(ctx):
        keep["out"] = out = orig(ctx)
        return out

    monkeypatch.setattr(drive_train, "run", spy)
    res = wb_run.run(tiny.bench(), "train.milestone9k", SEED, 0.2, False,
                     CPU)
    sp, W, data, seeds, start_it, n, before = keep["out"]["inputs"]
    low = run_steps(sp, W, data, seeds, start_it, n, Precision(fp8=True))
    ctrl = drive_train.compare(drive_train.reference_readings(low, before),
                               keep["out"]["reference"])
    prog = {k: c["value"] for k, c in res["checks"].items()}
    assert ctrl["loss"] > 3 * prog["loss"]
    assert ctrl["grad"] > prog["grad"]
    assert not wb_run.judge(ctrl, tiny.LIMITS["train"])[1], ctrl


@pytest.mark.parametrize("workload", SERVE)
def test_the_serving_control_reads_higher_than_the_program(monkeypatch,
                                                           workload):
    """The reference in fp8 in the program's place, against the float32
    reference on the same served fields: it reads above the program and
    fails the cell's limits."""
    keep = {}
    cell = next(w for w in tiny.bench()["workloads"] if w["name"] == workload)
    kind = inputs.load_json("traffic", cell["traffic"])["kind"]
    driver = importlib.import_module(f"windbench.drive_{kind}")
    orig = driver.run

    def spy(ctx, **kw):
        keep["out"] = out = orig(ctx, **kw)
        return out

    monkeypatch.setattr(driver, "run", spy)
    res = wb_run.run(tiny.bench(), workload, SEED, 0.5, False, CPU)
    W_G, g, lrs, zs, fields, dev, block = keep["out"]["inputs"]
    low = drive_serve.reference_fields(W_G, g, lrs, zs, fields, dev, block,
                                       Precision(fp8=True))
    ctrl = drive_serve.relative_errors(low, keep["out"]["want"]).max()
    assert ctrl > 3 * res["checks"]["field_err"]["value"]
    ctrl_checks = {"field_err": float(ctrl), "missing": 0.0}
    assert not wb_run.judge(ctrl_checks, tiny.LIMITS["serve"])[1], ctrl


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_training_step_is_not_correct(monkeypatch, workload, fault):
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    monkeypatch.setattr(WindFieldGAN, "train_step",
                        FAULTS[fault](WindFieldGAN.train_step))
    res = wb_run.run(tiny.bench(), workload, SEED, 0.2, False, CPU)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", SERVE)
def test_an_altered_answer_is_not_correct(workload):
    def alter(out):
        out = out.copy()
        out *= 1.1  # every field the backend produces
        return out

    res = wb_run.run(tiny.bench(), workload, SEED, 0.5, False, CPU,
                     {"alter": alter})
    assert not res["correct"], res["checks"]
