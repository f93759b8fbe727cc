"""A tiny configuration of each traffic kind for the harness's CPU tests:
the configurations' own sections with small widths and depth, so that a
whole run (set-up, window, reference, check) takes seconds on the CPU."""

from __future__ import annotations

import copy
import json

from windbench import inputs

REAL_LOAD = inputs.load_json


def tiny_conf(name: str) -> dict:
    conf = copy.deepcopy(REAL_LOAD("configs", name))
    sec = conf["sections"]
    sec["GENERATOR"].update(num_features=8, num_RRDB=1, num_RDB_convs=3,
                            RDB_growth_chan=4, hr_kern_size=3,
                            terrain_number_of_features=4)
    sec["DISCRIMINATOR"]["num_features"] = 4
    if sec["GAN"]["enable_slicing"]:
        sec["GAN"]["slice_size"] = 16
        conf["volume"] = [32, 32, 10]
    else:
        conf["volume"] = [32, 32, 10]
    sec["DATASETTRAIN"]["batch_size"] = 2
    conf["train_volumes"] = 4
    return conf


def tiny_traffic(name: str) -> dict:
    t = copy.deepcopy(REAL_LOAD("traffic", name))
    if t["kind"] == "open_loop":
        t.update(rate=20.0, workers=4, pool=4, sample=4, check_block=2,
                 drain_s=20, warm_batches=[1, 2, 4, 8])
    elif t["kind"] == "closed_loop":
        t.update(clients=2, pool=4, sample=4, check_block=2, drain_s=20,
                 warm_batches=[1, 2])
    return t


LIMITS = {"train": {"loss": 0.02, "grad": 0.6, "change": 0.3},
          "serve": {"field_err": 0.05, "missing": 0}}


def bench() -> dict:
    """BENCHMARK.json with the cells held out of it (``windbench/held/``:
    measured, kept out until they read steadily), so that their files stay
    tested."""
    b = json.loads((inputs.ROOT.parent / "BENCHMARK.json").read_text())
    for f in sorted((inputs.ROOT / "held").glob("*.json")):
        for group, entries in json.loads(f.read_text()).items():
            b[group] += entries
    return b


def install(monkeypatch, limits=None) -> None:
    """Serve the tiny configuration and mixes, and test limits, to the
    harness in place of the files."""
    lim = dict(LIMITS, **(limits or {}))

    def load(kind, name):
        if kind == "configs":
            return tiny_conf(name)
        if kind == "traffic":
            return tiny_traffic(name)
        if kind == "limits":
            return lim["train" if name.startswith("train.") else "serve"]
        return REAL_LOAD(kind, name)

    monkeypatch.setattr(inputs, "load_json", load)
