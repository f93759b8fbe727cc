"""What a run and the reference load, in processes of their own."""

import subprocess
import sys

from windbench.inputs import ROOT


def _top_level(module: str) -> set:
    code = (f"import sys, {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _top_level("windbench.run, windbench.drive_train, "
                      "windbench.drive_serve")
    assert not mods & {"jax", "jaxlib", "flax", "gan_sr_wind_field_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level("windbench.reference.train")
    assert not mods & {"jax", "jaxlib", "flax", "gan_sr_wind_field_tpu",
                       "gan_sr_wind_field_tpu_torch"}


def test_the_client_loads_no_torch():
    assert "torch" not in _top_level("windbench.client")
