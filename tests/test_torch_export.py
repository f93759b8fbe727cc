"""PyTorch port: the ``torch.export`` deployment artifact
(``eval/export.py``), ``run.py --export`` and ``eval/server.py
--artifact``, on the CPU against the port's own serving path and the JAX
package's artifact.

- the round trip is bit-exact against the port's plain ``upscale`` (the
  same aten ops) at batches 1 and 3, traced at batch 2;
- the port's artifact against the JAX artifact of the same weights within
  JAX's own bounds (rtol 2e-4, atol 1e-5, ``tests/test_export.py``);
- the headers carry the same keys and values apart from the version, the
  platforms and the runtime; each package's reader refuses the other's
  payload; bad magic raises;
- ``upscale_physical`` with the header's norm_stats, and without them it
  raises.
"""

import io
import json
import os
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest

from _torch_tiny import tiny_cfg
from gan_sr_wind_field_tpu.eval import export as jexport
from gan_sr_wind_field_tpu.train.continuation import (
    load_continuation as jax_load_continuation,
)
from gan_sr_wind_field_tpu.train.gan import WindFieldGAN as JaxGAN
from gan_sr_wind_field_tpu_torch import run
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.eval import server
from gan_sr_wind_field_tpu_torch.eval.export import (
    ExportedSR,
    export_generator,
    load_exported,
    read_header,
)
from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
from gan_sr_wind_field_tpu_torch.utils.jax_params import params_from_jax
from test_torch_test_loop import HOURS, SIZE, _cfg, _cli, pack  # noqa: F401

COORDS = np.arange(16, dtype=np.float32) * 150.0
STATS = {"z_min": -2.7, "z_max": 550.4, "z_above_ground_max": 68.5,
         "uvw_max": 32.33, "p_min": 0.0, "p_max": 105182.8}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    """A JAX generator's weights, the JAX GAN and the port's config."""
    cfg = tiny_cfg(False)
    gan = JaxGAN(cfg, COORDS, COORDS)
    state = gan.init_state(jax.random.key(7), (1, 4, 4, 4, 4),
                           (1, 16, 16, 4, 3))
    return gan, state.params_G, tiny_cfg(True)


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """The port's artifact and JAX's of the same weights, with stats."""
    gan, params, cfg = model
    d = tmp_path_factory.mktemp("artifacts")
    port_path, jax_path = str(d / "port.wsrx"), str(d / "jax.wsrx")
    port_params = params_from_jax(jax.tree.map(np.asarray, params))
    export_generator(cfg, port_params, port_path, norm_stats=STATS)
    jexport.export_generator(gan, params, jax_path, norm_stats=STATS)
    return port_path, jax_path, port_params


def _sample(seed, n):
    rng = np.random.default_rng(seed)
    lr = (rng.standard_normal((n, 4, 4, 4, 4)) * 0.3).astype(np.float32)
    z = rng.standard_normal((n, 16, 16, 4, 1)).astype(np.float32)
    return lr, z


def test_round_trip_is_bit_exact_at_any_batch(model, artifacts):
    _, _, cfg = model
    port_path, _, params = artifacts
    sr = load_exported(port_path, device="cpu")
    assert isinstance(sr, ExportedSR) and sr.header["batch_polymorphic"]
    plain = WindFieldSR(cfg, params, device="cpu")
    for n in (1, 3):
        lr, z = _sample(n, n)
        got = sr.upscale(lr, z)
        assert got.shape == (n, 16, 16, 4, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, plain.upscale(lr, z))
    lr, z = _sample(4, 1)
    np.testing.assert_array_equal(sr.upscale(lr[0], z[0]),
                                  plain.upscale(lr[0], z[0]))


def test_port_artifact_matches_the_jax_artifact(artifacts):
    port_path, jax_path, _ = artifacts
    port_sr = load_exported(port_path, device="cpu")
    jax_sr = jexport.load_exported(jax_path)
    for n in (1, 3):
        lr, z = _sample(10 + n, n)
        np.testing.assert_allclose(port_sr.upscale(lr, z),
                                   np.asarray(jax_sr.upscale(lr, z)),
                                   rtol=2e-4, atol=1e-5)


def test_headers_match_jax_apart_from_version_and_runtime(artifacts):
    port_path, jax_path, _ = artifacts
    port, want = read_header(port_path), read_header(jax_path)
    assert want["format_version"] == 1 and "payload" not in want
    assert port["format_version"] == 2
    assert port["payload"] == "torch.export"
    assert port["platforms"] == ["cpu", "cuda"]
    runtime = {"format_version", "platforms", "jax_version", "torch_version",
               "payload"}
    assert set(port) - runtime == set(want) - runtime
    for key in set(want) - runtime:
        assert port[key] == want[key], key
    assert port["norm_stats"] == STATS


def test_each_reader_refuses_the_others_payload(artifacts, tmp_path):
    port_path, jax_path, _ = artifacts
    with pytest.raises(ValueError, match="newer than this reader"):
        jexport.read_header(port_path)
    with pytest.raises(ValueError, match="newer than this reader"):
        jexport.load_exported(port_path)
    with pytest.raises(ValueError,
                       match="gan_sr_wind_field_tpu.eval.export"
                             ".load_exported"):
        load_exported(jax_path, device="cpu")
    bad = tmp_path / "bad.wsrx"
    bad.write_bytes(b"NOPE" + b"\0" * 16)
    for reader in (read_header, lambda p: load_exported(p, device="cpu")):
        with pytest.raises(ValueError, match="not a WSRX artifact"):
            reader(str(bad))


def test_static_batch_artifact_rejects_another_batch(model, tmp_path):
    _, _, cfg = model
    path = str(tmp_path / "static.wsrx")
    G = WindFieldSR(cfg, params_from_jax(jax.tree.map(
        np.asarray, model[1])), device="cpu").G
    header = export_generator(cfg, G.state_dict(), path,
                              batch_polymorphic=False)
    assert header["lr_shape"][0] == 1 and not header["batch_polymorphic"]
    sr = load_exported(path, device="cpu")
    lr, z = _sample(5, 2)
    with pytest.raises(ValueError, match="static batch"):
        sr.upscale(lr, z)
    assert sr.upscale(lr[:1], z[:1]).shape == (1, 16, 16, 4, 3)


def test_upscale_physical_with_and_without_stats(model, artifacts, tmp_path):
    _, _, cfg = model
    port_path, jax_path, params = artifacts
    sr = load_exported(port_path, device="cpu")
    rng = np.random.default_rng(6)
    lr_uvw = rng.standard_normal((4, 4, 4, 3)).astype(np.float32) * 8
    z = np.cumsum(rng.random((16, 16, 4)).astype(np.float32) * 50, axis=2)
    got = sr.upscale_physical(lr_uvw, z)
    want = WindFieldSR(cfg, params, device="cpu",
                       norm_stats=STATS).upscale_physical(lr_uvw, z)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.asarray(jexport.load_exported(jax_path).upscale_physical(
            lr_uvw, z)), rtol=2e-4, atol=1e-4)
    bare = str(tmp_path / "bare.wsrx")
    export_generator(cfg, params, bare)
    with pytest.raises(ValueError, match="norm_stats"):
        load_exported(bare, device="cpu").upscale_physical(lr_uvw, z)


def test_payload_runs_with_torch_alone(artifacts):
    """The artifact needs no code of this package: a subprocess that
    imports only torch, json and struct reads the header and runs it."""
    port_path, _, params = artifacts
    code = (
        "import json, struct, sys, torch\n"
        "f = open(sys.argv[1], 'rb')\n"
        "assert f.read(4) == b'WSRX'\n"
        "(n,) = struct.unpack('<I', f.read(4))\n"
        "h = json.loads(f.read(n))\n"
        "m = torch.export.load(f).module()\n"
        "g = torch.Generator().manual_seed(0)\n"
        "lr = torch.randn(3, *h['lr_shape'][1:], generator=g)\n"
        "z = torch.randn(3, *h['z_shape'][1:], generator=g)\n"
        "print(json.dumps(m(lr, z).sum().item()))\n"
        "mods = [k for k in sys.modules if k.startswith('gan_sr')]\n"
        "assert not mods, mods\n"
    )
    out = subprocess.run([sys.executable, "-c", code, port_path],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(port_path))
    assert out.returncode == 0, out.stderr
    import torch

    g = torch.Generator().manual_seed(0)
    lr = torch.randn(3, 4, 4, 4, 4, generator=g)
    z = torch.randn(3, 16, 16, 4, 1, generator=g)
    want = WindFieldSR(tiny_cfg(True), params, device="cpu").upscale(
        lr.numpy(), z.numpy()).sum()
    assert json.loads(out.stdout.split()[-1]) == pytest.approx(
        float(want), rel=1e-5)


# ------------------------------------------------------- the entry points
def test_cli_export_reaches_export_generator(tmp_path, pack):
    """``run.py --export`` writes the EMA generator of the pack with the
    test cache's norm_stats; it serves as JAX's artifact of the same
    weights does."""
    out = str(tmp_path / "gen.wsrx")
    header = _cli(tmp_path, pack, "--export", out)
    assert header == read_header(out)
    cfg = _cfg(True, tmp_path, pack)
    _, ds_test, _, _, _ = preprocess(cfg, synthetic=True,
                                     synthetic_hours=HOURS,
                                     synthetic_size=SIZE)
    assert header["norm_stats"] == pytest.approx(
        {k: float(v) for k, v in vars(ds_test.stats).items()})
    sr = load_exported(out, device="cpu")
    lr, z = _sample(8, 2)
    want = WindFieldSR.from_continuation(cfg, pack, device="cpu")
    np.testing.assert_array_equal(sr.upscale(lr, z), want.upscale(lr, z))
    jgan = JaxGAN(tiny_cfg(False), COORDS, COORDS)
    jpath = str(tmp_path / "jax.wsrx")
    jexport.export_generator(jgan, jax_load_continuation(pack)["params_G_ema"],
                             jpath)
    np.testing.assert_allclose(
        sr.upscale(lr, z), np.asarray(jexport.load_exported(jpath).upscale(
            lr, z)), rtol=2e-4, atol=1e-5)


def test_server_artifact_builds_an_exported_backend(artifacts, monkeypatch):
    port_path, _, _ = artifacts
    captured = {}

    def fake_serve(backend, **kw):
        captured.update(kw, backend=backend)

    monkeypatch.setattr(server, "serve", fake_serve)
    assert server.main(["--artifact", port_path, "--device", "cpu",
                        "--port", "0", "--warmup", "1,2"]) == 0
    backend = captured["backend"]
    assert isinstance(backend, ExportedSR)
    assert captured["tile"] == 4 and captured["tile_overlap"] == 1
    # --artifact serves without a config, and the other weights need one
    for argv in (["--artifact", port_path, "--cfg", "x.ini"],
                 ["--continuation", "x.npz"]):
        with pytest.raises(SystemExit):
            server.main(argv)
    # /v1/health reports the artifact's scale, norm_stats and tile
    srv = server.WindFieldServer(("127.0.0.1", 0), backend, tile=4,
                                 tile_overlap=1)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/health"
        with urllib.request.urlopen(url, timeout=30) as resp:
            health = json.loads(resp.read())
        lr, z = _sample(9, 1)
        buf = io.BytesIO()
        np.savez(buf, lr=lr[0], z=z[0])
        req = urllib.request.Request(
            url.replace("health", "upscale"), data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            sr = np.load(io.BytesIO(resp.read()))["sr"]
    finally:
        srv.close()
    assert health["scale"] == 4 and health["tile"] == 4
    assert health["norm_stats"] == STATS
    assert health["backend"] == "ExportedSR"
    np.testing.assert_array_equal(sr, backend.upscale(lr[0], z[0]))
