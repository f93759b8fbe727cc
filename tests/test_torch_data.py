"""PyTorch port: the training data feed against the JAX package on the CPU.

The synthetic cache, ``preprocess`` (splits, names, norm stats, axes),
``WindDataset`` (items and batches, host augmentation and slicing on and
off, the z regrid), the memmap cache, the resident volumes, ``slice_batch``
and ``augment_batch`` fed JAX's draws, all with exact equality: both sides
are numpy, or permutations and sign flips of the same numbers. 6 hours at
32×32×10.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_sr_wind_field_tpu.config import Config as JaxConfig
from gan_sr_wind_field_tpu.data import augment as jaug
from gan_sr_wind_field_tpu.data import device_data as jdd
from gan_sr_wind_field_tpu.data import files as jfiles
from gan_sr_wind_field_tpu.data import preprocess as jax_preprocess
from gan_sr_wind_field_tpu.data.npcache import build_memmap_cache as jax_npc
from gan_sr_wind_field_tpu.data.synthetic import (
    generate_synthetic_cache as jax_cache,
)
from gan_sr_wind_field_tpu.data.zinterp import interpolate_z_columns as jzi
from gan_sr_wind_field_tpu_torch.config import Config as PortConfig
from gan_sr_wind_field_tpu_torch.data import augment, device_data
from gan_sr_wind_field_tpu_torch.data import files as pfiles
from gan_sr_wind_field_tpu_torch.data import preprocess
from gan_sr_wind_field_tpu_torch.data.npcache import (
    MemmapSource,
    build_memmap_cache,
)
from gan_sr_wind_field_tpu_torch.data.pipeline import prefetch_to_device
from gan_sr_wind_field_tpu_torch.data.synthetic import (
    generate_synthetic_cache,
)
from gan_sr_wind_field_tpu_torch.data.zinterp import interpolate_z_columns

HOURS, SIZE, ZL = 6, 32, 10


def _cfg(port: bool, root, slicing=True, aug=True, interp=False):
    cfg = (PortConfig if port else JaxConfig)()
    cfg.env.data_root = str(root)
    cfg.scale = 4
    g = cfg.gan_config
    g.include_pressure = True
    g.include_z_channel = True
    g.include_above_ground_channel = True
    g.number_of_z_layers = ZL
    g.enable_slicing = slicing
    g.slice_size = 16
    g.interpolate_z = interp
    cfg.dataset_train.data_aug_rot = aug
    cfg.dataset_train.data_aug_flip = aug
    return cfg


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def _pickled(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same synthetic cache written by each package."""
    roots = {}
    for name, gen_cache in (("jax", jax_cache), ("port",
                                                 generate_synthetic_cache)):
        root = tmp_path_factory.mktemp(name)
        roots[name] = (root, gen_cache(str(root), HOURS, SIZE, SIZE, ZL))
    return roots


def test_synthetic_cache_files_equal(caches):
    (jroot, jout), (proot, pout) = caches["jax"], caches["port"]
    assert pout == jout and len(pout[0]) == HOURS
    jf, pf = _tree_files(jroot), _tree_files(proot)
    assert sorted(pf) == sorted(jf) and len(pf) == 2 * HOURS + 1
    for rel in jf:
        _assert_same(_pickled(pf[rel]), _pickled(jf[rel]))


@pytest.mark.parametrize("slicing,aug", [(True, True), (False, False)])
def test_preprocess_and_dataset_match_jax(caches, slicing, aug):
    """One cache (written by the JAX package) read by both: splits, names,
    NormStats, axes, ``get`` and ``batches`` for the same numpy seed."""
    root = caches["jax"][0]
    want = jax_preprocess(_cfg(False, root, slicing, aug), synthetic=True,
                          synthetic_hours=HOURS, synthetic_size=SIZE)
    got = preprocess(_cfg(True, root, slicing, aug), synthetic=True,
                     synthetic_hours=HOURS, synthetic_size=SIZE)
    for g, w in zip(got[:3], want[:3]):
        assert g.filenames == w.filenames
        assert vars(g.stats) == vars(w.stats)
        assert (g.data_aug_rot, g.enable_slicing) == (w.data_aug_rot,
                                                       w.enable_slicing)
    assert [len(d) for d in got[:3]] == [4, 0, 2]
    _assert_same(got[3:], want[3:])
    for idx in range(len(got[0])):
        r1, r2 = np.random.default_rng(idx), np.random.default_rng(idx)
        _assert_same(got[0].get(idx, r1), want[0].get(idx, r2))
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for g, w in zip(got[0].batches(2, r1, epochs=2),
                    want[0].batches(2, r2, epochs=2)):
        _assert_same(g, w)
    if not slicing:  # the test split's extras in test mode
        got[2].is_test = want[2].is_test = True
        r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
        _assert_same(list(got[2].get(1, r1)), list(want[2].get(1, r2)))


def test_norm_factors_and_npcache_match_jax(caches):
    """The norm factors pickle and the memmap cache of the port's cache
    are the files the JAX package writes; memmap reads equal the pickles."""
    proot = caches["port"][0]
    names, sub = caches["port"][1]
    folder = pfiles.dataset_folder(str(proot), sub)
    preprocess(_cfg(True, proot), synthetic=True, synthetic_hours=HOURS,
               synthetic_size=SIZE)
    jax_preprocess(_cfg(False, caches["jax"][0]), synthetic=True,
                   synthetic_hours=HOURS, synthetic_size=SIZE)
    jfolder = jfiles.dataset_folder(str(caches["jax"][0]), sub)
    _assert_same(_pickled(pfiles.norm_factors_path(folder)),
                 _pickled(jfiles.norm_factors_path(jfolder)))
    split = names[:4]
    p_path = build_memmap_cache(folder, split)
    j_path = jax_npc(jfolder, split)
    assert os.path.basename(p_path) == os.path.basename(j_path)
    with open(p_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    src = MemmapSource(folder, split)
    for name in split:
        for got, want in zip(src.load(name),
                             pfiles.read_sample(folder, name)):
            assert np.array_equal(got, np.asarray(want, np.float32))


def test_z_regrid_matches_jax(caches):
    """``interpolate_z``: the regrid itself and the dataset items through
    the per-sample regrid cache."""
    root = caches["jax"][0]
    names, sub = caches["jax"][1]
    folder = jfiles.dataset_folder(str(root), sub)
    z, zag, u, v, w, p = jfiles.read_sample(folder, names[0])
    terrain, x, y = jfiles.read_static(folder)
    _assert_same(interpolate_z_columns(x, y, zag, u, v, w, p, terrain),
                 jzi(x, y, zag, u, v, w, p, terrain))
    # each package regrids its own copy of the cache
    got = preprocess(_cfg(True, caches["port"][0], interp=True),
                     synthetic=True, synthetic_hours=HOURS,
                     synthetic_size=SIZE)
    want = jax_preprocess(_cfg(False, root, interp=True), synthetic=True,
                          synthetic_hours=HOURS, synthetic_size=SIZE)
    for idx in range(len(got[0])):
        r1, r2 = np.random.default_rng(idx), np.random.default_rng(idx)
        _assert_same(got[0].get(idx, r1), want[0].get(idx, r2))


def test_resident_volumes_and_slice_batch_match_jax(caches):
    """``load_resident_volumes``, then ``slice_batch`` fed the draws JAX
    makes for a key (``device_data.py:55-59``), against JAX's batch."""
    root = caches["jax"][0]
    jds = jax_preprocess(_cfg(False, root), synthetic=True,
                         synthetic_hours=HOURS, synthetic_size=SIZE)[0]
    pds = preprocess(_cfg(True, root), synthetic=True,
                     synthetic_hours=HOURS, synthetic_size=SIZE)[0]
    full, zraw = device_data.load_resident_volumes(pds)
    _assert_same((full, zraw), jdd.load_resident_volumes(jds))
    N, X, Y = full.shape[:3]
    B, P = 5, pds.slice_size
    for seed in range(3):
        key = jax.random.key(seed)
        want = jdd.slice_batch(jnp.asarray(full), jnp.asarray(zraw), key,
                               batch_size=B, patch=P, patch_y=P, cf=4,
                               enable_slicing=True)
        kidx, kx, ky = jax.random.split(key, 3)
        idx = jax.random.randint(kidx, (B,), 0, N)
        xs = jnp.round(jax.random.beta(kx, 0.25, 0.25, (B,)) * (X - P))
        ys = jnp.round(jax.random.beta(ky, 0.25, 0.25, (B,)) * (Y - P))
        draws = [torch.from_numpy(np.asarray(a).astype(np.int64))
                 for a in (idx, xs, ys)]
        got = device_data.slice_batch_with(
            torch.from_numpy(full), torch.from_numpy(zraw), *draws,
            patch=P, patch_y=P, cf=4)
        _assert_same([g.numpy() for g in got], list(want))


def test_device_batcher_stream(caches):
    """Batches are cut where the host path cuts them; the count seeds each
    batch, so a batcher started at count 2 continues the stream; the
    offsets stay in range and the draws are Beta(0.25, 0.25)."""
    root = caches["port"][0]
    ds = preprocess(_cfg(True, root), synthetic=True, synthetic_hours=HOURS,
                    synthetic_size=SIZE)[0]
    a = device_data.DeviceBatcher(ds, 3, "cpu", seed=11)
    first = [next(a) for _ in range(4)]
    b = device_data.DeviceBatcher(ds, 3, "cpu", seed=11, start_count=2)
    for want in first[2:]:
        for g, w in zip(next(b), want):
            assert torch.equal(g, w)
    assert not torch.equal(first[0][1], first[1][1])
    lr, hr, z = first[0]
    assert lr.shape == (3, 4, 4, ZL, 6) and hr.shape == (3, 16, 16, ZL, 3)
    assert torch.equal(lr[..., :3], hr[:, ::4, ::4])
    assert a.resident_bytes() == (len(ds) * SIZE * SIZE * ZL * 7 * 4)
    gen = torch.Generator().manual_seed(0)
    draws = device_data.beta_draws(100_000, 0.25, gen).numpy()
    assert draws.min() >= 0.0 and draws.max() <= 1.0
    # Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)) = 1/6 at a = 1/4
    assert abs(draws.mean() - 0.5) < 0.005
    assert abs(draws.var() - 1 / 6) < 0.005
    idx, xs, ys = device_data.slice_draws(6, 1000, SIZE, SIZE, 16, 16, True,
                                          gen)
    assert idx.min() >= 0 and idx.max() == 5
    assert xs.min() >= 0 and xs.max() <= 16 and ys.max() <= 16


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("fx,fy", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_augment_batch_matches_jax_per_draw(k, fx, fy):
    """Each of the 4 rotations × 4 mirror pairs against the JAX package's
    per-sample transform."""
    rng = np.random.default_rng(k * 4 + 2 * fx + fy)
    lr = rng.standard_normal((1, 4, 4, 3, 5)).astype(np.float32)
    hr = rng.standard_normal((1, 16, 16, 3, 3)).astype(np.float32)
    z = rng.standard_normal((1, 16, 16, 3, 1)).astype(np.float32)
    got = augment.augment_batch_with(
        *(torch.from_numpy(a) for a in (lr, hr, z)), torch.tensor([k]),
        torch.tensor([fx]), torch.tensor([fy]))
    for g, a, vec in zip(got, (lr, hr, z), (True, True, False)):
        want = jaug._flip_single(jaug._rot90_single(jnp.asarray(a[0]), k,
                                                     vec), fx, fy, vec)
        assert np.array_equal(g[0].numpy(), np.asarray(want))


def test_augment_batch_matches_jax_with_its_draws():
    """JAX ``augment_batch`` for a key against the port's fed the draws
    that key makes (``augment.py:137-140``)."""
    rng = np.random.default_rng(0)
    n = 16
    lr = rng.standard_normal((n, 4, 4, 3, 4)).astype(np.float32)
    hr = rng.standard_normal((n, 16, 16, 3, 3)).astype(np.float32)
    z = rng.standard_normal((n, 16, 16, 3, 1)).astype(np.float32)
    key = jax.random.key(5)
    want = jaug.augment_batch(key, lr, hr, z)
    k_rot, k_fx, k_fy = jax.random.split(key, 3)
    draws = [torch.from_numpy(np.array(a)) for a in (
        np.asarray(jax.random.randint(k_rot, (n,), 0, 4), np.int64),
        jax.random.bernoulli(k_fx, 0.5, (n,)),
        jax.random.bernoulli(k_fy, 0.5, (n,)))]
    got = augment.augment_batch_with(
        *(torch.from_numpy(a) for a in (lr, hr, z)), *draws)
    _assert_same([g.numpy() for g in got], [np.asarray(w) for w in want])
    # the generator form: its draws, then the same transform
    gen = torch.Generator().manual_seed(3)
    again = torch.Generator().manual_seed(3)
    out = augment.augment_batch(gen, *(torch.from_numpy(a)
                                       for a in (lr, hr, z)))
    ref = augment.augment_batch_with(
        *(torch.from_numpy(a) for a in (lr, hr, z)),
        *augment.augment_draws(n, again))
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_host_augmentation_matches_jax():
    rng = np.random.default_rng(0)
    lr = rng.standard_normal((4, 4, 3, 5)).astype(np.float32)
    hr = rng.standard_normal((16, 16, 3, 3)).astype(np.float32)
    z = rng.standard_normal((16, 16, 3, 1)).astype(np.float32)
    for seed in range(8):
        _assert_same(
            augment.augment_sample_np(lr, hr, z, np.random.default_rng(seed)),
            jaug.augment_sample_np(lr, hr, z, np.random.default_rng(seed)))


def test_prefetch_copies_batches_and_raises_producer_errors():
    batches = [(np.full((2, 3), i, np.float64), np.zeros(4)) for i in range(3)]
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert len(got) == 3
    for (a, b), (wa, _) in zip(got, batches):
        assert a.dtype == torch.float32 and torch.equal(
            a, torch.from_numpy(wa).float())
        assert b.shape == (4,)

    def broken():
        yield np.zeros(2)
        raise RuntimeError("producer died")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)


def test_download_branch_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="downloader"):
        preprocess(_cfg(True, tmp_path), synthetic=False)
