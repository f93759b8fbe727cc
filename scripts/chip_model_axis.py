"""chip_smoke.py's model-axis legs alone on one card, in one call of a
few minutes: phase 13 (e), two gloo processes as data 1 x model 2 on
milestone9k against one process, on random batches at its patch; then
phase 14 whole, (a) to (d), on random resident 128x128x10 volumes, (d)
being its eight processes on data 2 x model 2 x spatial 2.

    python3 scripts/chip_model_axis.py

It builds the stencil pair only (kernels 1, 2 and 5 are off on these
meshes) and prints the smoke's own lines for these legs; it fails as the
smoke does. It needs the card; it imports nothing of JAX."""
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def e_rank(rank, tmp):
    """One of (e)'s two processes: the seeded state as mesh_rank draws it,
    chip_smoke.model_setup, then model_leg; rank 0 writes what they
    gathered."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.parallel import make_mesh
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/e_store",
                            rank=rank, world_size=2)
    try:
        src = torch.load(os.path.join(tmp, "mesh_in.pt"), weights_only=False)
        cfg = load_config(src["ini"])
        mesh = make_mesh(-1, devices=dev)
        gan = WindFieldGAN(cfg, src["coords"], src["coords"], device=dev,
                           mesh=mesh)
        state = gan.init_state(cs.TRAIN_SEED, *src["shapes"])
        params0 = {k: v.clone() for k, v in state.params_G.items()}
        prep = cs.model_setup(dev, src, state, params0)
        del gan, state
        res = {}
        t = time.monotonic()
        res["e"], g, served = cs.model_leg(dev, src, prep)
        res["e_s"] = time.monotonic() - t
        every = [None] * 2
        dist.all_gather_object(every, res, group=mesh.control)
        if rank == 0:
            torch.save(dict(ranks=every, e_grads=g, e_served=served),
                       os.path.join(tmp, "mesh_out.pt"))
    finally:
        dist.destroy_process_group()


def main():
    """(e)'s inputs and references as mesh_start and model_reference make
    them, its two ranks, model_report; then phase 14 as the smoke runs it
    (spatial_inputs, spatial_launch, spatial_reference, spatial_phase)."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a card")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.monotonic()
    build.warm(["stencil"])
    cs.log(f"stencil built in {time.monotonic() - t:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_model_axis_")
    try:
        legs(dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def legs(dev, card, tmp):
    """Phase 13 (e), then phase 14, in the temporary directory ``tmp``."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    # phase 13 (e)
    t0 = time.monotonic()
    cfg = load_config(cs.CFG)
    ini = os.path.join(tmp, "mesh.ini")
    cfg.save(ini)
    g = cfg.gan_config
    n, p, zl = cfg.dataset_train.batch_size, g.slice_size, g.number_of_z_layers
    coords = np.arange(p, dtype=np.float32) * 150.0
    shapes = ((n, p // cfg.scale, p // cfg.scale, zl, cfg.lr_num_channels),
              (n, p, p, zl, 3))
    gen = torch.Generator().manual_seed(1)
    batches = []
    for i in range(6):
        hr = torch.randn(shapes[1], generator=gen) * 0.3
        lr = torch.cat([hr[:, ::4, ::4], torch.rand(
            shapes[0][:-1] + (1,), generator=gen)], -1)
        z = torch.cumsum(1 + torch.rand(shapes[1][:-1] + (1,),
                                        generator=gen), 3) * 10
        batches.append((lr, hr, z))
    serve_in = cs.sample(np.random.default_rng(7), 8, p // cfg.scale, p, zl,
                         cfg.lr_num_channels)
    model = cs.model_batches(batches)
    torch.save(dict(ini=ini, coords=coords, shapes=shapes, serve=serve_in,
                    model=model), os.path.join(tmp, "mesh_in.pt"))
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    st = gan.init_state(cs.TRAIN_SEED, *shapes)
    p5 = {"before": cs.copy_state(st, "cpu")}
    started = dict(cfg=cfg, coords=coords, shapes=shapes, model=model)
    ref = cs.model_reference(dev, started, p5)
    served1 = WindFieldSR(cfg, st.params_G, device=dev).upscale(*serve_in)
    del gan, st
    torch.cuda.empty_cache()
    cs.log(f"(e) references in {time.monotonic() - t0:.1f} s")
    t = time.monotonic()
    mp.start_processes(e_rank, args=(tmp,), nprocs=2, start_method="spawn",
                       join=True)
    out = torch.load(os.path.join(tmp, "mesh_out.pt"), weights_only=False)
    cs.log(f"(e) ranks in {time.monotonic() - t:.1f} s")
    cs.model_report(card, out, ref, served1)
    cs.log(f"phase 13 (e) alone {time.monotonic() - t0:.1f} s")
    # phase 14 on random resident volumes
    t0 = time.monotonic()

    class Resident:
        """Stands for phase 11's resident volumes."""

    r = Resident()
    gen = torch.Generator().manual_seed(2)
    r.full = (torch.randn(12, 128, 128, 10, 4, generator=gen) * 0.3).to(dev)
    r.zraw = torch.cumsum(1 + torch.rand(12, 128, 128, 10, 1, generator=gen),
                          3).mul(10).to(dev)
    started_sp = cs.spatial_inputs(dev, tmp, r)
    cs.spatial_launch(started_sp)
    ref_sp = cs.spatial_reference(dev, started_sp)
    open(os.path.join(tmp, "mesh_card"), "w").close()
    cs.spatial_phase(dev, card, tmp, started_sp, ref_sp)
    cs.log(f"phase 14 alone {time.monotonic() - t0:.1f} s")
    started_sp["ctx"].join()


if __name__ == "__main__":
    try:
        main()
    finally:
        for proc in cs.CHILDREN:
            if proc.is_alive():
                proc.kill()
