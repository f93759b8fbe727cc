#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve, train and evaluate the
full-width 4x generator on one NVIDIA card through the hand-written CUDA
kernels, train in chunks of CUDA graphs, SR a field of any extent, and
deploy it: int8 serving, the torch.export artifact, interpolation; then
the reference's users: .pth checkpoints into the readers at 8x and 16x,
the physics-weight search and bf16 Adam moments; then the model options
conv_mode = horizontal_3D and D's instance norm; then the data mesh
(parallel/): training under torchrun, phase 5's steps on a mesh of one,
two processes sharing the card over gloo, and serving on them; then the
spatial axis: configs/fullvol.ini on data 2 x spatial 4, eight processes
sharing the card; then milestone9k trained and tested from raw
HARMONIE-SIMRA files instead of --synthetic; then milestone9k under the
port's supervisor, stopped and resumed, exported and summarized.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --stencils-of ROOT   # kernels 3 and 4 of ROOT only
    python3 chip_smoke.py --supervised-leg OUT --cfg INI ...  # phase 16 runner
    python3 chip_smoke.py --warm OUT NAME    # one of phase 16 processes

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA source of the port (one nvcc call each, in parallel),
     with each one's seconds and ptxas registers and spills; for the bf16
     kernels on the tensor cores (the trunk's tc_growth_fwd, tc_lff_fwd,
     tc_growth_bwd, tc_lff_bwd and the HR head's tc_head5, tc_head3) their
     ptxas report and the HMMA/HGMMA instructions cuobjdump -sass finds in
     each (a count of 0 fails, and so does no HGMMA in the head's, whose
     tile issues wgmma);
  3. each kernel against its plain PyTorch version at full width (16 RRDB
     x 3 RDB, nf=128, gc=32, batch 2, LR 16x16x10, weights at init scale
     1.0, non-zero LFF bias), float32 with TF32 off and bfloat16 against
     the bfloat16 plain version on the same inputs: the trunk forward
     (increment trunk(x) - x, float32 <= 1e-4, bf16 <= 3e-2, and bf16 vs
     the float32 plain version <= 3e-2), its residual mode (out, states,
     growths) and the trunk backward (d_x, dU, dLFF) at the same limits;
     the trainable trunk's weight and input gradients against autograd of
     the plain trunk, float32: its backward on the plain forward's
     residuals <= 1e-4, end to end <= 2e-3; the gradient stencil and its
     adjoint at the training shape (32, 64, 64, 10, 3) with a
     terrain-following Z, <= 1e-5, and the adjoint identity to 1e-5; the
     HR head (batch 2, HR 64x64x10, 128 + 16 channels -> 144, k = 5,
     about 10 % of the channels dropped) float32 <= 1e-4, bf16 <= 1e-2
     (also at batch 32), and HRHead's four gradients against autograd,
     float32: its backward on the plain output <= 1e-4, end to end
     <= 5e-3;
  4. serve configs/milestone9k.ini (seeded random weights, bf16) through
     WindFieldServer on 127.0.0.1: 4 single-sample and one 8-sample HTTP
     request plus 6 concurrent MicroBatcher.submit calls; every output
     (64, 64, 10, 3) and finite, the trunk and head kernels launched once
     a batch (on the card in bf16 milestone9k takes the head kernel,
     models/generator.py:choose_head); then one batch with the module head
     against the same model with the plain trunk, <= 3e-2; then one batch
     of 8 as committed (one launch of each kernel) within 3e-2 of the
     module head;
  5. train configs/milestone9k.ini as it stands (seeded weights at the
     config's init scales, bf16, batch 32): one G step's gradients through
     the kernels against the same step with the RRDB modules and the plain
     stencil (<= 5e-2 relative L2), and, to split that gap, against the
     same step with autograd through the trunk's plain version (printed);
     then from it = 47 four train_steps (48, 49 G; 50, 51 D) and one
     val_step: finite losses and metrics, G and its EMA move on G steps
     only, D and its batch statistics on D steps only, and each kernel's
     launch count rises by what one step predicts (one head launch a
     step); then the committed G step's gradients against the same step
     with the module head (<= 2e-2);
  6. CUDA-event times (1 warm-up, 5 repeats; 2 for a call over 0.1 s,
     1 over 0.2 s):
     the serving forward at batch
     8 with each layer alone, the trunk kernel, its plain version and a
     bf16 cuDNN chain; at batch 32 the G and D steps with their parts
     (the rest of the G step split into its layers, the head as HRHead
     runs it, D, losses and Adam),
     and each training kernel beside its plain version, its bound and a
     bf16 cuDNN/cuBLAS chain (for the residual mode one that keeps its
     states and growths); the stencil pair (kernels 3 and 4) with the
     card's own time per launch under torch.profiler, with the L2 warm and
     cold (a 128 MiB scratch read before each launch), beside the event
     time of 5 calls through the wrapper. The trunk kernels and their
     library chains are timed in turns, kernel-library-library-kernel over
     2 rounds, and the medians kept (serving at batch 8, residual mode and
     backward at 32),
     and one call of each under torch.profiler splits its time by kernel
     against the time the card waits on the host loop.
     Before they are timed, the residual mode and
     the trunk backward are held against their bf16 plain versions at
     batch 32 on the trunk input of a training batch (<= 3e-2), with the
     count of growths on the other side of 0. Then the bf16 head kernel
     against its bf16 plain version at batch 32 on the head's input of a
     training batch (<= 1e-2), its time at batch 8 and 32 beside its plain
     version, bound and bf16 cuDNN (with cudnn.benchmark off and on; the
     kernel is compared with the faster), the time of the head's cuDNN
     backward (hr_head_vjp) at batch 32, and the committed (head
     kernel) serving forward and G and D steps;
  7. train as a user does: python -m gan_sr_wind_field_tpu_torch.run
     --train --synthetic --synthetic_hours 240 --synthetic_size 128 (its
     main, in process) on a copy of configs/milestone9k.ini in a temporary
     directory, with niter 6008 (the label and noise schedules end
     there), log_period 4, val_period 8, save_model_period 4,
     keep_checkpoints 2 and d_g_train_period 4 and all else as committed
     (bf16, batch 32, device-resident data, on-card augmentation, the warm
     start from the 6k pack), to --max_steps 6008: the data feed's host
     parts timed in a thread beside phases 3 to 5 (synthetic cache,
     preprocess, npcache, resident volumes), then the upload and one
     slice_batch + augment_batch at batch 32 timed alone; then
     the leg starts at it 6000, logs finite losses at 6004 and 6008,
     validates at 6008, keeps ckpt_6004 and the final ckpt_6008, and each
     kernel's launches equal what its G steps, D steps, validation batches
     and generate calls predict; the loop's steady-state G and D step
     (CUDA events from one step's start to the next, iterations without
     boundary work) beside phase 6's bare train_step, a validation sweep
     and a checkpoint save with its bytes; restore_checkpoint(ckpt_6008)
     equals the live state bit for bit, the generator's state included
     (phase 16 resumes a leg against this ckpt_6008);
  8. evaluate, use and serve what the port trains, in phase 7's temporary
     directory on its data: pack_from_state of the live state at 6008 in
     float32 and bf16 (in two threads, beside the rest of phase 8), read
     back bit for bit (bf16: the state rounded by
     torch); WindFieldSR.from_checkpoint(ckpt_6008) serves a batch of 8
     (one trunk launch), equal bit for bit to gan.generate with the
     state's EMA, and eval/server.py's main with --checkpoint builds the
     same backend;
     then python -m gan_sr_wind_field_tpu_torch.run --test, --test
     --test_ema and --use (its main, in process, in a temporary working
     directory) on a copy of configs/test_milestone6k.ini whose weights are
     docs/evidence/milestone6k_continuation_6000.npz: 23 rows per metrics
     CSV, the two averages rows, trilinear PSNR within 1e-3 dB and raw G
     and EMA within 0.3 dB of the JAX package's committed result on a TPU
     (docs/evidence/milestone6k_test_averages.csv; raw G above trilinear),
     the largest per-field PSNR gap printed; the trunk kernel on the
     trunk input of the first test field (batch 1 at LR 32x32x10) against
     its plain version (increment <= 3e-2); --use writes 23 finite LR/SR
     dumps; each pass launches the trunk and head kernels once per
     generate call; the first test field with the module head within 3e-2
     relative L2 of the pass's (the head kernel), times of one 128x128x10
     generate with either head and each pass's wall seconds;
  9. the long runs' loop and SR of any extent, in phase 7's temporary
     directory on its data: (a) phase 7's leg with steps_per_dispatch 4
     and --profile, 6000 -> 6008 in two chunks (6001-6004 G, G, G, D;
     6005-6008 D, D, D, G) through CUDA graphs of the step, each kind
     warmed up and captured on its first use and then replayed (6
     replays): launches (10, 4, 10, 4, 10) with the replays counted, the
     state at 6008 against phase 7's ckpt_6008 tree by tree (bit-exact,
     or within 1e-3 relative L2), the capture seconds, the pool's bytes,
     the chunked loop's G and D step beside phase 7's, and from the trace
     the card's busy share over the window, the top 5 device operations
     and the names of kernels 1-4; (b) the host data path
     (device_resident_data off), 6000 -> 6004 per step: launches (4, 3, 6,
     3, 4), finite losses, the G step beside phase 7's and the seconds the
     loop waited on the prefetch queue; (c) WindFieldSR.upscale_tiled of
     the 6k pack at tile 16 (the server's), overlap 4, batch 8: the first
     test field of phase 8 (9 tiles, 2 batches) against _upscale_tiled_host
     (<= 1e-6 relative L2) and a direct upscale (median error over the
     standard deviation <= 0.25, JAX's bound), then a 512x512x10 field
     (121 tiles, 16 batches) with the module head and through kernel 5,
     its ms, HR voxels/s and one trunk (and head) launch per batch.
  10. deploy what the port trains, in phase 7's temporary directory on
     its data with a copy of configs/test_milestone6k.ini and the 6k pack:
     (a) the int8 conv kernels (conv_int8.cu, int8 wgmma): their ptxas
     report and IGMMA count (0 fails), each entry point bit for bit
     against its plain version (float64 F.conv3d and the epilogue's float
     ops) at the full-width shape it serves: the last growth conv 224->32
     requantized into columns 224..255 of its RDB buffer and the LFF
     256->128 with bias at LR 16x16x10 batch 8 (the LFF beside
     torch._int_mm on its operands, which must give its int32 sums), the
     head pair (5x5x5 128->128 in bf16 and 1x1x5 128->400 partials, one
     launch) at HR 64x64x10 batch 8, each timed beside its bound at 1979
     TOPS; whether F.conv3d takes int8 on the card; the head pair at
     batch 8 and 32 beside its bound, its plain version, bf16 cuDNN of
     hr_conv0_x and kernel 5; (b) run.py --serve 0 --serve_int8 8
     --serve_int8_trunk 8 (its main, with eval.server.serve replaced to
     keep the backend) calibrates on the first 8 test fields; one batch
     of 8 other test fields through the exact bf16 path, the int8 head,
     the int8 trunk and both, within JAX's 2e-2 / 3e-2 / 4e-2 relative L2
     of the exact path (its module head), their PSNR against it, their launches as
     predicted (trunk kernel / conv_int8: (1, 0), (1, 1), (0, 240), (0,
     241)), every entry point launched, each int8 path's output equal bit
     for bit to the same batch through the entry points' plain versions
     on the card, and each path's serving ms at batch 8 and 32 beside
     kernel 5's; (c) run.py --export --device cpu, in a process of its
     own from phase 7's start, writes the artifact (bytes, export
     seconds); eval/server.py --artifact builds its ExportedSR on the
     card (seconds); at batch 1 and 8 it is within 1e-5 of WindFieldSR's
     plain path and 3e-2 of the kernel path, launching no kernel; its
     serving ms beside the kernel path's; a subprocess importing only
     torch, json and struct runs the payload (1e-5; it reads the artifact
     on the host from phase 10's start and goes to the card when (c)
     starts); (d) eval.interp
     --device cpu, in a process of its own from phase 7's start, blends
     the 9k and 6k packs: alpha 1 and 0 reproduce each pack's generator
     tensor by tensor, alpha 0.5 writes an artifact that serves the 8 test
     fields on the card within 1e-5 of the blend's plain path (read by
     load_exported on the host in a process of its own from phase 10's
     start, moved to the card by ExportedSR.to when (c) starts, and done
     before (c) times anything). Both command lines run at a lower
     priority on the host's spare cycles.
  11. the reference's users, in phase 7's temporary directory on its
     data: (a) seeded full-width generators of configs/fullvol8x3k.ini
     and fullvol16x2k.ini written as reference G.pth files
     (save_reference_checkpoint) and read back bit for bit;
     WindFieldSR.from_checkpoint(cfg, G.pth) serves full volumes (8x: 8
     of LR 16x16x10 -> HR 128x128x10; 16x: 1 of LR 8x8x10), equal bit for
     bit to WindFieldSR on the seeded weights, one trunk launch a batch,
     each forward's ms; a seeded milestone9k D (statistics moved) through
     D.pth forwards bit for bit as the seeded one; kernel 1 against its
     plain version on the trunk input of each served batch and of one
     volume at 8x (LR 16x16x10 batch 8 and 1) and 16x (8x8x10 batch 1),
     its residual mode and kernel 2 at 8x batch 8, and kernels 3 and 4 at
     HR 128x128x10 batch 8 and 1 and 64x64x10 batch 8 (the search's),
     with the adjoint identity, at phase 3's limits; (b) run.py --test on a
     copy of fullvol8x3k from G.pth: 23 finite rows, one trunk launch per
     field, PSNR against trilinear (seeded weights: no quality bound);
     (c) run.py --train on a copy of fullvol8x3k warm-started from G.pth,
     4 G steps at batch 8 (no-adv, as committed) and one validation:
     finite totals, G and its EMA at the first step the imported G,
     launches 4 x (1, 1, 2, 1, 1) plus the validation batches' and one
     generate's, the G step's ms; (d) run.py --param_search on a copy of
     milestone9k at batch 8, niter 4, validation every 2 its,
     --num_samples 3 --asha_grace 2 --asha_eta 2: 3 records with finite
     PSNRs, stops only at ASHA's rungs, each trial's first G-step total
     within 1e-5 of the sum of its own weights' losses (recomputed with
     unit weights on a copy of its state, batch and draws, after the
     search's launches are read), trial 0 against a bare
     weighted train_step loop from its seed (bit-exact, or within 1e-3
     relative L2), launches as its G steps and validation batches
     predict, seconds per trial; (e) optimizer_state_dtype bfloat16_sr on
     a copy of milestone9k at batch 32: steps 48-51 (G, G, D, D) through
     train_step and through train_chunk (CUDA graphs, 2 replays) from
     copies of one state on the batches batch_at cuts: bit for bit,
     moments bf16 and their bytes against float32's, launches (4, 2, 4,
     2, 4) each, the G step's ms (median of its 49 and the next two G
     steps) beside phase 6's float32 one.
  12. conv_mode = horizontal_3D and D's instance norm at full width: a
     copy of configs/milestone9k.ini with [GAN] conv_mode = horizontal_3D
     and [DISCRIMINATOR] norm_type = instance written in phase 7's
     temporary directory, all else as committed (bf16, batch 32, seeded
     weights at the config's init scales, slicing, use_pallas_stencil),
     on batches batch_at cuts from phase 11's resident volumes: (a) G's
     and D's parameter counts and a growth conv's init std within 3 % of
     JAX's fan-in sqrt(2 s^2/(W 27 Cin)); (b) the horizontal conv against
     a per-window F.conv3d loop in float32 (<= 1e-4) on the state's own
     kernels: a growth conv 224->32 at LR batch 8, hr_conv0 144->144 (k =
     5) at HR batch 2, D's strided (4, 4, 3) conv with stride (2, 2, 1)
     and its head_conv1 with stride (1, 1, 2); instance norm against
     float64 (<= 1e-5); (c) one G step's bf16 gradients with kernels 3
     and 4 against the same step with the plain stencil (<= 5e-2); (d)
     steps 48-51 (G, G, D, D) and one val_step as in phase 5: launches
     (0, 0, 2, 1, 0) per G step, none per D step, (0, 0, 6, 2, 0) in all;
     (e) steps 49 and 50 through train_chunk's CUDA graphs from a copy of
     the state against train_step (bit-exact, or within 1e-3 relative
     L2); (f) WindFieldSR serves a batch of 8 with no kernel launch, bit
     for bit gan.generate with the EMA, and its ms; (g) the G and D steps'
     CUDA-event ms (the second of each in (d)) beside phase 6's and the G
     step by kernel; (h) peak memory and the phase's seconds.
  13. the data mesh (parallel/), milestone9k as committed (bf16, batch 32);
     its processes start at phase 12's start, at a lower priority, so that
     their start-up takes the host's spare cycles beside phase 12 ((c)'s
     two take the card after phase 14's references): the
     card's compute mode (an exclusive one fails: (c) needs two processes
     on it); (a) python -m torch.distributed.run --standalone
     --nproc_per_node=1 -m gan_sr_wind_field_tpu_torch.run --train on
     phase 7's copy of milestone9k and data, resuming phase 7's
     one-process ckpt_6004 to 6008: exit 0, the status log's NCCL data
     axis of 1 and resume at 6004, a finite logged loss at 6008, its
     ckpt_6008 equal to phase 7's uninterrupted leg's (bit-exact, or
     within 1e-3 relative L2 as phase 7); (b) phase 5's steps 48-51 and val_step again on an
     NCCL mesh of one in this process, from phase 5's state on its batches:
     each step's launches as phase 5's, G, EMA, D and D's statistics within
     1e-6 relative L2 of phase 5's, and whether equal bit for bit; (c) two
     processes sharing the card over gloo, batch 16 each of one batch of
     32, from phase 5's seeded state: their G gradients (bf16) summed over
     the two against this process's at batch 32 (rel L2 <= 1e-2), their D
     gradients in float32 (<= 1e-4; bf16's printed beside one process's
     bf16-against-float32 gap), their losses (<= 1e-3 relative); then,
     once (a) has ended and phase 14's processes have built their models,
     steps 49 (G) and 50 (D), alone on the card, each step's launches as
     phase 5's, its ms (host clock) and all_reduce ms, the peak memory
     (two ranks time-sharing one card: no multi-card figure), the two
     ranks' state checksums equal; (d) WindFieldSR(mesh=).upscale of 8
     fields on those two: equal bit for bit to one process on each rank's
     rows, within 1e-2 of one process at batch 8, one trunk launch each;
     (e) the same two as data 1 x model 2, G's output channels over them
     (parallel/model.py): from phase 5's seeded state one D step (it 50)
     then one G step (it 49) on milestone9k as committed at a global batch
     of 16 (bf16) and on its float32 copy at 2, against this process on
     the same batches and path (kernels 1, 2 and 5 off, as on the mesh),
     computed alone on the card at phase 13's start: G's gradients
     gathered whole (bf16 rel L2 <= 1e-2, float32 <= 1e-4), D's (float32
     <= 1e-4; bf16 printed), the losses (bf16 <= 1e-3) and the physics
     terms (float32 <= 1e-5); kernels 3 and 4 counted on each rank's G
     steps, kernels 1, 2 and 5 on none; both ranks' whole states (G
     gathered) equal; per rank and step its ms and the model axis's
     collectives (count, bytes, ms); 8 fields served on the model mesh
     within 1e-2 of one process.
  14. the spatial axis (parallel/halo.py): configs/fullvol.ini at full
     width (nf 128, 16 RRDB, gc 32, hr_kern 5, whole 128x128x10 volumes
     from phase 11's resident volumes, seeded weights) on its own mesh of
     data 2 x spatial 4: eight processes sharing the card over gloo, each
     on its rows and its x slab of 32 planes, started at phase 12's start
     at a lower priority. Their one-process references run in this
     process at phase 13's start, alone on the card; then the eight build
     their models on the card beside phase 13's untimed work, and get
     their go once phase 13's processes have ended, so that they have the
     card to themselves. From phase 12 on this process keeps to 0.9 of
     the card's memory. From one
     seeded state, D step (it 50) then G step (it 49, the same weights):
     (a) as committed (bf16, batch 8): G gradients summed over the eight
     against one process (rel L2 <= 1e-2), losses (<= 1e-3 relative),
     every rank's state equal after the steps, D's bf16 gradients printed;
     (b) a float32 copy with use_pallas_stencil at batch 2 (one row per
     data rank): G and D gradients (<= 1e-4), the four physics terms (<=
     1e-5 relative), kernels 3 and 4 counted on every rank (>= 2 and >= 1
     a G step), and on each rank's slab widened by its halo the kernels
     against their plain versions (<= 1e-5); (c)
     WindFieldSR(mesh=).upscale of 8 volumes: within 1e-2 of one process,
     the whole batch on every rank; (d) the same eight ranks on all three
     axes, data 2 x model 2 x spatial 2 (each rank at JAX's row-major
     place): (b)'s float32 steps from (b)'s seeded state against (b)'s
     one-process references, G (gathered) and D <= 1e-4, physics <= 1e-5,
     kernels 3 and 4 on every rank's haloed slab, kernels 1, 2 and 5 on
     none, every rank's whole state equal. Each rank's steps (host clock)
     with their halo exchanges (count, bytes, ms), model-axis collectives,
     gathers and the gradients' all_reduce, the one-process steps, peak
     memory, the phase's seconds.
  15. the real-data path, once phase 14's ranks have ended, alone on the
     card, in phase 7's temporary directory: (a) raw HARMONIE-SIMRA files
     written with the port's analytic fields (netCDF3 classic through
     scipy) for 2018-03-01 to 03, T00Z and T12Z, 13 timesteps at the raw
     extent x 136 x y 135 whose crop is 128 x 128, 12 raw levels (the crop
     keeps 1..10), x_wind_ml as int16 with scale_factor, add_offset and
     _FillValue, one file (03-02 T12Z) left out and one hour (03-01 05)
     with a fill voxel; (b) run.py --download (its main, in process) on a
     copy of milestone9k with those dates, urllib.request.urlretrieve
     replaced by a counter that raises: exactly one fetch attempt, for
     the absent file, which invalid_files.txt names; the filled hour in
     filtered_samples.txt and not cached; every cached hour and the
     static file equal bit for bit to the raw files re-read with numpy
     (unpacked, cropped, transposed, z reversed, float64); a second
     --download fetches nothing and rewrites no file; (c) run.py --train
     without --synthetic on that copy (bf16, batch 32, device-resident
     data, on-card augmentation, the warm start from the 6k pack), 6000 ->
     6004 with one validation and the save at 6004: finite logged losses,
     the resident volumes equal to the cached hours after
     reformat_sample, each of kernels 1 to 4 launched as the leg's G and
     D steps, validation batches and generate calls predict, and so does
     kernel 5, conv_int8 not at all; (d) run.py --test from its ckpt_6004
     on the held-out hours: one CSV row each and the averages row, finite
     PSNRs, one kernel-1 and one kernel-5 launch per generate. Each part's seconds; the phase's
     launches in the kernel line (launches_real_data).
  16. the long run as the configs' headers say to run it, alone on the
     card in phase 7's temporary directory on its data: (a) the port's
     supervisor (gan_sr_wind_field_tpu_torch/scripts/supervise_train.py,
     its supervise() with max_restarts 2 and backoff_s 0) on a copy of
     milestone9k with niter 6008 and phase 7's schedule (saves at 6004
     and 6008), use_tensorboard_logger as committed; each leg a process
     of its own running run.main(["--train", "--synthetic", ...]) with the
     launch counters from 0, its counts written at its end. Its three
     processes (leg 0, leg 1, the export) start at phase 15's start and
     import torch and the port and create their CUDA context beside it,
     then wait for their request: the supervisor's runner (this script's
     --supervised-leg mode) hands its leg to the next one and exits with
     its code; (b) once leg 0 has written ckpt_6004/state.pt
     it gets SIGTERM, the watchdog's signal: it exits 0 with a checkpoint
     at k, 6004 <= k < 6008 (a signal after its end fails), the
     supervisor writes ..._resume_leg1.ini with state_load_path at
     ckpt_k, leg 1 resumes at k, validates at 6008 and exits 0: two legs,
     the last at 6008; (c) each leg's launches as its own G and D steps,
     validation batches and generate calls predict, kernel 5 too,
     conv_int8 none; leg 1's ckpt_6008 against phase 7's uninterrupted
     one tree by tree (G, EMA, D, D's statistics, both Adam states) and
     the generator state: bit-exact, or within 1e-3 relative L2, each
     tree's largest difference printed; (d) python -m
     gan_sr_wind_field_tpu_torch.scripts.export_continuation on leg 1's
     run folder (runpy, as python -m runs it), in a process of its own on
     the card, beside (c) and (e):
     its pack's arrays against phase 8's bf16 pack of phase 7's live state
     (bit for bit where (c) is bit-exact, else within (c)'s tolerance),
     its bytes and seconds; (e) summarize() of leg 1's run folder:
     last_it 6008, its ckpt_6008, finite tails. Each leg's wall seconds
     and its start-up to its first step; the phase's seconds.
  The 6k pack is read from disk once, at phase 7's warm start, and every
  later reader in this process (phases 8 to 10 and 15) takes its arrays
  (PackMemo); phase 16's leg 0 reads it in its own process.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.

--stencils-of ROOT builds, checks (phase 3) and times (phase 6) only the
stencil pair of the port in the checkout at ROOT, and prints no result
line: two checkouts are compared by running it for each, in turns, in one
run on one card.
"""

import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

T0 = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "configs", "milestone9k.ini")
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # CUDA-core float32 peak, H100 SXM data sheet
H100_HBM_BYTES_S = 3.35e12
TIMEOUT_S = 120.0
CSRC = "gan_sr_wind_field_tpu_torch/ops/kernels/csrc"
TPU = "gan_sr_wind_field_tpu/ops/pallas"
# one step's launches of (trunk, trunk backward, gradient, adjoint, head)
# on milestone9k as committed: on the card in bf16 every G forward takes the
# head kernel (models/generator.py:choose_head)
G_STEP_LAUNCHES = (1, 1, 2, 1, 1)
D_STEP_LAUNCHES = (1, 0, 0, 0, 1)
LAUNCH_LABELS = "trunk/bwd/gradient/adjoint/head"
# phase 5's state's seed, the state phase 13's legs (b) to (d) start from
TRAIN_SEED = 2001
# the bf16 kernels on the tensor cores, by library: the trunk's tiles
# (trunk_mma.cuh) and the HR head's (head_mma.cuh, k = 5 and k = 3)
TC_KERNELS = {"rdb_trunk": ("tc_growth_fwd", "tc_lff_fwd"),
              "rdb_trunk_bwd": ("tc_growth_bwd", "tc_lff_bwd"),
              "hr_head": ("tc_head5", "tc_head3")}
# the tensor-core instruction each library's tiles issue
TC_MMA = {"rdb_trunk": "mma.sync", "rdb_trunk_bwd": "mma.sync",
          "hr_head": "wgmma"}
TURN_ROUNDS = 2
LONG_CALL_S = 0.1  # see cuda_ms
VERY_LONG_CALL_S = 0.2
# the card's names of kernels 3 and 4 (substrings of the profiler's keys)
STENCIL_KERNELS = {"gradient": "grad_fwd", "adjoint": "grad_adj"}
# the scratch read before a cold-L2 launch: 128 MiB, over twice the L2
FLUSH_BYTES = 128 << 20
# profiler windows device_ms tries before it fails
PROFILE_WINDOWS = 4
# limits set from measurements, reasons in PERF.md (section 6): the trainable
# trunk end to end, float32 (5.5e-4 measured, from LeakyReLU sign flips of
# pre-activations within rounding of 0), and one G step's bf16 gradients,
# kernels vs the module path (2.2e-2 measured; 1.0e-2 against autograd of
# the trunk's plain version, the rest the RRDB modules' own rounding)
TRAINABLE_TOL = 2e-3
G_GRAD_TOL = 5e-2
# HRHead's gradients end to end, float32 (7.843e-4 measured, from 6 of
# 11.8M head pre-activations within float32 rounding of 0 that take the
# other LeakyReLU slope; its backward on the plain output is held at 1e-4);
# reasons in PERF.md (section 6)
HEAD_GRAD_TOL = 5e-3


def log(msg=""):
    print(msg, flush=True)


def done(part):
    """Marks the end of a part of a phase, as ``phase_start`` its start."""
    log(f"  ({part} done at {time.monotonic() - T0:.1f} s)")


def phase_start(n):
    """Marks the start of phase n with the seconds since the smoke began,
    so a run shows where its time goes."""
    log(f"phase {n} starts at {time.monotonic() - T0:.1f} s")


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def rel_l2(a, b):
    import torch

    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double())).item()


def check(name, err, tol):
    log(f"  {name}: rel L2 {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        fail(f"{name} disagrees: {err:.3e} > {tol:.0e}")


def card_line():
    """The card's name and power limit as nvidia-smi gives them, logged."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def cuda_ms(fn, reps=5):
    """Mean CUDA-event ms of ``reps`` calls after one warm-up; a call whose
    warm-up took over LONG_CALL_S gets at most 2 repeats, one over
    VERY_LONG_CALL_S one (the smoke's time limit; the spread of such calls
    is about 1 %)."""
    import torch

    t0 = time.monotonic()
    fn()  # warm-up
    torch.cuda.synchronize()
    warm = time.monotonic() - t0
    if warm > VERY_LONG_CALL_S:
        reps = 1
    elif warm > LONG_CALL_S:
        reps = min(reps, 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate(kernel, library, rounds=TURN_ROUNDS):
    """A kernel and its library chain timed in turns, kernel-library-
    library-kernel, each turn as cuda_ms: (median kernel ms, median
    library ms, the kernel's and the library's turns)."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel))
        ls.append(cuda_ms(library))
        ls.append(cuda_ms(library))
        ks.append(cuda_ms(kernel))
    return statistics.median(ks), statistics.median(ls), ks, ls


def log_turns(label, turns, card):
    k_ms, l_ms, ks, ls = turns

    def each(ts):
        return ", ".join(f"{t:.3f}" for t in ts)

    log(f"{label}: kernel median {k_ms:.3f} ms ({each(ks)}), library "
        f"median {l_ms:.3f} ms ({each(ls)}); kernel "
        f"{'faster' if k_ms < l_ms else 'slower'} by "
        f"{max(k_ms, l_ms) / min(k_ms, l_ms):.2f}x ({card})")


# the card's kernels kernel_split names; any other is "other"
SPLIT_NAMES = (*TC_KERNELS["rdb_trunk"], *TC_KERNELS["rdb_trunk_bwd"],
               "bwd_prep", "bwd_add", *STENCIL_KERNELS.values(), "Memcpy",
               "Memset")
# the int8 serving paths' kernels: conv_int8's three (the head pair's
# signature holds DequantEpi too, so it comes first), kernel 1's, cuDNN's
INT8_SPLIT_NAMES = ("head_pair_kernel", "RequantEpi", "DequantEpi",
                    *TC_KERNELS["rdb_trunk"], "implicit_convolveNd",
                    "xmma_fprop", "elementwise")


def kernel_split(label, fn, card, names=SPLIT_NAMES, warm_up=True):
    """One call of fn under torch.profiler: the card's time by kernel
    (the first of ``names`` in a kernel's name, else "other") against the
    call's CUDA-event time, read from the trace's device events
    (read_trace: the profiler's key_averages takes tens of seconds over
    the ~30k launches of a step). The card is busy for the union of its
    events; the rest of the call is the card waiting on the host loop.
    ``warm_up`` calls fn once first (leave it to a caller whose fn has
    just run)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        _, busy, ops = read_trace(path)
    finally:
        os.remove(path)
    parts = {}
    for op, (ms, n) in ops.items():
        name = next((k for k in names if k in op), "other")
        total, count = parts.get(name, (0.0, 0))
        parts[name] = (total + ms, count + n)
    if not busy:
        log(f"{label}: the profiler saw no device time")
        return
    log(f"{label}: {wall:.3f} ms, the card busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} %) ({card})")
    summed = sum(ms for ms, _ in parts.values())
    for name, (ms, n) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        log(f"    {name:<19} {n:4d} launches {ms:9.3f} ms "
            f"({1e3 * ms / n:8.1f} us each, {100 * ms / summed:5.1f} %)")


def device_ms(fn, kernel, flush=None, reps=5):
    """The card's own time per launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn (after one
    warm-up); ``flush`` runs before each call, outside the kernel's time.
    The mean over the launches the trace holds (it may miss one). A window
    whose trace holds none of them (seen now and then, with the launch
    counters showing the launches; twice in a row once) is profiled again,
    up to PROFILE_WINDOWS windows, and said so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if kernel in e.key and e.self_device_time_total > 0]
        n = sum(e.count for e in hits)
        if 0 < n <= reps:
            return sum(e.self_device_time_total for e in hits) / n / 1e3
        log(f"  the profiler saw {n} launches of {kernel} in {reps} calls "
            f"(window {window + 1} of {PROFILE_WINDOWS})")
    fail(f"the profiler saw {n} launches of {kernel} in {reps} calls in "
         f"each of {PROFILE_WINDOWS} windows")


def ptxas_reports(log_text):
    """{kernel name: its ptxas lines} from an nvcc -Xptxas -v log."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.strip())
    return out


@functools.lru_cache(maxsize=None)
def sass_mma_counts(lib_path):
    """{kernel name: [HMMA, HGMMA, IMMA, IGMMA] instruction counts} in a
    built library, from cuobjdump -sass of the toolkit that built it; None
    without cuobjdump."""
    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, 0, 0, 0]
        elif fn:
            hit = re.search(r"\b(HG|H|IG|I)MMA\b", line)
            if hit:
                out[fn][("H", "HG", "I", "IG").index(hit.group(1))] += 1
    return out


def report_tc_kernels(built):
    """Phase 2 for the bf16 tensor-core kernels: each one's ptxas report and
    HMMA/HGMMA count. Returns {library: the count over its kernels}
    (None where cuobjdump is missing); fails on a count of 0, and on no
    HGMMA in a library whose tiles issue wgmma."""
    counts = {}
    for lib, names in TC_KERNELS.items():
        path, _, report = built[lib]
        ptxas = ptxas_reports(report)
        sass = sass_mma_counts(path)
        counts[lib] = None if sass is None else 0
        for name in names:
            for fn, lines in ptxas.items():
                if name in fn:
                    log(f"  {lib} {name} ptxas: {'; '.join(lines)}")
            if sass is None:
                log(f"  {lib} {name}: cuobjdump not found, no SASS count")
                continue
            hmma, hgmma = (sum(c[i] for fn, c in sass.items() if name in fn)
                           for i in (0, 1))
            n = hmma + hgmma
            log(f"  {lib} {name}: {n} HMMA/HGMMA instructions in its SASS "
                f"({hmma} HMMA, {hgmma} HGMMA)")
            if n == 0:
                fail(f"{name} has no tensor-core instruction in its SASS")
            if TC_MMA[lib] == "wgmma" and hgmma == 0:
                fail(f"{name} issues no wgmma (HGMMA) in its SASS")
            counts[lib] += n
    return counts


def module_head(obj):
    """``obj``, a WindFieldSR or WindFieldGAN, with hr_conv0 on its modules
    in every forward: on the card in bf16 milestone9k takes the head
    kernel wherever it fits (choose_head), and the smoke holds it against
    the module head beside it."""
    if hasattr(obj, "head_packed"):
        obj.head_packed = None
    else:
        obj._head_train = obj._head_nograd = "modules"
    return obj


def counters():
    from gan_sr_wind_field_tpu_torch.train.step_graphs import launch_counts

    return launch_counts()


def reset_counters():
    from gan_sr_wind_field_tpu_torch.ops import (
        conv_int8,
        hr_head,
        rdb_trunk,
        stencil,
    )

    rdb_trunk.launches = rdb_trunk.bwd_launches = 0
    stencil.launches = stencil.adjoint_launches = 0
    hr_head.launches = 0
    conv_int8.launches = conv_int8.pair_launches = 0
    conv_int8.requant_launches = 0


def int8_launches(each=False):
    """conv_int8's launches: the head pair's, the requantizing growth
    conv's and the conv's (each), or their sum."""
    from gan_sr_wind_field_tpu_torch.ops import conv_int8

    n = (conv_int8.pair_launches, conv_int8.requant_launches,
         conv_int8.launches)
    return n if each else sum(n)


def cudnn_trunk(weights, x, per=3, rdb_scale=0.2, rrdb_scale=0.2, slope=0.2,
                keep=False):
    """The same trunk as one cuDNN call per conv in bfloat16 (the library
    yardstick for `library_ms`; the port never calls this). With ``keep``
    it also keeps every RDB's input state and growths, as the residual
    mode does, and returns (out, states, growths)."""
    import torch
    import torch.nn.functional as F

    s1 = torch.tensor(rdb_scale, dtype=x.dtype, device=x.device)
    s2 = torch.tensor(rrdb_scale, dtype=x.dtype, device=x.device)
    state = x.permute(0, 4, 1, 2, 3)
    rres = state
    states, growths = [], []
    nf = x.shape[-1]
    for j, (convs, w_lff, b_lff) in enumerate(weights):
        if j % per == 0:
            rres = state
        feats = state
        for w in convs:
            y = F.leaky_relu(F.conv3d(feats, w, padding=1), slope)
            feats = torch.cat([feats, y], dim=1)
        if keep:
            states.append(state)
            growths.append(feats[:, nf:])
        new = state + F.conv3d(feats, w_lff, b_lff) * s1
        if j % per == per - 1:
            new = rres + new * s2
        state = new
    out = state.permute(0, 2, 3, 4, 1)
    return (out, states, growths) if keep else out


def cudnn_trunk_bwd(weights, growths, d_out, per=3, rdb_scale=0.2,
                    rrdb_scale=0.2, slope=0.2):
    """The trunk backward-dx (d_x, dU, dLFF) as bf16 cuDNN transposed convs
    and cuBLAS matmuls (the library yardstick for the backward kernel's
    `library_ms`; the port never calls this)."""
    import torch
    import torch.nn.functional as F

    N, X, Y, Z, nf = d_out.shape
    ds = d_out.reshape(N, -1, nf)
    pend = ds
    dU, dLFF = [], []
    for j in range(len(weights) - 1, -1, -1):
        convs, w_lff, _ = weights[j]
        gc = convs[0].shape[0]
        d_r = ds
        if j % per == per - 1:
            pend, d_r = ds, ds * rrdb_scale
        d_lff = d_r * rdb_scale
        d_cat = d_lff @ w_lff[:, :, 0, 0, 0]
        d_s, dg = d_r + d_cat[..., :nf], d_cat[..., nf:]
        dus = [None] * len(convs)
        for k in range(len(convs) - 1, -1, -1):
            g_k = growths[j][..., k * gc:(k + 1) * gc]
            dg_k = dg[..., k * gc:(k + 1) * gc]
            d_u = torch.where(g_k >= 0, dg_k, dg_k * slope)
            dus[k] = d_u
            back = F.conv_transpose3d(
                d_u.view(N, X, Y, Z, gc).permute(0, 4, 1, 2, 3), convs[k],
                padding=1).permute(0, 2, 3, 4, 1).reshape(N, X * Y * Z, -1)
            d_s = d_s + back[..., :nf]
            if k:
                dg = torch.cat([dg[..., :gc * k] + back[..., nf:],
                                dg[..., gc * k:]], dim=-1)
        if j % per == 0:
            d_s = d_s + pend
        ds = d_s
        dU.append(torch.cat(dus, dim=-1))
        dLFF.append(d_lff)
    return ds, dU, dLFF


def serving_stages(sr, lr, z, geom):
    """(name, ms) of each layer of the serving forward, timed alone on
    the inputs the forward gives it (models/fused_apply.py order)."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import rrdb_trunk
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy

    G = sr.G
    stages = []
    with torch.inference_mode():
        lr = lr.to(G.dtype)
        f = G.feature_conv(lr)
        stages.append(("feature_conv", lambda: G.feature_conv(lr)))
        f = f.contiguous()
        tr = rrdb_trunk(sr.packed, f, **geom)
        stages.append(("trunk kernel", lambda: rrdb_trunk(sr.packed, f,
                                                          **geom)))
        stages.append(("lr_conv", lambda: G.lr_conv(tr)))
        h = f + G.lr_conv(tr)
        for i, up in enumerate(G.upconvs):
            h_in = upsample_nearest_xy(h, 2)
            stages.append((f"upconv{i}", lambda up=up, h_in=h_in: up(h_in)))
            h = up(h_in)
        zt = z.to(G.dtype)
        t = G.terrain_conv1(G.terrain_conv0(zt))
        stages.append(("terrain convs", lambda: G.terrain_conv1(
            G.terrain_conv0(zt))))
        stages.append(("hr_conv0_x", lambda: G.hr_conv0_x(h)))
        stages.append(("hr_conv0_t", lambda: G.hr_conv0_t(t)))
        a = F.leaky_relu(G.hr_conv0_x(h) + G.hr_conv0_t(t), G.negative_slope)
        stages.append(("hr_conv1", lambda: G.hr_conv1(a)))
        return [(name, cuda_ms(fn)) for name, fn in stages]


def sample(rng, n, lr_xy, hr_xy, zl, C):
    """A seeded LR batch (noise) and a cumulative-sum terrain height Z."""
    import numpy as np

    lr = rng.standard_normal((n, lr_xy, lr_xy, zl, C)).astype(np.float32)
    z = np.cumsum(rng.random((n, hr_xy, hr_xy, zl, 1)), axis=3)
    return lr, (z / z.max()).astype(np.float32)


def trunk_macs(rows, J, nf, gc, K):
    return rows * J * (27 * gc * sum(nf + gc * k for k in range(K))
                       + (nf + gc * K) * nf)


def bound(flops, nbytes, flop_rate):
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def check_trunk_kernels(rrdbs, x, d_out, geom, nf, gc, nconv, dev):
    """Phase 3, trunk: forward (both modes), backward and the trainable
    trunk against their plain versions. Returns the bf16 max abs errors
    of the forward and the backward."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import (
        TrainableTrunk,
        trunk_vjp,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    p32 = pack_trunk_weights(rrdbs, torch.float32, dev)
    p16 = pack_trunk_weights(rrdbs, torch.bfloat16, dev)
    log("trunk forward, no residuals (increment trunk(x) - x):")
    got32 = rrdb_trunk(p32, x, **geom)
    want32 = rrdb_trunk_reference(p32, x, **geom)
    check("fp32 kernel vs fp32 plain", rel_l2(got32 - x, want32 - x), 1e-4)
    x16 = x.to(torch.bfloat16)
    xf = x16.float()
    got16 = rrdb_trunk(p16, x16, **geom).float()
    check("bf16 kernel vs fp32 plain",
          rel_l2(got16 - xf, rrdb_trunk_reference(p32, xf, **geom) - xf),
          3e-2)
    same16 = rrdb_trunk_reference(p16, x16, **geom).float()
    max_abs_fwd = (got16 - same16).abs().max().item()
    check("bf16 kernel vs bf16 plain", rel_l2(got16 - xf, same16 - xf), 3e-2)
    log(f"  bf16 max abs {max_abs_fwd:.3e} of max |out| "
        f"{same16.abs().max().item():.3e}")
    del got32, want32, got16, same16

    max_abs_bwd = 0.0
    for name, packed, tol in (("fp32", p32, 1e-4), ("bf16", p16, 3e-2)):
        xin = x.to(packed["lff"].dtype)
        log(f"trunk forward, residual mode, {name}:")
        got = rrdb_trunk(packed, xin, with_residuals=True, **geom)
        want = rrdb_trunk_reference(packed, xin, with_residuals=True, **geom)
        check("out increment", rel_l2(got[0].float() - xin.float(),
                                      want[0].float() - xin.float()), tol)
        check("states", rel_l2(got[1].float(), want[1].float()), tol)
        check("growths", rel_l2(got[2].float(), want[2].float()), tol)
        growths = want[2]
        del got, want
        log(f"trunk backward, {name}:")
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        dout = d_out.to(xin.dtype)
        got = rrdb_trunk_bwd(packed_t, growths, dout, **geom)
        want = rrdb_trunk_bwd_reference(packed_t, growths, dout, **geom)
        for label, g, w in zip(("d_x", "dU", "dLFF"), got, want):
            check(label, rel_l2(g.float(), w.float()), tol)
            if name == "bf16":
                max_abs_bwd = max(max_abs_bwd,
                                  (g.float() - w.float()).abs().max().item())
        del got, want, growths

    log("trainable trunk, fp32, gradients vs autograd of the plain trunk:")
    tgt = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)
                      ).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in p32.items()}
        xv = x.clone().requires_grad_()
        if kernel:
            out = TrainableTrunk.apply(leaves["conv"], leaves["lff"],
                                       leaves["bias"], xv, geom)
        else:
            out = rrdb_trunk_reference(leaves, xv, **geom)
        (out * tgt).sum().backward()
        grads.append([leaves["conv"].grad, leaves["lff"].grad,
                      leaves["bias"].grad, xv.grad])
    labels = ("conv weights", "LFF weights", "LFF bias", "input")
    with torch.no_grad():
        # the Function's backward on the plain forward's residuals: the
        # backward kernel and the dW stage against autograd, same masks
        _, states, growths = rrdb_trunk_reference(p32, x, with_residuals=True,
                                                  **geom)
        vjp = trunk_vjp(p32["conv"], p32["lff"], states, growths, tgt, geom)
        for label, g, w in zip(labels, vjp, grads[1]):
            check(f"backward on the plain residuals, {label}", rel_l2(g, w),
                  1e-4)
        # end to end the two forwards differ in the last bit, and a growth
        # pre-activation that close to 0 takes the other LeakyReLU slope
        _, _, g_kernel = rrdb_trunk(p32, x, with_residuals=True, **geom)
        flips = ((g_kernel >= 0) != (growths >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {growths.numel()}")
        del states, growths, g_kernel
    for label, g, w in zip(labels, *grads):
        check(f"end to end, {label}", rel_l2(g, w), TRAINABLE_TOL)
    return max_abs_fwd, max_abs_bwd


def stencil_inputs(dev, n=32, xy=64, zl=10):
    """Training-shape field, cotangent, 150 m grid and a terrain-following
    Z: a smooth terrain plus positive per-column increments."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2001)
    uvw = rng.standard_normal((n, xy, xy, zl, 3)).astype(np.float32)
    g9 = rng.standard_normal((n, xy, xy, zl, 9)).astype(np.float32)
    coords = np.arange(xy, dtype=np.float32) * 150.0
    xx = np.linspace(0, 2 * np.pi, xy)
    terrain = 200.0 * np.add.outer(np.sin(xx), np.cos(0.5 * xx))
    z = (terrain[None, :, :, None, None]
         + np.cumsum(10.0 + 20.0 * rng.random((n, xy, xy, zl, 1)), axis=3))
    return [torch.from_numpy(a).to(dev) for a in
            (uvw, coords, coords, z.astype(np.float32), g9)]


def check_stencil_kernels(dev, n=32, xy=64):
    """Kernels 3 and 4 against their plain versions and the adjoint
    identity at (n, xy, xy, 10): phase 3 at the training shape, phase 11
    at its own. Returns the max abs errors."""
    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

    uvw, x, y, Z, g9 = stencil_inputs(dev, n, xy)
    log(f"gradient stencil and adjoint at {tuple(uvw.shape)}:")
    got = stencil.wind_gradient(uvw, x, y, Z)
    want = wind_field_gradient(uvw, x, y, Z)
    check("gradient kernel vs plain", rel_l2(got, want), 1e-5)
    err_g = (got - want).abs().max().item()
    adj = stencil.wind_gradient_adjoint(g9, x, y, Z)
    want_a = stencil.wind_gradient_adjoint_reference(g9, x, y, Z)
    check("adjoint kernel vs plain", rel_l2(adj, want_a), 1e-5)
    err_a = (adj - want_a).abs().max().item()
    lhs = (got.double() * g9.double()).sum().item()
    rhs = (uvw.double() * adj.double()).sum().item()
    ident = abs(lhs - rhs) / abs(lhs)
    log(f"  adjoint identity <Lu, g> = {lhs:.6e}, <u, L^T g> = {rhs:.6e}, "
        f"rel {ident:.3e} (tol 1e-05)")
    if not ident <= 1e-5:
        fail(f"adjoint identity off by {ident:.3e}")
    return err_g, err_a


def time_stencils(dev, card):
    """Kernels 3 and 4 at the training shape: the CUDA-event time of 5
    back-to-back calls through the wrapper (host and card together), the
    card's own time per launch under torch.profiler with the L2 warm
    (back to back) and cold (a scratch buffer of FLUSH_BYTES read before
    each launch, so that the L2 holds none of its inputs and no dirty
    lines), the plain version's time and the bound. Returns
    {"gradient" | "adjoint": dict of ms, device_ms, device_ms_cold,
    plain_ms and bound}."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops import stencil
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient

    uvw, cx, cy, Z, g9 = stencil_inputs(dev)
    vox = uvw.numel() // 3
    scratch = torch.ones(FLUSH_BYTES // 4, device=dev)
    # per voxel and component: 3 axes x (3 mul + 2 add); z coefficients
    # ~16 operations per voxel; float32 on the CUDA cores. Bytes: the field,
    # the heights and the output once each.
    pairs = {
        "gradient": (lambda: stencil.wind_gradient(uvw, cx, cy, Z),
                     lambda: wind_field_gradient(uvw, cx, cy, Z),
                     bound(vox * (3 * 15 + 16), vox * (12 + 4 + 36),
                           H100_FP32_FLOPS)),
        "adjoint": (lambda: stencil.wind_gradient_adjoint(g9, cx, cy, Z),
                    lambda: stencil.wind_gradient_adjoint_reference(
                        g9, cx, cy, Z),
                    bound(vox * (3 * 17 + 3 * 16), vox * (36 + 4 + 12),
                          H100_FP32_FLOPS)),
    }
    out = {}
    log(f"stencil kernels at {tuple(uvw.shape[:4])}: event time of 5 calls "
        f"through the wrapper, the card's time per launch (profiler) with "
        f"the L2 warm and cold, the plain version ({card}):")
    for label, (fn, plain, b) in pairs.items():
        kernel = STENCIL_KERNELS[label]
        ms = cuda_ms(fn)
        warm = device_ms(fn, kernel)
        cold = device_ms(fn, kernel, flush=scratch.sum)
        plain_ms = cuda_ms(plain)
        log(f"  {label} ({kernel}): event {ms:.4f} ms, card warm "
            f"{warm:.4f} ms, cold {cold:.4f} ms; plain {plain_ms:.3f} ms; "
            f"bound {b[0]:.4f} ms by {b[1]}: "
            + " / ".join(f"{100 * b[0] / t:.1f}" for t in (ms, warm, cold))
            + " % of it (event / warm / cold)")
        if not all(math.isfinite(v) for v in (ms, warm, cold, plain_ms)):
            fail("a stencil timing is not finite")
        out[label] = dict(ms=ms, device_ms=warm, device_ms_cold=cold,
                          plain_ms=plain_ms, bound=b)
    # the yardstick of a bytes-bound kernel on this card: a device-to-device
    # copy that moves the same bytes (half read, half written)
    src = torch.empty(vox * 52 // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy = device_ms(lambda: dst.copy_(src), "Memcpy")
    log(f"  copy of the same {2 * src.numel() / 1e6:.1f} MB, card warm "
        f"{copy:.4f} ms ({100 * pairs['gradient'][2][0] / copy:.1f} % of "
        f"the bound)")
    del scratch, src, dst
    return out


def stencils_of(root):
    """``--stencils-of ROOT``: build and check kernels 3 and 4 of the port
    under ROOT against their plain versions, then time them as phase 6
    does. Two checkouts are compared by running this once for each, in
    turns, within one run on one card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a card")
    sys.path.insert(0, os.path.abspath(root))
    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    card = card_line()
    log(f"stencil kernels of {os.path.abspath(root)}")
    for name, (path, secs, report) in build.build(["stencil"]).items():
        log(f"built {name} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    check_stencil_kernels(dev)
    time_stencils(dev, card)


def head_inputs(dev, n, xy, zl, nf, tc, C, k, seed, weights=None):
    """Head inputs at full width: x, t, a dropout scale with about 10 % of
    the channels zeroed, and (unless given) weights at init scale 1.0."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if weights is None:
        weights = [torch.randn(C, c, k, k, k, generator=gen)
                   * math.sqrt(2.0 / (c * k ** 3)) for c in (nf, tc)]
    x = torch.randn(n, xy, xy, zl, nf, generator=gen)
    t = torch.randn(n, xy, xy, zl, tc, generator=gen)
    dm = torch.where(torch.rand(n, C, generator=gen) < 0.9, 1 / 0.9, 0.0)
    return [w.to(dev) for w in weights] + [v.to(dev) for v in (x, t, dm)]


def plain_head(wx, wt, x, t, dm, k, slope=0.2):
    """Autograd's head: the two convs, LeakyReLU and the scale."""
    import torch.nn.functional as F

    hp = (k - 1) // 2
    pre = (F.conv3d(x.permute(0, 4, 1, 2, 3), wx, padding=hp)
           + F.conv3d(t.permute(0, 4, 1, 2, 3), wt, padding=hp))
    return (F.leaky_relu(pre, slope).permute(0, 2, 3, 4, 1)
            * dm[:, None, None, None, :])


def check_head_kernel(dev, xy, zl, nf, tc, C, k):
    """Phase 3, kernel 5: the HR-head kernel against its plain version at
    full width, batch 2, float32 and bf16, and HRHead's four gradients
    against autograd of the plain head. Returns the bf16 max abs error."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head,
        hr_head_conv,
        hr_head_conv_reference,
        hr_head_vjp,
        pack_head_weights,
    )

    wx, wt, x, t, dm = head_inputs(dev, 2, xy, zl, nf, tc, C, k, 2003)
    log(f"HR head at {tuple(x.shape)} + {tuple(t.shape)} -> C={C}, k={k}, "
        f"{(dm == 0).sum().item()} of {dm.numel()} channels dropped:")
    max_abs = 0.0
    for name, dt, tol in (("fp32", torch.float32, 1e-4),
                          ("bf16", torch.bfloat16, 1e-2)):
        packed = pack_head_weights(wx, wt, dt, dev)
        args = (packed, x.to(dt), t.to(dt), dm.to(dt))
        got = hr_head_conv(*args, k=k, negative_slope=0.2)
        want = hr_head_conv_reference(*args, k=k, negative_slope=0.2)
        check(f"{name} kernel vs {name} plain", rel_l2(got.float(),
                                                      want.float()), tol)
        if dt == torch.bfloat16:
            max_abs = (got.float() - want.float()).abs().max().item()
            log(f"  bf16 max abs {max_abs:.3e} of max |h| "
                f"{want.float().abs().max().item():.3e}")
        del got, want, args
    cot = torch.randn(x.shape[:4] + (C,), generator=torch.Generator()
                      .manual_seed(6)).to(dev)
    grads = []
    for kernel in (True, False):
        leaves = [v.clone().requires_grad_() for v in (wx, wt, x, t)]
        h = (hr_head(*leaves, dm, k=k, negative_slope=0.2) if kernel
             else plain_head(*leaves, dm, k))
        (h * cot).sum().backward()
        grads.append([v.grad for v in leaves])
        if kernel:
            h_kernel = h.detach()
    labels = ("dWx", "dWt", "dx", "dt")
    with torch.no_grad():
        # HRHead's backward on the plain forward's output: the same
        # LeakyReLU sides as autograd's, so only the sums' order differs
        h_plain = plain_head(wx, wt, x, t, dm, k)
        vjp = hr_head_vjp(wx, wt, x, t, dm, h_plain, cot, k=k,
                          negative_slope=0.2)
        for label, g, w in zip(labels, vjp, grads[1]):
            check(f"HRHead backward on the plain output, {label} (fp32)",
                  rel_l2(g, w), 1e-4)
        # end to end, a pre-activation within float32 rounding of 0 can
        # take the other LeakyReLU slope in the kernel than in cuDNN
        flips = ((h_kernel >= 0) != (h_plain >= 0)).sum().item()
        log(f"  head outputs on the other side of 0, kernel vs plain "
            f"forward: {flips} of {h_plain.numel()}")
    for label, g, w in zip(labels, *grads):
        check(f"HRHead end to end, {label} vs autograd (fp32)", rel_l2(g, w),
              HEAD_GRAD_TOL)
    return max_abs


def check_head_bf16(dev, wx, wt, x, t, dm, k, label):
    """The bf16 HR-head kernel against its bf16 plain version on x, t and
    the dropout scale dm (<= 1e-2: one rounding on each side)."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        hr_head_conv_reference,
        pack_head_weights,
    )

    bf = torch.bfloat16
    args = (pack_head_weights(wx, wt, bf, dev), x.to(bf), t.to(bf),
            dm.to(bf))
    with torch.no_grad():
        got = hr_head_conv(*args, k=k, negative_slope=0.2)
        want = hr_head_conv_reference(*args, k=k, negative_slope=0.2)
    check(f"HR head at {label} {tuple(x.shape)}, bf16 kernel vs bf16 plain",
          rel_l2(got.float(), want.float()), 1e-2)


def drive_steps(gan, state, batch, g_want, d_want, card, label,
                step_ms=None):
    """From it = 47 four train_steps (48, 49 G; 50, 51 D) and one
    val_step, with the counts set to 0 just before: finite losses and
    metrics, G and its EMA move on G steps only, D and its batch
    statistics on D steps only, and each kernel's launch count rises by
    what one step predicts. Returns the counts after the val step; with
    a dict ``step_ms`` each step's CUDA-event ms goes into it by
    iteration."""
    import torch

    state.it = 47
    reset_counters()
    for _ in range(4):
        lr, hr, z = batch()
        it = state.it + 1
        g_step = gan.is_g_step(it)
        snap = {name: {k: v.clone() for k, v in tree.items()} for name, tree
                in (("G", state.params_G), ("EMA", state.params_G_ema),
                    ("D", state.params_D), ("BN", state.batch_stats_D))}
        before = counters()
        t = time.monotonic()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, metrics = gan.train_step(state, lr, hr, z)
        ev[1].record()
        torch.cuda.synchronize()
        secs = time.monotonic() - t
        if step_ms is not None:
            step_ms[it] = ev[0].elapsed_time(ev[1])
        rose = tuple(a - b for a, b in zip(counters(), before))
        kind = "G" if g_step else "D"
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"  it {it} ({kind} step, {secs:.2f} s): "
            + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items()))
            + f"; launches {LAUNCH_LABELS} {rose}")
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"non-finite metric at it {it}")
        want = g_want if g_step else d_want
        if rose != want:
            fail(f"{kind} step launched {rose}, expected {want}")
        for name, tree in (("G", state.params_G), ("EMA", state.params_G_ema),
                           ("D", state.params_D), ("BN", state.batch_stats_D)):
            moved = any(not torch.equal(v, snap[name][k])
                        for k, v in tree.items())
            should = g_step == (name in ("G", "EMA"))
            if moved != should:
                fail(f"{name} {'moved' if moved else 'stood still'} on the "
                     f"{kind} step at it {it}")
    lr, hr, z = batch()
    metrics, _ = gan.val_step(state, lr, hr, z)
    vals = {k: float(v) for k, v in metrics.items()}
    log("  val: " + ", ".join(f"{k} {v:.4e}" for k, v in sorted(vals.items())))
    if not all(math.isfinite(v) for v in vals.values()):
        fail("non-finite validation metric")
    total = counters()
    log(f"  {label} launches (4 steps + val) {LAUNCH_LABELS} {total} ({card})")
    return total


def train_phase(cfg, dev, rng, card):
    """Phase 5: the milestone9k WindFieldGAN at batch 32 on the card.
    Returns what phase 6 times."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
        trunk_geometry,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        rrdb_trunk_reference,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    n = cfg.dataset_train.batch_size
    size, s = cfg.gan_config.slice_size, cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    C = cfg.lr_num_channels
    coords = np.arange(size, dtype=np.float32) * 150.0
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    if not gan.use_fused_trunk:
        fail("milestone9k does not take the trunk kernels in training")
    lr_shape = (n, size // s, size // s, zl, C)
    hr_shape = (n, size, size, zl, 3)
    state = gan.init_state(TRAIN_SEED, lr_shape, hr_shape)

    def batch():
        lr, z = sample(rng, n, size // s, size, zl, C)
        hr = 0.1 * rng.standard_normal(hr_shape).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (lr, hr, z)]

    log(f"train: milestone9k WindFieldGAN, batch {n}, LR {lr_shape}, "
        f"HR {hr_shape}, bf16")
    # one G step's gradients, kernels vs the plain trunk and stencil, on the
    # same weights, batch, dropout mask and noise draws
    lr, hr, z = batch()
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.use_fused_trunk = False
    plain_cfg.use_pallas_stencil = False
    plain = WindFieldGAN(plain_cfg, coords, coords, device=dev)
    plain.D = gan.D  # the same D module; its parameters come from the state
    gen = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[1]),
                      generator=gen, device=dev) < 0.9
    res = []
    for g in (gan, plain):
        gen = torch.Generator(device=dev).manual_seed(12)
        res.append(g.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
        torch.cuda.synchronize()
    # the plain path once more with autograd through the trunk's plain
    # version instead of the RRDB modules: it rounds where the kernels do,
    # so it splits the gap into the kernels' part and the module path's
    G_ref = plain.G

    def ref_trunk(x):
        packed = pack_trunk_weights(G_ref.rrdbs, G_ref.dtype, x.device,
                                    detach=False)
        return rrdb_trunk_reference(packed, x.contiguous(),
                                    **trunk_geometry(G_ref))

    def ref_forward(lr, z, train=False, trunk=None, head=None,
                    dropout_mask=None, generator=None, slab=None):
        return generator_forward(G_ref, lr, z, ref_trunk, train=train,
                                 dropout_mask=dropout_mask,
                                 generator=generator, slab=slab)

    G_ref.forward = ref_forward
    gen = torch.Generator(device=dev).manual_seed(12)
    res.append(plain.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
    torch.cuda.synchronize()
    (loss_k, _, grads_k), (loss_p, _, grads_p), (loss_r, _, grads_r) = res
    log(f"  G step total loss: kernels {loss_k.item():.6e}, plain "
        f"{loss_p.item():.6e}, plain trunk version {loss_r.item():.6e}")
    worst = max((rel_l2(a, b), name) for a, b, name in
                zip(grads_k, grads_p, state.params_G))

    def flat(gs):
        return torch.cat([g.flatten() for g in gs])

    err = rel_l2(flat(grads_k), flat(grads_p))
    log(f"  worst single tensor: {worst[1]} rel L2 {worst[0]:.3e}")
    log(f"  G gradients, kernels vs autograd of the trunk's plain version: "
        f"rel L2 {rel_l2(flat(grads_k), flat(grads_r)):.3e}; that vs the "
        f"module path: {rel_l2(flat(grads_r), flat(grads_p)):.3e}")
    names = list(state.params_G)
    for group, pick in (("trunk (rrdbs.*)", True), ("the rest", False)):
        idx = [i for i, k in enumerate(names)
               if k.startswith("rrdbs.") == pick]
        sub = [(grads_k[i], grads_r[i]) for i in idx]
        share = (torch.linalg.vector_norm(flat([b for _, b in sub]).double())
                 / torch.linalg.vector_norm(flat(grads_r).double())).item()
        log(f"    {group}: kernels vs plain trunk version rel L2 "
            f"{rel_l2(flat([a for a, _ in sub]), flat([b for _, b in sub])):.3e}"
            f", {share:.3f} of the gradient's norm")
    check("G gradients, kernels vs plain path (bf16)", err, G_GRAD_TOL)
    del plain, res, grads_k, grads_p, grads_r, G_ref
    torch.cuda.empty_cache()

    # the steps' state before and after them and their batches, on the
    # host, for phase 13 (b) to run again on a mesh
    recorded = []

    def recording():
        out = batch()
        recorded.append([t.cpu() for t in out])
        return out

    before = copy_state(state, "cpu")
    total = drive_steps(gan, state, recording, G_STEP_LAUNCHES,
                        D_STEP_LAUNCHES, card, "train path")
    steps = dict(before=before, after=copy_state(state, "cpu"),
                 batches=recorded, launches=total)
    return gan, state, batch, total, steps


def head_train_phase(cfg, gan, state, batch, dev, card):
    """Phase 5, the head: one G step's gradients of milestone9k as
    committed (the head kernel) against the same step with the module
    head (trunk kernels on both sides), at batch 32."""
    import torch

    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    if (gan._head_train, gan._head_nograd) != ("kernel", "kernel"):
        fail("milestone9k as committed does not take the head kernel")
    gan_m = module_head(WindFieldGAN(cfg, gan.x.cpu().numpy(),
                                     gan.y.cpu().numpy(), device=dev))
    n = cfg.dataset_train.batch_size
    log(f"train, the head: milestone9k as committed against the module "
        f"head, batch {n}, bf16")
    gan_m.D = gan.D  # the same D module; its parameters come from the state
    lr, hr, z = batch()
    gen = torch.Generator(device=dev).manual_seed(13)
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[1]),
                      generator=gen, device=dev) < 0.9
    res = []
    for g in (gan, gan_m):
        gen = torch.Generator(device=dev).manual_seed(14)
        res.append(g.g_grads(state, lr, hr, z, 48, gen, dropout_mask=keep))
        torch.cuda.synchronize()
    (loss_h, _, grads_h), (loss_m, _, grads_m) = res
    flat_h = torch.cat([g.flatten() for g in grads_h])
    flat_m = torch.cat([g.flatten() for g in grads_m])
    worst = max((rel_l2(a, b), name) for a, b, name in
                zip(grads_h, grads_m, state.params_G))
    log(f"  G step total loss: head kernel {loss_h.item():.6e}, module head "
        f"{loss_m.item():.6e}; worst single tensor {worst[1]} rel L2 "
        f"{worst[0]:.3e}")
    check("G gradients, head kernel vs module head (bf16)",
          rel_l2(flat_h, flat_m), 2e-2)
    del res, grads_h, grads_m, flat_h, flat_m, gan_m


def time_training(gan, state, batch, geom, nf, gc, nconv, dev, card):
    """Phase 6, training: the trunk kernels against their plain versions
    at batch 32, then G and D steps with their parts, and each training
    kernel beside its plain version, bound and library chain."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_train import _dw_stage
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    lr, hr, z = batch()

    def step(it):
        def fn():
            state.it = it - 1
            gan.train_step(state, lr, hr, z)
        return fn

    g_ms = cuda_ms(step(48))
    d_ms = cuda_ms(step(50))
    gen_ms = cuda_ms(lambda: gan.generate(state, lr, z))

    # the trunk kernels at the training batch, on the state's weights
    G = gan.G
    G.load_state_dict(state.params_G)
    with torch.no_grad():
        packed = pack_trunk_weights(G.rrdbs, torch.bfloat16, dev)
        lib_w = [([c.weight.to(torch.bfloat16) for c in rdb.convs],
                  rdb.lff.weight.to(torch.bfloat16),
                  rdb.lff.bias.to(torch.bfloat16))
                 for r in G.rrdbs for rdb in r.rdbs]
        # the trunk's input in a G step on this batch
        x = G.feature_conv(lr.to(G.dtype)).contiguous()
    n = lr.shape[0]
    gen = torch.Generator().manual_seed(3)
    d_out = torch.randn(x.shape, generator=gen).to(dev, torch.bfloat16)
    kw = dict(geom)
    with torch.no_grad():
        log(f"trunk kernels at batch {n}, trunk input of a training batch, "
            f"bf16 vs bf16 plain:")
        got = rrdb_trunk(packed, x, with_residuals=True, **kw)
        want = rrdb_trunk_reference(packed, x, with_residuals=True, **kw)
        xf = x.float()
        check("residual mode, out increment",
              rel_l2(got[0].float() - xf, want[0].float() - xf), 3e-2)
        check("residual mode, states",
              rel_l2(got[1].float(), want[1].float()), 3e-2)
        check("residual mode, growths",
              rel_l2(got[2].float(), want[2].float()), 3e-2)
        # a growth on the other side of 0 takes the other LeakyReLU slope
        # in the backward: what sets the G step's bf16 gradient gap
        flips = ((got[2] >= 0) != (want[2] >= 0)).sum().item()
        log(f"  growths on the other side of 0, kernel vs plain forward: "
            f"{flips} of {want[2].numel()} ({flips / want[2].numel():.3e})")
        _, states, growths = got
        del got, want
        packed_t = pack_trunk_weights_bwd(packed, nf=nf, gc=gc,
                                          num_convs=nconv)
        got = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **kw)
        for label, a, b in zip(("d_x", "dU", "dLFF"), got, want):
            check(f"backward, {label}", rel_l2(a.float(), b.float()), 3e-2)
        del got, want
        turns1 = alternate(
            lambda: rrdb_trunk(packed, x, with_residuals=True, **kw),
            lambda: cudnn_trunk(lib_w, x, keep=True))
        log_turns(f"trunk residual mode at batch {n} vs its bf16 cuDNN chain",
                  turns1, card)
        k1r_ms, k1r_lib_ms = turns1[:2]
        k1r_plain_ms = cuda_ms(lambda: rrdb_trunk_reference(
            packed, x, with_residuals=True, **kw))
        turns2 = alternate(
            lambda: rrdb_trunk_bwd(packed_t, growths, d_out, **kw),
            lambda: cudnn_trunk_bwd(lib_w, growths, d_out))
        log_turns(f"trunk backward at batch {n} vs its bf16 cuDNN/cuBLAS "
                  f"chain", turns2, card)
        k2_ms, k2_lib_ms = turns2[:2]
        k2_plain_ms = cuda_ms(lambda: rrdb_trunk_bwd_reference(
            packed_t, growths, d_out, **kw))
        kernel_split(f"trunk residual mode at batch {n}, by kernel",
                     lambda: rrdb_trunk(packed, x, with_residuals=True, **kw),
                     card)
        kernel_split(f"trunk backward at batch {n}, by kernel",
                     lambda: rrdb_trunk_bwd(packed_t, growths, d_out, **kw),
                     card)
        _, dU, dLFF = rrdb_trunk_bwd(packed_t, growths, d_out, **kw)
        dw_ms = cuda_ms(lambda: _dw_stage(states, growths, dU, dLFF,
                                          tuple(x.shape[:4]), nf, gc,
                                          nconv - 1))
        del states, growths, dU, dLFF
        st = time_stencils(dev, card)
    k3, k4 = st["gradient"], st["adjoint"]
    k3_ms, k4_ms = k3["ms"], k4["ms"]

    rows = x.numel() // nf
    J = len(lib_w)
    K = nconv - 1
    flops = 2 * trunk_macs(rows, J, nf, gc, K)
    w_bytes = 2 * sum(t.numel() for t in packed.values())
    res_bytes = 2 * J * rows * (nf + gc * K)
    b1 = bound(flops, 2 * 2 * x.numel() + w_bytes + res_bytes,
               H100_BF16_FLOPS)
    # backward: reads growths and d_out, writes d_x, dU and dLFF, reads
    # the transposed weights once
    b2 = bound(flops, 2 * (J * rows * gc * K + 2 * x.numel()
                           + J * rows * (gc * K + nf)) + w_bytes,
               H100_BF16_FLOPS)
    rest_g = g_ms - k1r_ms - k2_ms - dw_ms - 2 * k3_ms - k4_ms
    log(f"G step {g_ms:.3f} ms, D step {d_ms:.3f} ms, no-grad G forward "
        f"{gen_ms:.3f} ms at batch {n} ({card})")
    for label, ms in (("trunk kernel, residual mode", k1r_ms),
                      ("trunk backward kernel", k2_ms),
                      ("dW stage (cuDNN, cuBLAS)", dw_ms),
                      ("gradient kernel x2", 2 * k3_ms),
                      ("adjoint kernel", k4_ms),
                      ("rest: head/tail convs fwd+bwd, D, losses, Adam",
                       rest_g)):
        log(f"  G step part {label:<48} {ms:9.3f} ms "
            f"{100 * ms / g_ms:5.1f} %")
    parts = g_step_rest_parts(gan, state, lr, hr, z)
    for label, ms in parts:
        log(f"    rest part {label:<46} {ms:9.3f} ms "
            f"{100 * ms / g_ms:5.1f} %")
    gap = rest_g - sum(ms for _, ms in parts)
    log(f"    rest parts sum {rest_g - gap:.3f} ms of the rest's "
        f"{rest_g:.3f} ms; all parts {g_ms - gap:.3f} ms of the G step's "
        f"{g_ms:.3f} ms ({100 * (g_ms - gap) / g_ms:.1f} %)"
        + (f"; the parts miss {gap:.3f} ms" if abs(gap) > 0.1 * g_ms
           else ""))
    log(f"  D step part no-grad G forward {gen_ms:9.3f} ms "
        f"{100 * gen_ms / d_ms:5.1f} %, rest (D fwd+bwd twice, Adam) "
        f"{d_ms - gen_ms:9.3f} ms")
    for label, ms, plain_ms, b, lib in (
            ("trunk residual mode", k1r_ms, k1r_plain_ms, b1, k1r_lib_ms),
            ("trunk backward", k2_ms, k2_plain_ms, b2, k2_lib_ms)):
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib:.3f} ms, bound {b[0]:.4f} ms by {b[1]} (ops "
            f"{b[2]:.4f}, bytes {b[3]:.4f}); {100 * b[0] / ms:.2f} % of the "
            f"bound, {H100_BF16_FLOPS * b[2] / ms / 1e12:.1f} TFLOP/s")
    times = dict(g_ms=g_ms, d_ms=d_ms, k1r=(k1r_ms, k1r_plain_ms, b1),
                 k1r_lib=k1r_lib_ms,
                 k2=(k2_ms, k2_plain_ms, b2, k2_lib_ms), k3=k3, k4=k4)
    if not all(math.isfinite(v) for v in (g_ms, d_ms, gen_ms, k1r_ms, k2_ms,
                                           dw_ms, k3_ms, k4_ms, k2_lib_ms,
                                           k1r_lib_ms)):
        fail("a timing is not finite")
    return times


def g_step_rest_parts(gan, state, lr, hr, z):
    """(name, ms) of the G step's parts outside the trunk and stencil
    kernels, each timed alone (forward and backward, input and weight
    gradients where the G step takes them) on the tensors a G step on
    this batch gives it. G holds state.params_G."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.models.blocks import dropout_scale
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        kernel_trunk_fn,
    )
    from gan_sr_wind_field_tpu_torch.ops.hr_head import hr_head
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights,
        pack_trunk_weights_bwd,
    )
    from gan_sr_wind_field_tpu_torch.ops.resize import upsample_nearest_xy
    from gan_sr_wind_field_tpu_torch.train.gan import AdamState

    G = gan.G
    dt = G.dtype
    slope = G.negative_slope
    p = G.dropout_probability
    it = 48
    with torch.no_grad():
        f = G.feature_conv(lr.to(dt))
        tr = kernel_trunk_fn(G)(f)
        h0 = f + G.lr_conv(tr)
        h = h0
        for up in G.upconvs:
            h = up(upsample_nearest_xy(h, 2))
        zt = z.to(dt)
        t = G.terrain_conv1(G.terrain_conv0(zt))
        px, pt = G.hr_conv0_x(h), G.hr_conv0_t(t)
        a = F.leaky_relu(px + pt, slope)
        fake = G.hr_conv1(a).float()
        keep = torch.rand((lr.shape[0], 1, 1, 1, a.shape[-1]),
                          device=a.device) < 1.0 - p
        hr3 = hr[..., :3]
        y_pred = gan._d_apply(state.params_D, state.batch_stats_D, hr3,
                              train=False)
        fake_pred = gan._d_apply(state.params_D, state.batch_stats_D, fake,
                                 train=False)
        hr_grad = gan._wind_gradient(hr3, gan.x, gan.y, z)
        sr_grad = gan._wind_gradient(fake, gan.x, gan.y, z)

    def fwd_bwd(fn, modules, *inputs):
        leaves = [v.detach().requires_grad_() for v in inputs]
        params = [q for m in modules for q in m.parameters()]

        def run():
            out = fn(*leaves)
            torch.autograd.grad(out, leaves + params, torch.ones_like(out),
                                allow_unused=True)
        return run

    def ups(x):
        for up in G.upconvs:
            x = up(upsample_nearest_xy(x, 2))
        return x

    def small_convs(lr_, tr_, z_):
        return (G.feature_conv(lr_).float().sum()
                + G.lr_conv(tr_).float().sum()
                + G.terrain_conv1(G.terrain_conv0(z_)).float().sum())

    def packing():
        packed = pack_trunk_weights(G.rrdbs, dt, lr.device, detach=False)
        with torch.no_grad():
            pack_trunk_weights_bwd(packed, nf=G.num_features,
                                   gc=G.rdb_growth_channels,
                                   num_convs=G.num_rdb_convs)
        return torch.cat([v.flatten() for v in packed.values()])

    fake_l = fake.detach().requires_grad_()

    def d_part():
        gan._set_iteration(it)
        real_in = gan._noisy_d_input(hr3, 2.0, state.rng)
        fake_in = gan._noisy_d_input(fake_l, 2.0, state.rng)
        with torch.no_grad():
            gan._d_apply(state.params_D, state.batch_stats_D, real_in,
                         train=False)
        out = gan._d_apply(state.params_D, state.batch_stats_D, fake_in,
                           train=False)
        torch.autograd.grad(out.sum(), fake_l)

    def losses():
        # _g_losses with the G forward, the D forwards and the stencils
        # replaced by their outputs: the loss arithmetic alone
        fy_l = fake_pred.detach().requires_grad_()
        sg_l = sr_grad.detach().requires_grad_()
        preds = iter([y_pred, fy_l])
        saved = gan._wind_gradient
        gan._g_forward_train = lambda *a, **k: fake_l
        gan._d_apply = lambda *a, **k: next(preds)
        gan._wind_gradient = (lambda u, *a: sg_l if u.requires_grad
                              else hr_grad)
        try:
            total, _ = gan._g_losses(state.params_G, state, lr, hr, z, it,
                                     state.rng, True)
        finally:
            del gan._g_forward_train, gan._d_apply
            gan._wind_gradient = saved
        torch.autograd.grad(total, [fake_l, fy_l, sg_l], allow_unused=True)

    params = {k: v.clone() for k, v in state.params_G.items()}
    grads = [torch.randn_like(v) * 1e-4 for v in params.values()]
    opt = AdamState(torch.ones((), dtype=torch.int32, device=lr.device),
                    {k: torch.zeros_like(v) for k, v in params.items()},
                    {k: torch.zeros_like(v) for k, v in params.items()})
    ema = {k: v.clone() for k, v in params.items()}

    def adam_ema():
        gan._adam_step(params, grads, opt, 1e-4, *gan.opt_G)
        with torch.no_grad():
            for k, e in ema.items():
                e.add_(0.01 * (params[k] - e))

    scale = dropout_scale(lr.shape[0], a.shape[-1], p, dt, a.device, keep)
    parts = [
        # the committed G step's head: kernel 5 forward, cuDNN backward
        ("HR head (kernel 5, HRHead) fwd+bwd", fwd_bwd(
            lambda u, v: hr_head(G.hr_conv0_x.weight.to(dt),
                                 G.hr_conv0_t.weight.to(dt), u, v, scale,
                                 k=G.hr_kern_size, negative_slope=slope),
            [G.hr_conv0_x, G.hr_conv0_t], h, t)),
        ("hr_conv1 fwd+bwd", fwd_bwd(lambda v: G.hr_conv1(v).float(),
                                     [G.hr_conv1], a)),
        ("upsampling convs fwd+bwd", fwd_bwd(ups, G.upconvs, h0)),
        ("feature, lr_conv, terrain convs fwd+bwd", fwd_bwd(
            small_convs, [G.feature_conv, G.lr_conv, G.terrain_conv0,
                          G.terrain_conv1], lr.to(dt), tr, zt)),
        ("trunk weight packing fwd+bwd", fwd_bwd(packing, G.rrdbs)),
        ("D eval forwards x2, input gradient", d_part),
        ("losses fwd+bwd (no stencils)", losses),
        ("Adam and EMA", adam_ema),
    ]
    return [(name, cuda_ms(fn)) for name, fn in parts]


def library_head(wx, wt, x, t, dm, k, slope=0.2):
    """The head as bf16 cuDNN calls: both convs, their sum, LeakyReLU and
    the scale (the library yardstick for kernel 5's `library_ms`; the port
    never calls this)."""
    import torch.nn.functional as F

    hp = (k - 1) // 2
    pre = (F.conv3d(x.permute(0, 4, 1, 2, 3), wx, padding=hp)
           + F.conv3d(t.permute(0, 4, 1, 2, 3), wt, padding=hp))
    return F.leaky_relu(pre, slope) * dm[:, :, None, None, None]


def head_training_input(gan_h, state_h, batch):
    """The head's x and t in the head path's G forward on a training batch
    (the arguments of the HR-head kernel's launch, caught on their way)."""
    from gan_sr_wind_field_tpu_torch.ops import hr_head as head_mod

    caught = []
    launch = head_mod.hr_head_conv

    def catch(packed, x, t, dmask=None, **kw):
        caught.append((x, t))
        return launch(packed, x, t, dmask, **kw)

    lr, _, z = batch()
    head_mod.hr_head_conv = catch
    try:
        gan_h.generate(state_h, lr, z)
    finally:
        head_mod.hr_head_conv = launch
    return caught[0]


def time_head(sr, sr_h, gan_h, state_h, batch, lr_d, z_d, dims, dev, card):
    """Phase 6, kernel 5: at batch 32 on the head's input of a training
    batch, the bf16 kernel against its bf16 plain version; its time at
    batch 8 and 32 beside its plain version, bound and library call (bf16
    cuDNN, timed with cudnn.benchmark off and on), and the time of its
    cuDNN backward (hr_head_vjp) at batch 32; then the head path's serving
    forward at batch 8 and its G and D steps at batch 32."""
    import torch

    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        hr_head_conv_reference,
        hr_head_vjp,
        pack_head_weights,
    )

    xy, zl, nf, tc, C, k = dims
    x, t = head_training_input(gan_h, state_h, batch)
    Gh = gan_h.G
    Gh.load_state_dict(state_h.params_G)
    gen = torch.Generator().manual_seed(2006)
    dm = torch.where(torch.rand(x.shape[0], C, generator=gen) < 0.9,
                     1 / 0.9, 0.0).to(dev)
    check_head_bf16(dev, Gh.hr_conv0_x.weight.detach(),
                    Gh.hr_conv0_t.weight.detach(), x, t, dm, k,
                    "the head input of a training batch,")
    del x, t, dm
    G = sr.G
    w = [G.hr_conv0_x.weight.detach(), G.hr_conv0_t.weight.detach()]
    packed = pack_head_weights(*w, torch.bfloat16, dev)
    wb = [v.to(torch.bfloat16) for v in w]
    res = {}
    for n in (8, 32):
        _, _, x, t, dm = head_inputs(dev, n, xy, zl, nf, tc, C, k, 2004 + n,
                                     weights=w)
        x, t, dm = (v.to(torch.bfloat16) for v in (x, t, dm))
        kw = dict(k=k, negative_slope=0.2)
        lib = {}
        with torch.no_grad():
            ms = cuda_ms(lambda: hr_head_conv(packed, x, t, dm, **kw))
            plain_ms = cuda_ms(lambda: hr_head_conv_reference(packed, x, t,
                                                              dm, **kw))
            benchmark = torch.backends.cudnn.benchmark
            for mode in (False, True):
                torch.backends.cudnn.benchmark = mode
                try:
                    lib[mode] = cuda_ms(lambda: library_head(*wb, x, t, dm,
                                                             k))
                finally:
                    torch.backends.cudnn.benchmark = benchmark
        lib_ms = min(lib.values())
        rows = x.numel() // nf
        b = bound(2 * k ** 3 * (nf + tc) * C * rows,
                  2 * (x.numel() + t.numel() + rows * C + packed.numel()
                       + dm.numel()), H100_BF16_FLOPS)
        log(f"HR-head kernel at batch {n}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, cuDNN bf16 {lib[False]:.3f} ms "
            f"(cudnn.benchmark off), {lib[True]:.3f} ms (on); kernel "
            f"{'faster' if ms < lib_ms else 'slower'} than the faster by "
            f"{max(ms, lib_ms) / min(ms, lib_ms):.2f}x; bound "
            f"{b[0]:.4f} ms by {b[1]} (ops {b[2]:.4f}, bytes {b[3]:.4f}), "
            f"{100 * b[0] / ms:.2f} % of it; "
            f"{2 * k ** 3 * (nf + tc) * C * rows / ms / 1e9:.3f} TFLOP/s "
            f"({card})")
        res[n] = (ms, plain_ms, b, lib_ms, lib[False], lib[True])
        if n == 32:
            # the head's backward (cuDNN transposed convs), as a G step on
            # the head path runs it: all four gradients from the saved h
            h = hr_head_conv(packed, x, t, dm, **kw)
            dh = torch.randn(h.shape, generator=gen).to(dev, torch.bfloat16)
            with torch.no_grad():
                res["vjp"] = cuda_ms(lambda: hr_head_vjp(
                    *wb, x, t, dm, h, dh, k=k, negative_slope=0.2))
            log(f"  head part hr_head_vjp (cuDNN backward: dWx, dWt, dx, dt) "
                f"at batch {n}: {res['vjp']:.3f} ms ({card})")
            del h, dh
        del x, t, dm
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: sr_h._generate(lr_d, z_d))
    lr, hr, z = batch()

    def step(it):
        def fn():
            state_h.it = it - 1
            gan_h.train_step(state_h, lr, hr, z)
        return fn

    g_ms, d_ms = cuda_ms(step(48)), cuda_ms(step(50))
    vox = lr_d.shape[0] * xy * xy * zl
    log(f"head path: serving forward {fwd_ms:.3f} ms per batch of 8, "
        f"{vox / (fwd_ms / 1e3):.4e} HR voxels/s; G step {g_ms:.3f} ms, D "
        f"step {d_ms:.3f} ms at batch {lr.shape[0]} ({card})")
    if not all(math.isfinite(v) for v in (fwd_ms, g_ms, d_ms, *res[8][:2],
                                          *res[32][:2], *res[8][3:],
                                          *res[32][3:], res["vjp"])):
        fail("a timing is not finite")
    return res


# phase 7: the leg of milestone9k the loop trains (it 6000 -> 6008 from the
# 6k pack), its schedule cut so that 8 steps cross a G and a D block, one
# validation and two checkpoints (one periodic at LEG_MID, the final one)
LEG_FROM, LEG_MID, LEG_TO = 6000, 6004, 6008
# niter is the leg's end: the label and noise schedules run to it, and phase
# 16's supervisor stops at it
LEG_SCHEDULE = dict(niter=LEG_TO, log_period=4, val_period=8,
                    save_model_period=4, keep_checkpoints=2,
                    d_g_train_period=4)
LEG_DATA = ("--synthetic_hours", "240", "--synthetic_size", "128")
VAL_LAUNCHES = (1, 0, 2, 0, 1)       # one validation batch (val_step)
GENERATE_LAUNCHES = (1, 0, 0, 0, 1)  # one generate call (the image dump)
# a resumed leg's trees against the uninterrupted leg's, where the card's
# step is not deterministic (PERF.md section 6)
RESUME_TOL = 1e-3


class Patches:
    """Wrappers set on classes and modules for a while: ``patch(owner,
    name, wrapper)`` replaces ``owner.name`` by ``wrapper(real)``;
    ``close()`` puts every one back."""

    def __init__(self):
        self._undo = []

    def patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        setattr(owner, name, wrapper(real))
        self._undo.append((owner, name, real))

    def close(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


class LegProbe(Patches):
    """Counts and times what the loop calls during a leg, from the outside:
    a CUDA event and the wall clock at the start of each train_step (with
    its it), each val_step and generate call, and each validation sweep
    and checkpoint save, synchronized and timed."""

    def __init__(self):
        import torch

        from gan_sr_wind_field_tpu_torch.train import checkpoint, loop
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        super().__init__()
        self.steps, self.calls = [], {"val_step": 0, "generate": 0}
        self.val_s, self.saves = [], []
        probe = self
        patch = self.patch

        def on_step(real):
            def step(gan, state, *a, **kw):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                probe.steps.append((state.it + 1, gan.is_g_step(state.it + 1),
                                    ev, state.it, time.time()))
                return real(gan, state, *a, **kw)
            return step

        def counted(name):
            def wrap(real):
                def call(*a, **kw):
                    probe.calls[name] += 1
                    return real(*a, **kw)
                return call
            return wrap

        def timed(store, with_bytes=False):
            def wrap(real):
                def call(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.monotonic()
                    out = real(*a, **kw)
                    torch.cuda.synchronize()
                    secs = time.monotonic() - t
                    store.append((secs, checkpoint.checkpoint_bytes(out))
                                 if with_bytes else secs)
                    return out
                return call
            return wrap

        patch(WindFieldGAN, "train_step", on_step)
        patch(WindFieldGAN, "val_step", counted("val_step"))
        patch(WindFieldGAN, "generate", counted("generate"))
        patch(loop, "run_validation", timed(self.val_s))
        patch(checkpoint, "save_checkpoint", timed(self.saves, True))

    def step_ms(self, quiet):
        """Median ms from the start of one step to the next over the
        steps ``quiet(it)`` accepts, G and D apart."""
        out = {}
        for g in (True, False):
            ms = [a[2].elapsed_time(b[2]) for a, b in
                  zip(self.steps, self.steps[1:]) if a[1] == g and quiet(a[0])]
            out["G" if g else "D"] = (statistics.median(ms), len(ms))
        return out


def leg_config(tmp, root, logger=False, **training):
    """A copy of milestone9k with its folders in ``tmp`` (runs under
    ``root``), the pack's path made absolute, the schedule of a short leg
    and ``training`` overrides. Width, depth, batch, dtype, augmentation,
    device_resident_data and the warm start stay as committed; so does
    use_tensorboard_logger with ``logger``, else it is off (the scalars go
    to events.jsonl either way)."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(CFG)
    cfg.env.root_path = os.path.join(tmp, root)
    cfg.env.data_root = os.path.join(tmp, "data")
    cfg.env.generator_load_path = os.path.join(REPO,
                                               cfg.env.generator_load_path)
    for k, v in {**LEG_SCHEDULE, **training}.items():
        setattr(cfg.training, k, v)
    if not logger:
        cfg.use_tensorboard_logger = False
    path = os.path.join(tmp, f"{root}.ini")
    cfg.save(path)
    return cfg, path


def tree_diffs(a, b):
    """Per tree of two states (G, its EMA, D, D's statistics, both Adam
    moments): (max abs difference, rel L2, bit-exact)."""
    import torch

    pairs = [(t, getattr(a, t), getattr(b, t)) for t in
             ("params_G", "params_G_ema", "params_D", "batch_stats_D")]
    pairs += [(f"{o}.{m}", getattr(getattr(a, o), m),
               getattr(getattr(b, o), m))
              for o in ("opt_state_G", "opt_state_D") for m in ("mu", "nu")]
    out = {}
    for name, ta, tb in pairs:
        # tensor by tensor, so that no float64 copy of a whole tree is held
        mx, num, den = 0.0, 0.0, 0.0
        for k in ta:
            d = ta[k].double() - tb[k].double()
            if d.numel():
                mx = max(mx, d.abs().max().item())
            num += torch.linalg.vector_norm(d).item() ** 2
            den += torch.linalg.vector_norm(tb[k].double()).item() ** 2
        rel = (torch.tensor(num, dtype=torch.float64).sqrt()
               / torch.tensor(den, dtype=torch.float64).sqrt()).item()
        out[name] = (mx, rel, all(torch.equal(ta[k], tb[k]) for k in ta))
    return out


def prepare_leg_data(tmp):
    """Phase 7's data feed on the host, each part timed: the synthetic
    cache, preprocess, the train split's npcache and its resident volumes.
    It runs in a thread beside phases 3 to 5 (host work only, no card);
    the leg then finds the files built. → (seconds by part, the training
    and validation splits, the host volumes)."""
    from gan_sr_wind_field_tpu_torch.data import preprocess
    from gan_sr_wind_field_tpu_torch.data.device_data import (
        load_resident_volumes,
    )
    from gan_sr_wind_field_tpu_torch.data.synthetic import (
        generate_synthetic_cache,
    )

    cfg, _ = leg_config(tmp, "leg")
    g = cfg.gan_config
    hours, size = int(LEG_DATA[1]), int(LEG_DATA[3])
    secs = {}
    t = time.monotonic()
    generate_synthetic_cache(cfg.env.data_root, hours, size, size,
                             g.number_of_z_layers)
    secs["cache"] = time.monotonic() - t
    t = time.monotonic()
    ds_train, _, ds_val, _, _ = preprocess(
        cfg, synthetic=True, synthetic_hours=hours, synthetic_size=size)
    secs["pre"] = time.monotonic() - t
    t = time.monotonic()
    ds_train.use_npcache()  # builds the memmap of the train split
    secs["npc"] = time.monotonic() - t
    t = time.monotonic()
    full, zraw = load_resident_volumes(ds_train)
    secs["host"] = time.monotonic() - t
    return secs, ds_train, ds_val, full, zraw


def loop_phase(dev, card, bare, tmp, data, waited):
    """Phase 7: python -m gan_sr_wind_field_tpu_torch.run --train on a copy
    of milestone9k in ``tmp``, from the 6k pack, 8 steps; then the
    checkpoint round trip (phase 16 resumes a leg against its ckpt_6008).
    ``data`` is the done future of ``prepare_leg_data``, which phase 7
    waited ``waited`` seconds for. Returns the leg's launches, its live
    state at the end and the path of its last checkpoint."""
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.data.augment import augment_batch
    from gan_sr_wind_field_tpu_torch.data.device_data import slice_batch
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt

    cfg, ini = leg_config(tmp, "leg")
    g, n = cfg.gan_config, cfg.dataset_train.batch_size
    hours, size = int(LEG_DATA[1]), int(LEG_DATA[3])
    log(f"loop: {os.path.basename(CFG)} copy, it {LEG_FROM} -> {LEG_TO} "
        f"from the 6k pack, schedule {LEG_SCHEDULE}, data {hours} h at "
        f"{size}x{size}x{g.number_of_z_layers}")
    # the data feed's host parts, timed in their thread; the upload here
    secs, ds_train, ds_val, full, zraw = data.result()
    s_cache, s_pre, s_npc, s_host = (secs[k] for k in
                                     ("cache", "pre", "npc", "host"))
    torch.cuda.synchronize()
    t = time.monotonic()
    full_d = torch.from_numpy(full).to(dev)
    zraw_d = torch.from_numpy(zraw).to(dev)
    torch.cuda.synchronize()
    s_up = time.monotonic() - t
    mb = (full.nbytes + zraw.nbytes) / 1e6
    n_val = len(ds_val)
    del full, zraw
    log(f"  data feed: synthetic cache {s_cache:.3f} s, preprocess "
        f"{s_pre:.3f} s, npcache {s_npc:.3f} s, resident volumes on the "
        f"host {s_host:.3f} s (in a thread beside phases 3 to 5; phase 7 "
        f"waited {waited:.3f} s for it), upload {s_up:.3f} s ({mb:.1f} MB, "
        f"{len(ds_train)} train / {len(ds_val)} val volumes) ({card})")
    gen = torch.Generator(device=dev).manual_seed(0)

    def slice_and_augment():
        return augment_batch(gen, *slice_batch(
            full_d, zraw_d, gen, batch_size=n, patch=g.slice_size,
            patch_y=g.slice_size, cf=cfg.scale, enable_slicing=True))

    sa_ms = cuda_ms(slice_and_augment)
    lr, hr, z = slice_and_augment()
    if (lr.shape != (n, g.slice_size // cfg.scale, g.slice_size
                     // cfg.scale, g.number_of_z_layers,
                     cfg.lr_num_channels)
            or not all(bool(torch.isfinite(a).all())
                       for a in (lr, hr, z))):
        fail(f"bad device batch: {tuple(lr.shape)}")
    log(f"  one slice_batch + augment_batch at batch {n}: {sa_ms:.3f} ms "
        f"({card})")
    del full_d, zraw_d, lr, hr, z, ds_train, ds_val
    torch.cuda.empty_cache()

    # the leg, through the command line
    argv = ["--cfg", ini, "--train", "--synthetic", *LEG_DATA,
            "--max_steps", str(LEG_TO)]
    probe = LegProbe()
    reset_counters()
    t = time.monotonic()
    try:
        state = run.main(argv)
    finally:
        probe.close()
    torch.cuda.synchronize()
    leg_s = time.monotonic() - t
    launches = counters()
    if not probe.steps or probe.steps[0][3] != LEG_FROM:
        fail("the leg did not start at it "
             f"{LEG_FROM} from the pack")
    if state.it != LEG_TO:
        fail(f"the leg ended at it {state.it}, not {LEG_TO}")
    period = cfg.training.d_g_train_period
    ratio = cfg.training.d_g_train_ratio
    its = range(LEG_FROM + 1, LEG_TO + 1)
    n_g = sum((it // period) % (ratio + 1) == 0 for it in its)
    n_d = len(its) - n_g
    sweeps = sum(it % cfg.training.val_period == 0 for it in its)
    val_batches = sweeps * math.ceil(n_val / cfg.dataset_val.batch_size)
    want_calls = {"val_step": val_batches, "generate": sweeps}
    if ([s[1] for s in probe.steps] != [(it // period) % (ratio + 1) == 0
                                         for it in its]
            or probe.calls != want_calls):
        fail(f"the leg's calls {probe.calls}, steps "
             f"{[s[0] for s in probe.steps]} are not the schedule's")
    predicted = tuple(
        n_g * a + n_d * b + val_batches * c + sweeps * e
        for a, b, c, e in zip(G_STEP_LAUNCHES, D_STEP_LAUNCHES,
                              VAL_LAUNCHES, GENERATE_LAUNCHES))
    log(f"  leg {LEG_FROM} -> {LEG_TO} in {leg_s:.1f} s: {n_g} G steps, "
        f"{n_d} D steps, {val_batches} validation batches, {sweeps} "
        f"generate calls; launches {LAUNCH_LABELS} {launches}, "
        f"predicted {predicted}")
    if launches != predicted:
        fail(f"the leg launched {launches}, predicted {predicted}")

    # what the run wrote: losses on every logged line, two validations,
    # the two checkpoints kept
    run_folder = cfg_run_folder(tmp, "leg")
    with open(os.path.join(tmp, "leg", "log", "status.log")) as f:
        status = f.read()
    logged = re.findall(r"it (\d+) G_total (\S+) D (\S+) .*"
                        r"\((\S+) Mvox/s\)", status)
    vals = re.findall(r"validation it (\d+): PSNR (\S+) \(trilinear "
                      r"(\S+)\) G_total (\S+)", status)
    if ([int(r[0]) for r in logged]
            != list(range(LEG_FROM + 4, LEG_TO + 1, 4))
            or not all(math.isfinite(float(v)) for r in logged
                       for v in r[1:3])):
        fail(f"logged lines {logged}")
    val_its = [it for it in its if it % cfg.training.val_period == 0]
    if [int(v[0]) for v in vals] != val_its or not all(
            math.isfinite(float(x)) for v in vals for x in v[1:]):
        fail(f"validation lines {vals}")
    if "continuation warm start" not in status or f"at it={LEG_FROM}" \
            not in status:
        fail("no warm start from the pack in the status log")
    kept = sorted(d for d in os.listdir(run_folder)
                  if d.startswith("ckpt_"))
    if kept != [f"ckpt_{LEG_MID}", f"ckpt_{LEG_TO}"]:
        fail(f"checkpoints kept: {kept}")

    # times: steady state over iterations without boundary work
    quiet = (lambda it: it != LEG_FROM + 1
             and it % cfg.training.log_period
             and it % cfg.training.val_period
             and it % cfg.training.save_model_period)
    per = probe.step_ms(quiet)
    vox = n * g.slice_size * g.slice_size * g.number_of_z_layers
    for kind, bare_ms in (("G", bare["g_ms"]), ("D", bare["d_ms"])):
        ms, count = per[kind]
        log(f"  loop {kind} step {ms:.3f} ms (median of {count} "
            f"iterations without boundary work, CUDA events from one "
            f"step's start to the next), bare train_step {bare_ms:.3f} "
            f"ms (phase 6): the loop's own cost {ms - bare_ms:.3f} ms "
            f"per step ({card})")
    mean_ms = (per["G"][0] + per["D"][0]) / 2
    log(f"  loop HR voxels/s {vox / (mean_ms / 1e3):.4e} over a G/D "
        f"alternation (steady state); as logged "
        + ", ".join(f"it {r[0]} {float(r[3]) * 1e6:.4e}" for r in logged)
        + f" ({card})")
    log(f"  validation sweep {probe.val_s[-1]:.3f} s (first "
        f"{probe.val_s[0]:.3f} s; {val_batches // sweeps} batch of "
        f"{min(n_val, cfg.dataset_val.batch_size)} and one generate); "
        f"checkpoint save {probe.saves[-1][0]:.3f} s, "
        f"{probe.saves[-1][1]} bytes ({card})")

    # the checkpoint round trip
    restored = ckpt.restore_checkpoint(
        os.path.join(run_folder, f"ckpt_{LEG_TO}"), state)
    rt = tree_diffs(restored, state)
    same_rng = torch.equal(restored.rng.get_state(), state.rng.get_state())
    log(f"  restore_checkpoint(ckpt_{LEG_TO}) vs the live state: "
        f"bit-exact {all(v[2] for v in rt.values())}, generator "
        f"state equal {same_rng}, it {restored.it}")
    if not (all(v[2] for v in rt.values()) and same_rng
            and restored.it == state.it
            and restored.opt_state_G.count == state.opt_state_G.count):
        fail("the checkpoint round trip is not bit-exact")
    del restored

    done("the leg and its checks")
    return launches, state, os.path.join(run_folder, f"ckpt_{LEG_TO}"), per


def cfg_run_folder(tmp, root):
    """The one run folder the command line made under ``tmp/root``."""
    runs = os.path.join(tmp, root, "runs")
    (name,) = os.listdir(runs)
    return os.path.join(runs, name)


# phase 8: evaluate, use and serve what the port trains. The held-out test
# chain runs on configs/test_milestone6k.ini's data (phase 7's synthetic
# cache: 240 h at 128x128x10, 23 test fields) with the committed 6k pack, and
# is held against the JAX package's own --test result on a TPU
TEST_CFG = os.path.join(REPO, "configs", "test_milestone6k.ini")
PACK_6K = os.path.join(REPO, "docs", "evidence",
                       "milestone6k_continuation_6000.npz")
JAX_TEST = os.path.join(REPO, "docs", "evidence", "milestone6k_test_{}.csv")
TEST_FIELDS = 23
# trilinear does not depend on the weights; the model rows allow for the
# pack's bf16 rounding of the float32 ckpt_6000 and for bf16 convs on
# another chip; the HR-head kernel against the module head on one field
TRILINEAR_TOL_DB = 1e-3
MODEL_TOL_DB = 0.3
HEAD_FIELD_TOL = 3e-2


class GenerateProbe:
    """Counts ``WindFieldGAN.generate`` calls and keeps, on the host, each
    output, the first call's inputs and the last call's GAN and state."""

    def __init__(self):
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        self.outputs, self.first, self.last = [], None, None
        self._real = real = WindFieldGAN.generate
        probe = self

        def generate(gan, state, lr, z):
            out = real(gan, state, lr, z)
            probe.outputs.append(out.float().cpu())
            if probe.first is None:
                probe.first = (lr, z)
            probe.last = (gan, state)
            return out

        WindFieldGAN.generate = generate

    def close(self):
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        WindFieldGAN.generate = self._real


def jax_test_result():
    """The JAX package's committed --test result (on a TPU): the averages
    rows by name, and each per-field PSNR by track and field."""
    import csv

    with open(JAX_TEST.format("averages")) as f:
        rows = list(csv.reader(f, skipinitialspace=True))
    avgs = {r[0]: [float(v) for v in r[1:]] for r in rows[1:]}
    fields = {}
    for track in ("metrics", "metrics_ema"):
        with open(JAX_TEST.format(track)) as f:
            fields[track] = {r[0]: float(r[1]) for r in
                             list(csv.reader(f, skipinitialspace=True))[1:]}
    return avgs, fields


def read_metrics(path):
    """(header line, {field: PSNR}) of a metrics CSV the port wrote."""
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0] + "\n", {ln.split(",")[0]: float(ln.split(",")[1])
                             for ln in lines[1:]}


def test_copy(tmp, root, **flags):
    """A copy of test_milestone6k.ini with the 6k pack as its weights, its
    folders in ``tmp`` (runs under ``root``) and phase 7's data."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(TEST_CFG)
    cfg.env.generator_load_path = PACK_6K
    cfg.env.root_path = os.path.join(tmp, root)
    cfg.env.this_runs_folder = os.path.join(tmp, root, "runs", "unset")
    cfg.env.data_root = os.path.join(tmp, "data")
    cfg.use_tensorboard_logger = False
    for k, v in flags.items():
        setattr(cfg, k, v)
    path = os.path.join(tmp, f"{root}.ini")
    cfg.save(path)
    return path


class PackMemo(Patches):
    """Reads the 6k pack (``PACK_6K``, committed, never rewritten) from
    disk once for the whole smoke: its readers go through
    ``checkpoint.load_continuation`` (the loop's warm start, every reader
    of weights in a command-line pass) or ``eval.serve``'s
    (``WindFieldSR.from_continuation``), and later reads get the first
    read's arrays, which the readers copy onto the card; so phases 7 to
    10 and 15 pay the pack's zlib once. Other packs are read as they are.
    ``reads`` holds the real reads' (path, seconds)."""

    def __init__(self):
        from gan_sr_wind_field_tpu_torch.eval import serve
        from gan_sr_wind_field_tpu_torch.train import checkpoint

        super().__init__()
        self.reads, cache = [], {}
        reads = self.reads

        def wrap(real):
            def load(path):
                if os.path.abspath(path) != PACK_6K:
                    return real(path)
                if not cache:
                    t = time.monotonic()
                    cache[PACK_6K] = real(path)
                    reads.append((path, time.monotonic() - t))
                return cache[PACK_6K]
            return load

        self.patch(checkpoint, "load_continuation", wrap)
        self.patch(serve, "load_continuation", wrap)


def cli_pass(label, cwd, *argv):
    """run.main(argv) in ``cwd`` on phase 7's data; → (its result, the
    GenerateProbe, the launches, wall seconds)."""
    import torch

    from gan_sr_wind_field_tpu_torch import run

    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    probe = GenerateProbe()
    reset_counters()
    t = time.monotonic()
    try:
        os.chdir(cwd)
        out = run.main([*argv, "--synthetic", *LEG_DATA])
        torch.cuda.synchronize()
    finally:
        os.chdir(old)
        probe.close()
    secs = time.monotonic() - t
    launches = counters()
    log(f"  {label}: {len(probe.outputs)} generate calls in {secs:.3f} s "
        f"wall; launches {LAUNCH_LABELS} {launches}")
    # one trunk and one head launch per generate call (choose_head)
    want = (len(probe.outputs), 0, 0, 0, len(probe.outputs))
    if len(probe.outputs) != TEST_FIELDS or launches != want:
        fail(f"{label} made {len(probe.outputs)} generate calls and "
             f"launched {launches}, predicted {want}")
    return out, probe, launches, secs


def check_trunk_at(G, packed, lr, train, seed):
    """Kernel 1 on G's trunk input of the LR batch ``lr`` (the shape a
    served, tested or trained batch gives it; phases 8 and 11) against its
    plain version in the same dtype; with ``train`` also its residual mode
    and kernel 2 on the plain residuals and a seeded cotangent. Phase 3's
    tolerances; no count is read. Returns the max abs errors (forward,
    backward or None)."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.fused_apply import trunk_geometry
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        pack_trunk_weights_bwd,
        rrdb_trunk,
        rrdb_trunk_bwd,
        rrdb_trunk_bwd_reference,
        rrdb_trunk_reference,
    )

    geom = trunk_geometry(G)
    tol = 3e-2 if G.dtype == torch.bfloat16 else 1e-4
    with torch.no_grad():
        x = G.feature_conv(lr.to(G.dtype)).contiguous()
        xf = x.float()
        got = rrdb_trunk(packed, x, **geom).float()
        want = rrdb_trunk_reference(packed, x, **geom).float()
        shape = tuple(x.shape)
        check(f"trunk kernel vs plain at {shape} {x.dtype} (increment)",
              rel_l2(got - xf, want - xf), tol)
        fwd = (got - want).abs().max().item()
        log(f"  max abs {fwd:.3e} of max |out| "
            f"{want.abs().max().item():.3e}")
        del got, want
        if not train:
            return fwd, None
        got = rrdb_trunk(packed, x, with_residuals=True, **geom)
        want = rrdb_trunk_reference(packed, x, with_residuals=True, **geom)
        check(f"residual mode at {shape}, out increment",
              rel_l2(got[0].float() - xf, want[0].float() - xf), tol)
        check(f"residual mode at {shape}, states",
              rel_l2(got[1].float(), want[1].float()), tol)
        check(f"residual mode at {shape}, growths",
              rel_l2(got[2].float(), want[2].float()), tol)
        growths = want[2]
        del got, want
        packed_t = pack_trunk_weights_bwd(packed, nf=x.shape[-1],
                                          gc=geom["gc"],
                                          num_convs=geom["num_convs"])
        d_out = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed)).to(x.device, x.dtype)
        got = rrdb_trunk_bwd(packed_t, growths, d_out, **geom)
        want = rrdb_trunk_bwd_reference(packed_t, growths, d_out, **geom)
        bwd = 0.0
        for label, g, w in zip(("d_x", "dU", "dLFF"), got, want):
            check(f"trunk backward at {shape}, {label}",
                  rel_l2(g.float(), w.float()), tol)
            bwd = max(bwd, (g.float() - w.float()).abs().max().item())
    return fwd, bwd


def check_trunk_on_field(ini, probe, dev):
    """``check_trunk_at`` on the trunk input of the first field a test
    pass generated (batch 1 at LR 32x32x10, nf 128, its state's G). No
    count is read: the pass's own run is over."""
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import pack_trunk_weights

    G = generator_from_config(load_config(ini), device=dev)
    G.load_state_dict(probe.last[1].params_G, strict=True)
    lr = torch.as_tensor(probe.first[0], device=dev)
    check_trunk_at(G, pack_trunk_weights(G.rrdbs, G.dtype, dev), lr, False,
                   0)
    del G
    torch.cuda.empty_cache()


def eval_phase(dev, card, tmp, state, ckpt_path, packs):
    """Phase 8: pack the live state of phase 7 and read it back, serve its
    ckpt_6008 (from_checkpoint and the server's --checkpoint), then the
    held-out test chain, --test_ema, a pass through the HR-head kernel and
    --use, as a user runs them (run.main in process), on the 6k pack that
    ``packs`` (a PackMemo) read at phase 7. Returns the trunk and head
    kernels' launches and times."""
    import dataclasses
    import pickle

    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval import server
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.test_loop import (
        AVG_HEADER,
        METRIC_HEADER,
    )
    from gan_sr_wind_field_tpu_torch.train.continuation import (
        load_continuation,
        pack_from_state,
    )
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    from gan_sr_wind_field_tpu_torch.utils.jax_params import (
        d_params_from_jax,
        params_from_jax,
    )

    # 1. the pack of the live state, written and read back in two threads
    # (zlib, the bulk of a write and a read, runs without the GIL) while
    # steps 2 to 5 run, against a host copy of the state made first
    from concurrent.futures import ThreadPoolExecutor

    want = {tree: {k: v.cpu() for k, v in ref.items()} for tree, ref in (
        ("G", state.params_G), ("Gema", state.params_G_ema),
        ("D", {**state.params_D, **state.batch_stats_D}))}

    def write(store):
        t0 = time.monotonic()
        path = pack_from_state(os.path.join(tmp, f"pack_{store}.npz"), state,
                               store_dtype=store)
        secs = time.monotonic() - t0
        pack = load_continuation(path)
        got = {"G": params_from_jax(pack["params_G"]),
               "Gema": params_from_jax(pack["params_G_ema"]),
               "D": d_params_from_jax(pack["params_D"],
                                      pack["batch_stats_D"])}
        exact = {tree: sorted(got[tree]) == sorted(ref) and all(
            torch.equal(got[tree][k], v if store == "float32"
                        else v.to(torch.bfloat16).float())
            for k, v in ref.items()) for tree, ref in want.items()}
        return path, secs, exact, pack["it"]

    t_packs = time.monotonic()
    pool = ThreadPoolExecutor(max_workers=2)
    writes = {store: pool.submit(write, store)
              for store in ("float32", "bfloat16")}
    pool.shutdown(wait=False)

    def check_packs():
        for store, future in writes.items():
            path, secs, exact, it = future.result()
            log(f"  pack_from_state(it {state.it}) in {store}: "
                f"{os.path.getsize(path)} bytes in {secs:.3f} s; read back "
                f"bit for bit {exact}, it {it}")
            if not all(exact.values()) or it != state.it:
                fail(f"the {store} pack does not read back as the state")
        log(f"  the two packs written and read back beside steps 2-5, done "
            f"{time.monotonic() - t_packs:.3f} s after their start")

    # 2. serve ckpt_6008: from_checkpoint, and the server's --checkpoint
    run_cfg = os.path.join(os.path.dirname(ckpt_path), "config.ini")
    cfg = load_config(run_cfg)
    g = cfg.gan_config
    coords = np.arange(g.slice_size, dtype=np.float32)
    sr = WindFieldSR.from_checkpoint(cfg, ckpt_path, coords, coords,
                                     device=dev)
    lr_xy = g.slice_size // cfg.scale
    lr, z = sample(np.random.default_rng(2008), 8, lr_xy, g.slice_size,
                   g.number_of_z_layers, cfg.lr_num_channels)
    reset_counters()
    got = sr.upscale(lr, z)
    serve_launches = counters()
    if serve_launches != (1, 0, 0, 0, 1) or not np.isfinite(got).all():
        fail(f"from_checkpoint served with launches {serve_launches}")
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    ref = gan.generate(dataclasses.replace(state,
                                           params_G=state.params_G_ema),
                       lr, z).cpu().numpy()
    exact = np.array_equal(got, ref)
    log(f"  from_checkpoint(ckpt_{state.it}) served 8 samples, launches "
        f"{LAUNCH_LABELS} {serve_launches}; vs gan.generate with the "
        f"state's EMA: bit-exact {exact}, max abs "
        f"{np.abs(got - ref).max():.3e}")
    if not exact:
        fail("from_checkpoint does not serve the state's EMA bit for bit")
    del sr, gan, ref
    captured = {}
    real_serve = server.serve
    server.serve = lambda backend, **kw: captured.update(backend=backend)
    try:
        server.main(["--cfg", run_cfg, "--checkpoint", ckpt_path,
                     "--port", "0"])
    finally:
        server.serve = real_serve
    same = np.array_equal(captured["backend"].upscale(lr, z), got)
    log(f"  eval/server.py --checkpoint: backend built, its batch of 8 "
        f"equal to from_checkpoint's {same}")
    done("serving the leg's last checkpoint")
    if not same:
        fail("the server's --checkpoint backend serves other weights")
    del captured
    torch.cuda.empty_cache()

    # 3. the held-out test chain as a user runs it, on the 6k pack that
    # phase 7 read (PackMemo)
    avgs_jax, fields_jax = jax_test_result()
    jax_raw, jax_ema = avgs_jax["milestone6k"], avgs_jax["milestone6k_ema"]
    copy_ini = test_copy(tmp, "test")
    cwd = os.path.join(tmp, "cwd")
    log(f"test chain: {os.path.basename(TEST_CFG)} copy with "
        f"{os.path.relpath(PACK_6K, REPO)}, data {LEG_DATA[1]} h at "
        f"{LEG_DATA[3]}x{LEG_DATA[3]}x{g.number_of_z_layers} ({card})")
    raw, raw_probe, raw_launches, test_s = cli_pass(
        "--test", cwd, "--cfg", copy_ini, "--test")
    ema, _, ema_launches, ema_s = cli_pass(
        "--test --test_ema", cwd, "--cfg", copy_ini, "--test", "--test_ema")
    out = os.path.join(cwd, "test_output")
    with open(os.path.join(out, "averages.csv")) as f:
        avg_lines = f.read().splitlines()
    for line in avg_lines[1:]:
        log(f"  averages row: {line}")
    if (avg_lines[0] + "\n" != AVG_HEADER
            or [ln.split(",")[0] for ln in avg_lines[1:]]
            != ["milestone6k", "milestone6k_ema"]):
        fail(f"averages.csv: {avg_lines}")
    for track, name in (("metrics", "milestone6k"),
                        ("metrics_ema", "milestone6k_ema")):
        header, psnr = read_metrics(os.path.join(out,
                                                 f"{name}____metrics.csv"))
        if header != METRIC_HEADER or len(psnr) != TEST_FIELDS:
            fail(f"{name}____metrics.csv: {len(psnr)} rows, header "
                 f"{header!r}")
        gaps = {f: psnr[f] - fields_jax[track][f] for f in fields_jax[track]}
        worst = max(gaps, key=lambda f: abs(gaps[f]))
        log(f"  {name}: largest per-field PSNR gap to the JAX package's "
            f"{os.path.basename(JAX_TEST.format(track))} {gaps[worst]:+.4f} "
            f"dB ({worst})")
    checks = (
        ("trilinear PSNR", raw["PSNR_trilinear"], jax_raw[1],
         TRILINEAR_TOL_DB),
        ("raw G PSNR", raw["PSNR"], jax_raw[0], MODEL_TOL_DB),
        ("EMA PSNR", ema["PSNR"], jax_ema[0], MODEL_TOL_DB),
    )
    for what, mine, theirs, tol in checks:
        log(f"  {what}: port {mine:.6f} dB, JAX package on a TPU "
            f"{theirs:.6f} dB, gap {mine - theirs:+.6f} (tol {tol})")
        if not abs(mine - theirs) <= tol:
            fail(f"{what} is {mine - theirs:+.6f} dB off the JAX result")
    if not raw["PSNR"] > raw["PSNR_trilinear"]:
        fail("the raw generator does not beat trilinear on the test split")

    # the trunk kernel at the test volume's geometry against its plain
    # version, on the trunk input of the pass's first field
    check_trunk_on_field(copy_ini, raw_probe, dev)
    done("--test and --test --test_ema")

    # 4. --use: the SR field dumps of the test split
    _, _, use_launches, use_s = cli_pass("--use", cwd, "--cfg", copy_ini,
                                         "--use")
    log(f"  the 6k pack read from disk {len(packs.reads)} time(s) so far: "
        + ", ".join(f"{os.path.basename(path)} in {secs:.3f} s"
                    for path, secs in packs.reads)
        + " (phase 7's warm start); the four passes took its arrays")
    if len(packs.reads) != 1:
        fail("the 6k pack was read from disk more than once")
    runs = os.path.join(tmp, "test", "runs")
    fields = os.path.join(runs, sorted(os.listdir(runs))[-1], "fields")
    dumps = sorted(os.listdir(fields))
    size, zl = int(LEG_DATA[3]), g.number_of_z_layers
    shapes = {"LR": (cfg.lr_num_channels, size // cfg.scale,
                     size // cfg.scale, zl), "SR": (3, size, size, zl)}
    for name in dumps:
        with open(os.path.join(fields, name), "rb") as f:
            d = pickle.load(f)
        if ({k: v.shape for k, v in d.items()} != shapes
                or not all(np.isfinite(v).all() for v in d.values())):
            fail(f"--use dump {name}: "
                 f"{ {k: v.shape for k, v in d.items()} }")
    log(f"  --use wrote {len(dumps)} dumps, {shapes}, finite")
    if len(dumps) != TEST_FIELDS:
        fail(f"--use wrote {len(dumps)} dumps")

    check_packs()
    # 5. the first test field as the pass ran it (the head kernel) and with
    # the module head, and one full-volume generate's time with either
    gan_p, state_p = raw_probe.last
    lr1, z1 = raw_probe.first
    per_field, outs = {}, {}
    for label in ("head kernel", "module head"):
        if label == "module head":
            module_head(gan_p)
        outs[label] = gan_p.generate(state_p, lr1, z1)
        per_field[label] = cuda_ms(lambda: gan_p.generate(state_p, lr1, z1))
    field_err = rel_l2(outs["head kernel"], outs["module head"])
    log(f"  the first test field, head kernel vs module head: SR rel L2 "
        f"{field_err:.3e} (tol {HEAD_FIELD_TOL:.0e})")
    if not field_err <= HEAD_FIELD_TOL:
        fail("the head kernel's test field disagrees with the module head")
    field = tuple(torch.as_tensor(t).cpu().numpy()[0]
                  for t in raw_probe.first)
    del raw_probe, gan_p, state_p, outs
    log(f"  generate of one {size}x{size}x{zl} field: module head "
        f"{per_field['module head']:.3f} ms, head kernel "
        f"{per_field['head kernel']:.3f} ms; test pass {test_s:.3f} s, EMA "
        f"pass {ema_s:.3f} s, --use {use_s:.3f} s wall ({card})")
    passes = (serve_launches, raw_launches, ema_launches, use_launches)
    return {"trunk": sum(n[0] for n in passes),
            "head": sum(n[4] for n in passes), "ms_module_head":
            per_field["module head"], "ms_head_kernel":
            per_field["head kernel"], "test_s": test_s,
            "psnr": raw["PSNR"], "psnr_ema": ema["PSNR"],
            "psnr_trilinear": raw["PSNR_trilinear"], "field": field}


# phase 9: the long runs' loop and SR of any extent, in phase 7's temporary
# directory on its data. (a) phase 7's leg chunked (steps_per_dispatch 4,
# CUDA graphs of the step) and profiled, 6000 -> 6008: 6001-6004 G, G, G, D
# and 6005-6008 D, D, D, G, each kind warmed up and captured on its first
# use (6001, 6004) and replayed after (3 G and 3 D replays); (b) the host
# data path, 6000 -> 6004 per step (G, G, G, D); (c) upscale_tiled at the
# server's tile (the training LR patch)
CHUNK_STEPS, CHUNK_TO, HOST_TO = 4, LEG_TO, LEG_MID
# 4 G, 4 D, one validation batch and one generate
CHUNK_LAUNCHES = (10, 4, 10, 4, 10)
CHUNK_REPLAYS = 6
HOST_LAUNCHES = (4, 3, 6, 3, 4)      # 3 G, 1 D, no validation
TILE, OVERLAP, TILE_BATCH = 16, 4, 8
TILED_HOST_TOL = 1e-6  # the same kernel on the same tiles, blended apart
# median |tiled - direct| / std(direct), JAX's bound (tests/test_serve.py)
TILED_MEDIAN_RATIO = 0.25
BIG_FIELD = 128                      # LR 128x128: HR 512x512


class ChunkProbe(Patches):
    """What a chunked leg dispatches: each train_chunk call (its first
    iteration and length), and for each step through the graphs a CUDA
    event at its start, its iteration, its kind and whether its graph
    replayed; the graphs themselves."""

    def __init__(self):
        import torch

        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
        from gan_sr_wind_field_tpu_torch.train.step_graphs import StepGraphs

        super().__init__()
        self.chunks, self.steps, self.graphs = [], [], None
        probe = self
        patch = self.patch

        def on_chunk(real):
            def chunk(gan, state, *a, n_steps, **kw):
                probe.chunks.append((state.it, n_steps))
                return real(gan, state, *a, n_steps=n_steps, **kw)
            return chunk

        def on_step(real):
            def step(graphs, state, batch):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                it = state.it + 1
                g = graphs.gan.is_g_step(it)
                probe.steps.append((it, g, ev, g in graphs.graphs))
                probe.graphs = graphs
                return real(graphs, state, batch)
            return step

        patch(WindFieldGAN, "train_chunk", on_chunk)
        patch(StepGraphs, "step", on_step)

    def replay_ms(self, quiet):
        """Median ms from the start of a replayed step to the next step's
        start over the steps ``quiet(it)`` accepts, G and D apart."""
        out = {}
        for g in (True, False):
            ms = [a[2].elapsed_time(b[2]) for a, b in
                  zip(self.steps, self.steps[1:])
                  if a[1] == g and a[3] and quiet(a[0])]
            out["G" if g else "D"] = (statistics.median(ms), len(ms))
        return out


def read_trace(path):
    """From a torch.profiler Chrome trace: (the window's ms, the card's
    busy ms (the union of its kernels, copies and sets), {device op name:
    (ms, count)})."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end, ops = 0.0, -math.inf, {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = ops.get(name, (0.0, 0))
        ops[name] = (ms + (b - a) / 1e3, n + 1)
    return (t1 - t0) / 1e3, busy / 1e3, ops


def chunk_phase(dev, card, tmp, leg_ms, field):
    """Phase 9: (a) phase 7's leg chunked through CUDA graphs and
    profiled, held against phase 7's ckpt_6008; (b) the host data path
    leg; (c) upscale_tiled on the 6k pack, a test field and a 512x512
    field, with the module head and through kernel 5. Returns each
    kernel's launches on these paths."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR, _tiling
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
    from gan_sr_wind_field_tpu_torch.train import loop

    # (a) the chunked leg, profiled
    cfg, ini = leg_config(tmp, "chunked", save_model_period=8)
    cfg.steps_per_dispatch = CHUNK_STEPS
    cfg.save(ini)
    log(f"chunked leg: the phase-7 leg with steps_per_dispatch "
        f"{CHUNK_STEPS}, it {LEG_FROM} -> {CHUNK_TO}, --profile")
    probe = ChunkProbe()
    reset_counters()
    t = time.monotonic()
    try:
        state = run.main(["--cfg", ini, "--train", "--profile",
                          "--synthetic", *LEG_DATA,
                          "--max_steps", str(CHUNK_TO)])
    finally:
        probe.close()
    torch.cuda.synchronize()
    leg_s = time.monotonic() - t
    launches = counters()
    graphs = probe.graphs
    log(f"  dispatches (it, steps) {probe.chunks}; steps "
        + ", ".join(f"{it} {'G' if g else 'D'}"
                    f"{' replay' if r else ' warm-up + capture'}"
                    for it, g, _, r in probe.steps))
    log(f"  leg {LEG_FROM} -> {CHUNK_TO} in {leg_s:.1f} s; launches "
        f"{LAUNCH_LABELS} {launches} (replays counted), predicted "
        f"{CHUNK_LAUNCHES}; {graphs.replays} graph replays, capture "
        f"{graphs.capture_s:.3f} s, pool {graphs.pool_bytes} bytes "
        f"({card})")
    if (state.it != CHUNK_TO
            or probe.chunks != [(LEG_FROM, CHUNK_STEPS),
                                (LEG_FROM + 4, CHUNK_STEPS)]):
        fail(f"the chunked leg ran {probe.chunks} to it {state.it}")
    if launches != CHUNK_LAUNCHES or graphs.replays != CHUNK_REPLAYS:
        fail(f"the chunked leg launched {launches} with {graphs.replays} "
             f"replays, predicted {CHUNK_LAUNCHES} and {CHUNK_REPLAYS}")
    with open(os.path.join(tmp, "chunked", "log", "status.log")) as f:
        status = f.read()
    logged = re.findall(r"it (\d+) G_total (\S+) D (\S+)", status)
    if ([int(r[0]) for r in logged] != [LEG_FROM + 4, CHUNK_TO]
            or not all(math.isfinite(float(v)) for r in logged
                       for v in r[1:])
            or f"validation it {CHUNK_TO}" not in status):
        fail(f"the chunked leg logged {logged}")
    per = probe.replay_ms(lambda it: it % CHUNK_STEPS)
    for kind in ("G", "D"):
        ms, n = per[kind]
        log(f"  chunked loop {kind} step {ms:.3f} ms (median of {n} "
            f"replays, start to next start), phase 7's per-step loop "
            f"{leg_ms[kind][0]:.3f} ms ({card})")
    ref = ckpt.restore_checkpoint(os.path.join(
        cfg_run_folder(tmp, "leg"), f"ckpt_{CHUNK_TO}"), state)
    diffs = tree_diffs(state, ref)
    same_rng = torch.equal(state.rng.get_state(), ref.rng.get_state())
    for name, (mx, rel, bits) in diffs.items():
        log(f"  chunked vs phase 7's ckpt_{CHUNK_TO} {name:<18} max abs "
            f"{mx:.3e}, rel L2 {rel:.3e}, bit-exact {bits}")
    exact = all(v[2] for v in diffs.values()) and same_rng
    held = exact or all(v[1] <= RESUME_TOL for v in diffs.values())
    log(f"  chunked leg at {CHUNK_TO} vs phase 7's ckpt_{CHUNK_TO}: "
        f"bit-exact {exact} (generator state equal {same_rng}); "
        f"{'bit-exact' if exact else f'within {RESUME_TOL:.0e}'} holds "
        f"{held}")
    if not held or ref.it != state.it:
        fail(f"the chunked leg is off by more than {RESUME_TOL:.0e}")
    del ref, state
    tb = os.path.join(tmp, "chunked", "tensorboard_log")
    (name,) = os.listdir(tb)
    trace = os.path.join(tb, name,
                         f"profile_it{LEG_FROM}-{CHUNK_TO}.pt.trace.json")
    if not os.path.exists(trace):
        fail(f"no trace at {trace}: {os.listdir(os.path.join(tb, name))}")
    window, busy, ops = read_trace(trace)
    log(f"  trace {os.path.getsize(trace)} bytes: the window {window:.1f} "
        f"ms, the card busy {busy:.1f} ms ({100 * busy / window:.1f} %) "
        f"({card})")
    for op, (ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:5]:
        log(f"    {ms:10.3f} ms {n:6d}x {op[:90]}")
    named = {k: sorted({n for n in ops if any(s in n for s in subs)})
             for k, subs in (
                 ("kernel 1", TC_KERNELS["rdb_trunk"]),
                 ("kernel 2", TC_KERNELS["rdb_trunk_bwd"]),
                 ("kernel 3", (STENCIL_KERNELS["gradient"],)),
                 ("kernel 4", (STENCIL_KERNELS["adjoint"],)))}
    log("  the trace names " + "; ".join(
        f"{k}: {', '.join(n[:40] for n in v) or 'none'}"
        for k, v in named.items()))
    if not all(named.values()):
        fail("the trace misses a kernel of the chunked leg")

    done("(a)")
    # (b) the host data path, per step
    cfg, ini = leg_config(tmp, "hostpath")
    cfg.device_resident_data = False
    cfg.save(ini)
    feeds = []

    def keep(real):
        def feed(*a, **kw):
            feeds.append(real(*a, **kw))
            return feeds[-1]
        return feed

    leg = LegProbe()
    leg.patch(loop, "prefetch_to_device", keep)
    reset_counters()
    try:
        state = run.main(["--cfg", ini, "--train", "--synthetic", *LEG_DATA,
                          "--max_steps", str(HOST_TO)])
    finally:
        leg.close()
    torch.cuda.synchronize()
    host = counters()
    with open(os.path.join(tmp, "hostpath", "log", "status.log")) as f:
        logged = re.findall(r"it (\d+) G_total (\S+) D (\S+)", f.read())
    g_quiet = [a[2].elapsed_time(b[2]) for a, b in
               zip(leg.steps, leg.steps[1:])
               if a[1] and a[0] != LEG_FROM + 1 and a[0] % 4]
    g_ms, n_g = statistics.median(g_quiet), len(g_quiet)
    log(f"  host data path {LEG_FROM} -> {HOST_TO}: launches "
        f"{LAUNCH_LABELS} {host}, predicted {HOST_LAUNCHES}; logged "
        f"{logged}; loop G step {g_ms:.3f} ms (median of {n_g}), phase "
        f"7's resident leg {leg_ms['G'][0]:.3f} ms; the loop waited "
        f"{feeds[0].wait_s:.3f} s on the prefetch queue (host clock) "
        f"({card})")
    if (state.it != HOST_TO or host != HOST_LAUNCHES
            or [int(r[0]) for r in logged] != [HOST_TO]
            or not all(math.isfinite(float(v)) for v in logged[0][1:])
            or feeds[0]._thread.is_alive()):
        fail(f"the host data path leg ended at {state.it}, launched {host}, "
             f"logged {logged}")
    del state
    torch.cuda.empty_cache()

    done("(b)")
    # (c) upscale_tiled at the server's tile, on the 6k pack
    # the module head, and the head kernel as committed
    mcfg = load_config(CFG)
    sr = module_head(WindFieldSR.from_continuation(mcfg, PACK_6K,
                                                   use_ema=False, device=dev))
    sr_h = WindFieldSR(mcfg, sr.G.state_dict(), device=dev)
    lr, z = field
    X, Y = lr.shape[:2]
    tile, win, coords = _tiling(X, Y, TILE, OVERLAP, TILE_BATCH, sr.scale)
    n_batches = math.ceil(len(coords) / TILE_BATCH)
    reset_counters()
    got = sr.upscale_tiled(lr, z, tile=TILE, overlap=OVERLAP,
                           batch=TILE_BATCH)
    tiled = counters()
    want = sr._upscale_tiled_host(lr, z, coords, tile, TILE_BATCH, win)
    direct = sr.upscale(lr, z)
    err_host = rel_l2(torch.from_numpy(got), torch.from_numpy(want))
    err_direct = rel_l2(torch.from_numpy(got), torch.from_numpy(direct))
    ratio = float(np.median(np.abs(got - direct)) / np.std(direct))
    log(f"upscale_tiled: test field LR {X}x{Y}x{lr.shape[2]}, tile "
        f"{TILE}, overlap {OVERLAP}, batch {TILE_BATCH}: {len(coords)} "
        f"tiles in {n_batches} batches, launches {LAUNCH_LABELS} {tiled}; "
        f"vs _upscale_tiled_host rel L2 {err_host:.3e} (tol "
        f"{TILED_HOST_TOL:.0e}); vs a direct upscale rel L2 "
        f"{err_direct:.3e}, median |err| / std {ratio:.3e} (JAX's bound "
        f"{TILED_MEDIAN_RATIO})")
    if (got.shape != direct.shape or not np.isfinite(got).all()
            or tiled != (n_batches, 0, 0, 0, 0)
            or not err_host <= TILED_HOST_TOL
            or not ratio <= TILED_MEDIAN_RATIO):
        fail("upscale_tiled on the test field")
    big_lr, big_z = (a[0] for a in sample(
        np.random.default_rng(2009), 1, BIG_FIELD, BIG_FIELD * sr.scale,
        lr.shape[2], lr.shape[3]))
    tile, _, coords = _tiling(BIG_FIELD, BIG_FIELD, TILE, OVERLAP,
                              TILE_BATCH, sr.scale)
    n_big = math.ceil(len(coords) / TILE_BATCH)
    vox = big_z.shape[0] * big_z.shape[1] * big_z.shape[2]
    big = {}
    for label, s_ in (("module head", sr), ("head kernel", sr_h)):
        reset_counters()
        t = time.monotonic()
        out = s_.upscale_tiled(big_lr, big_z, tile=TILE, overlap=OVERLAP,
                               batch=TILE_BATCH)
        secs = [time.monotonic() - t]
        n = counters()
        # the module head's path is warm (the test field's tiles ran its
        # shapes just before): its counted call is its one timed call; the
        # head kernel's is a warm-up, then three timed calls, one where
        # the warm-up took over VERY_LONG_CALL_S (as cuda_ms)
        reps = 0
        if label == "head kernel":
            reps = 1 if secs[0] > VERY_LONG_CALL_S else 3
            secs = []
        for _ in range(reps):
            t = time.monotonic()
            s_.upscale_tiled(big_lr, big_z, tile=TILE, overlap=OVERLAP,
                             batch=TILE_BATCH)
            secs.append(time.monotonic() - t)
        ms = 1e3 * statistics.median(secs)
        big[label] = (ms, n)
        log(f"  upscale_tiled HR {big_z.shape[0]}x{big_z.shape[1]}x"
            f"{big_z.shape[2]}, {label}: {len(coords)} tiles in {n_big} "
            f"batches, {ms:.3f} ms (median of {len(secs)}, host clock, "
            f"upload and download included), {vox / (ms / 1e3):.4e} HR "
            f"voxels/s; launches {LAUNCH_LABELS} {n} ({card})")
        want_n = (n_big, 0, 0, 0, n_big if label == "head kernel" else 0)
        if (n != want_n or out.shape != (*big_z.shape[:3], 3)
                or not np.isfinite(out).all()):
            fail(f"upscale_tiled of the big field, {label}: launches {n}, "
                 f"predicted {want_n}")
    del sr, sr_h
    return {"chunk": launches, "host": host,
            "tiled": tuple(a + b + c for a, b, c in zip(
                tiled, big["module head"][1], big["head kernel"][1])),
            "tiled_ms": big["module head"][0],
            "tiled_head_ms": big["head kernel"][0]}




# phase 10: deploy what the port trains, in phase 7's temporary directory
# on its data, with a copy of configs/test_milestone6k.ini and the 6k pack:
# (a) the int8 conv kernels against their plain versions at every shape
# they serve at full width, and the head pair timed; (b) int8 serving
# through run.py --serve_int8 / --serve_int8_trunk; (c) the torch.export
# artifact through run.py --export (phase 8 runs --use) and
# eval/server.py --artifact; (d) eval.interp on the 9k and 6k packs
PACK_9K = os.path.join(REPO, "docs", "evidence",
                       "milestone9k_continuation_9000.npz")
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
# JAX's own bounds on int8 serving against the exact path, relative L2
# (tests/test_quant.py:156, tests/test_quant_trunk.py:153,160)
INT8_TOL = {"int8 head": 2e-2, "int8 trunk": 3e-2, "both": 4e-2}
# the JAX package's int8 head against its exact path on a TPU, in dB
# (gan_sr_wind_field_tpu/ops/quant.py:26): model quality, not speed
JAX_INT8_PSNR_DB = 67.7
EXPORT_PLAIN_TOL = 1e-5   # the artifact against the same aten ops
EXPORT_KERNEL_TOL = 3e-2  # against the kernel path: phase 4's bound


def int8_geometry(cfg):
    """The int8 kernels' widths at ``cfg``: the head's (nf, cm, stacked
    remainder columns, C, k, HR extent) and the trunk's (nf, gc, K, the
    RDB buffer's channels, LR extent), with the depth zl."""
    g, G = cfg.gan_config, cfg.generator
    hr, zl, k = g.slice_size, g.number_of_z_layers, G.hr_kern_size
    nf, gc, K = G.num_features, G.RDB_growth_chan, G.num_RDB_convs - 1
    C = nf + G.terrain_number_of_features
    cm = C // 128 * 128
    return dict(nf=nf, cm=cm, rem=k * k * (C - cm), C=C, k=k, hr=hr,
                lr=hr // cfg.scale, zl=zl, gc=gc, K=K, width=nf + gc * K)


def int8_tensors(dev, gen, shape, *sizes):
    """Seeded int8 tensors in [-127, 127] of ``shape`` + each size."""
    import torch

    return [torch.randint(-127, 128, (*shape, *sz), dtype=torch.int8,
                          device=dev, generator=gen) for sz in sizes]


def int8_scales(dev, gen, *cols):
    """Positive float32 scales of a served model's size, one per column."""
    import torch

    return [torch.rand(c, device=dev, generator=gen) * 1e-4 + 1e-6
            for c in cols]


def pair_work(rows, nf, cm, rem, k):
    """(int8 operations, bytes) of the head pair: the input read once, both
    weights read once, the main conv's bf16 columns and the remainder's
    float32 partials written once."""
    ops = 2 * rows * nf * (cm * k ** 3 + rem * k)
    nbytes = (rows * nf + nf * (cm * k ** 3 + rem * k) + 4 * (cm + rem)
              + rows * (2 * cm + 4 * rem))
    return ops, nbytes


def check_int8_kernel(cfg, dev, card, built):
    """Phase 10 (a): the conv_int8 library's ptxas report and IGMMA count
    (int8 wgmma; 0 fails); each entry point bit for bit against its plain
    version at the full-width shapes the serving paths give it (the head
    pair, the trunk's last growth conv into its RDB buffer, the LFF), each
    timed beside its bound; the LFF beside torch._int_mm on its operands
    (cuBLASLt, the same int32 sums); whether F.conv3d takes int8; the head
    pair at batch 8 and 32 beside its bound, its plain version, bf16 cuDNN
    of hr_conv0_x (the conv it replaces) and kernel 5. Returns {entry
    point: (max abs error, ms, plain ms, bound, library ms)} with the head
    pair's batch-32 numbers and kernel 5's under "pair_b32"."""
    import torch
    import torch.nn.functional as F

    from gan_sr_wind_field_tpu_torch.models.blocks import conv3d_cl
    from gan_sr_wind_field_tpu_torch.ops import conv_int8
    from gan_sr_wind_field_tpu_torch.ops.hr_head import (
        hr_head_conv,
        pack_head_weights,
    )

    path, _, report = built["conv_int8"]
    for fn, lines in ptxas_reports(report).items():
        log(f"  conv_int8 {fn} ptxas: {'; '.join(lines)}")
        if any("serialized" in line for line in lines):
            log(f"  conv_int8 {fn}: ptxas serializes its wgmmas")
    sass = sass_mma_counts(path)
    if sass is None:
        log("  conv_int8: cuobjdump not found, no SASS count")
    else:
        counts = [sum(c[i] for c in sass.values()) for i in range(4)]
        log(f"  conv_int8: {counts[3]} IGMMA (int8 wgmma) and {counts[2]} "
            f"IMMA instructions in its SASS")
        if counts[3] == 0:
            fail("conv_int8 has no int8 wgmma (IGMMA) in its SASS")
    gm = int8_geometry(cfg)
    nf, cm, rem, C, k, gc = (gm[v] for v in ("nf", "cm", "rem", "C", "k",
                                             "gc"))
    p = (k - 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2010)
    out = {}

    def report_call(name, label, shape, got, want, ms, plain_ms, ops, nbytes,
                    lib_ms):
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        bd = bound(ops, nbytes, H100_INT8_OPS)
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        log(f"  {label} at {shape}: bit for bit {exact} (max abs {err:.1e});"
            f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms{lib}; bound "
            f"{bd[0]:.4f} ms by {bd[1]} ({100 * bd[0] / ms:.1f} %), "
            f"{ops / ms / 1e9:.1f} TOP/s ({card})")
        if not exact:
            fail(f"conv_int8 {name} disagrees with its plain version at "
                 f"{label}")
        out[name] = (err, ms, plain_ms, bd, lib_ms)

    # the trunk's last growth conv and the LFF on one RDB buffer at LR
    # batch 8, then the head pair at HR batch 8
    lr_shape = (8, gm["lr"], gm["lr"], gm["zl"])
    rows = math.prod(lr_shape)
    (buf,) = int8_tensors(dev, gen, lr_shape, (gm["width"],))
    ci = nf + gc * (gm["K"] - 1)
    wg, wl = int8_tensors(dev, gen, (), (3, 3, 3, ci, gc), (1, 1, 1,
                                                            gm["width"], nf))
    sg, sl = int8_scales(dev, gen, gc, nf)
    sc = torch.rand(gc, device=dev, generator=gen) * 2.0 + 0.5
    bl = torch.randn(nf, device=dev, generator=gen)
    pg, pl = conv_int8.pack_conv_int8(wg), conv_int8.pack_conv_int8(wl)
    got, want = buf.clone(), buf.clone()  # each conv writes into its input
    conv_int8.conv3d_int8_requant(got, ci, wg, 1, sg, sc, 0.2, got, ci,
                                  packed=pg)
    conv_int8.conv3d_int8_requant_reference(want, ci, wg, 1, sg, sc, 0.2, want,
                                            ci)
    report_call(
        "requant", f"growth 3x3x3 {ci}->{gc} into columns {ci}.."
        f"{ci + gc - 1} of {gm['width']}", lr_shape, [got], [want],
        cuda_ms(lambda: conv_int8.conv3d_int8_requant(
            buf, ci, wg, 1, sg, sc, 0.2, buf, ci, packed=pg), reps=50),
        cuda_ms(lambda: conv_int8.conv3d_int8_requant_reference(
            buf, ci, wg, 1, sg, sc, 0.2, buf.clone(), ci), reps=2),
        2 * rows * 27 * ci * gc,
        rows * ci + 27 * ci * gc + 8 * gc + rows * gc, None)
    got = conv_int8.conv3d_int8(buf, wl, 0, sl, bl, packed=pl)
    want = conv_int8.conv3d_int8_reference(buf, wl, 0, sl, bl)
    a2 = buf.reshape(rows, gm["width"])
    b2 = wl.reshape(gm["width"], nf).t().contiguous().t()
    turns = alternate(
        lambda: conv_int8.conv3d_int8(buf, wl, 0, sl, bl, packed=pl),
        lambda: torch._int_mm(a2, b2))
    log_turns("  LFF kernel vs torch._int_mm (cuBLASLt) on its operands",
              turns, card)
    report_call(
        "lff", f"LFF 1x1x1 {gm['width']}->{nf} + bias", lr_shape, [got],
        [want], turns[0],
        cuda_ms(lambda: conv_int8.conv3d_int8_reference(buf, wl, 0, sl, bl),
                reps=2),
        2 * rows * gm["width"] * nf,
        rows * gm["width"] + gm["width"] * nf + 8 * nf + 4 * rows * nf,
        turns[1])
    if not torch.equal(torch._int_mm(a2, b2).reshape(*lr_shape, nf),
                       conv_int8.conv3d_int8_reference(buf, wl, 0)):
        fail("torch._int_mm does not give the LFF's int32 sums")
    del buf, wg, wl, got, want, a2, b2
    probe = torch.zeros((1, 32, 4, 4, 4), dtype=torch.int8, device=dev)
    try:
        F.conv3d(probe, torch.zeros((32, 32, 3, 3, 3), dtype=torch.int8,
                                    device=dev), padding=1)
        torch.cuda.synchronize()
        library_int8 = "accepted"
    except RuntimeError as e:
        library_int8 = f"refused ({str(e).splitlines()[0][:100]})"
    log(f"  F.conv3d on int8 CUDA tensors, torch {torch.__version__}: "
        f"{library_int8}")

    tc = cfg.generator.terrain_number_of_features
    for n in (8, 32):
        shape = (n, gm["hr"], gm["hr"], gm["zl"])
        (xq,) = int8_tensors(dev, gen, shape, (nf,))
        wm, wr = int8_tensors(dev, gen, (), (k, k, k, nf, cm), (1, 1, k, nf,
                                                               rem))
        sm, sr = int8_scales(dev, gen, cm, rem)
        pm, pr = conv_int8.pack_conv_int8(wm), conv_int8.pack_conv_int8(wr)

        def pair():
            return conv_int8.head_pair_int8(xq, wm, sm, p, wr, sr, width=C,
                                            packed_main=pm, packed_rem=pr)

        def plain():
            return conv_int8.head_pair_int8_reference(xq, wm, sm, p, wr, sr,
                                                      width=C)

        ms = cuda_ms(pair)
        plain_ms = cuda_ms(plain, reps=1)
        xb = torch.randn((*shape, nf), device=dev, generator=gen).to(
            torch.bfloat16)
        tb = torch.randn((*shape, tc), device=dev, generator=gen).to(
            torch.bfloat16)
        wx = (torch.randn((C, nf, k, k, k), device=dev, generator=gen)
              * 0.01).to(torch.bfloat16)
        wt = (torch.randn((C, tc, k, k, k), device=dev, generator=gen)
              * 0.01).to(torch.bfloat16)
        with torch.inference_mode():
            lib_ms = cuda_ms(lambda: conv3d_cl(xb, wx, p),
                             reps=5 if n == 8 else 3)
            packed5 = pack_head_weights(wx, wt, torch.bfloat16, dev)
            k5_ms = cuda_ms(lambda: hr_head_conv(packed5, xb, tb, k=k))
        del xb, tb, wx, wt, packed5
        ops, nbytes = pair_work(math.prod(shape), nf, cm, rem, k)
        if n == 8:
            (o, part), (wo, wpart) = pair(), plain()
            report_call("pair", f"head pair {k}x{k}x{k} {nf}->{cm} (bf16 "
                        f"into {C} columns) + 1x1x{k} {nf}->{rem} (float32)",
                        shape, [o[..., :cm], part], [wo[..., :cm], wpart], ms,
                        plain_ms, ops, nbytes, lib_ms)
            out["k5"] = k5_ms
            del o, part, wo, wpart
        else:
            out["pair_b32"] = (ms, plain_ms, bound(ops, nbytes,
                                                   H100_INT8_OPS), lib_ms,
                               k5_ms)
        bd = bound(ops, nbytes, H100_INT8_OPS)
        log(f"int8 head pair at batch {n} ({ops:.4e} int8 ops), one launch: "
            f"kernel {ms:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]} "
            f"({100 * bd[0] / ms:.1f} %), plain {plain_ms:.3f} ms; the conv "
            f"it replaces, hr_conv0_x in bf16 cuDNN, {lib_ms:.3f} ms; kernel "
            f"5 (the whole bf16 head) {k5_ms:.3f} ms ({card})")
        del xq, wm, wr, pm, pr
        torch.cuda.empty_cache()
    return out


def plain_int8_paths():
    """A context in which the int8 serving functions run the plain versions
    of the int8 kernels' entry points (the composition the kernels replace)
    on the card's tensors."""
    import contextlib

    from gan_sr_wind_field_tpu_torch.ops import conv_int8, quant, quant_trunk

    @contextlib.contextmanager
    def ctx():
        saved = (quant.head_pair_int8, quant_trunk.conv3d_int8,
                 quant_trunk.conv3d_int8_requant)
        quant.head_pair_int8 = (
            lambda *a, packed_main=None, packed_rem=None, **kw:
            conv_int8.head_pair_int8_reference(*a, **kw))
        quant_trunk.conv3d_int8 = (
            lambda xq, wq, pad, s, bias=None, packed=None:
            conv_int8.conv3d_int8_reference(xq, wq, pad, s, bias))
        quant_trunk.conv3d_int8_requant = (
            lambda *a, packed=None: conv_int8.conv3d_int8_requant_reference(
                *a))
        try:
            yield
        finally:
            (quant.head_pair_int8, quant_trunk.conv3d_int8,
             quant_trunk.conv3d_int8_requant) = saved

    return ctx()


def psnr_db(got, ref):
    """PSNR of got against ref over ref's range, as the JAX package's
    probe computes it (scripts/probe_quant_serve.py:68-71)."""
    import numpy as np

    mse = float(np.mean((got.astype(np.float64) - ref) ** 2))
    return 10 * math.log10(float(ref.max() - ref.min()) ** 2
                           / max(mse, 1e-30))


# the processes the smoke starts, stopped at its end whatever happens
CHILDREN = []


def start_clis(tmp):
    """Phase 10's two command lines, each in a process of its own from
    phase 7's start (once its data is built: the export's header takes
    its normalization factors): run.py --export of the 6k pack's EMA
    generator and eval.interp, the blend of the 9k and 6k packs at 0.5.
    Both are asked for the CPU (--device cpu, 2 threads) and run at a
    lower scheduling priority, so that they take the host's spare cycles
    beside phases 7 to 9 and no card time from what those measure; the
    card loads their artifacts in phase 10. → {name: (process, wall-clock
    start, artifact path)}."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *filter(None, [env.get("PYTHONPATH")])])
    art, blend = (os.path.join(tmp, f) for f in ("gen.wsrx", "blend.wsrx"))
    procs = {}
    for name, argv, out in (
            ("export", ["gan_sr_wind_field_tpu_torch.run", "--cfg",
                        test_copy(tmp, "export"), "--export", art,
                        "--synthetic", *LEG_DATA], art),
            ("interp", ["gan_sr_wind_field_tpu_torch.eval.interp", "--cfg",
                        test_copy(tmp, "interp"), "--gan", PACK_9K, "--psnr",
                        PACK_6K, "--alpha", "0.5", "--out", blend], blend)):
        cwd = os.path.join(tmp, f"cwd_{name}")
        os.makedirs(cwd, exist_ok=True)
        proc = subprocess.Popen(
            [sys.executable, "-m", *argv, "--device", "cpu"], cwd=cwd,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        CHILDREN.append(proc)
        os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
        procs[name] = (proc, time.time(), out)
    return procs


def finish(name, procs, timeout):
    """Wait for one of ``start_clis``'s processes: → (its output, its
    artifact's path, seconds from its start to the artifact's last
    write). Fails unless it exited 0."""
    proc, t0, path = procs[name]
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        fail(f"{name} failed:\n{out}")
    return out, path, os.path.getmtime(path) - t0


def log_seconds(out, first, last):
    """Seconds between the status lines holding ``first`` and ``last`` in
    a command line's output (their logging timestamps)."""
    import datetime

    def at(text):
        m = re.search(r"^(\S+ \S+) INFO: .*" + re.escape(text), out, re.M)
        if not m:
            fail(f"no status line with {text!r} in:\n{out}")
        return datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")

    return (at(last) - at(first)).total_seconds()


def deploy_phase(dev, card, tmp, built, procs):
    """Phase 10: (a) ``check_int8_kernel``; (b) run.py --serve 0
    --serve_int8 8 --serve_int8_trunk 8 (its main in process, with
    eval.server.serve replaced to keep the backend) calibrates on the
    first 8 test fields, then one batch of 8 other test fields through
    the exact path, the int8 head, the int8 trunk and both, each held to
    JAX's bound with its launches as predicted, and each path's serving
    ms at batch 8 and 32 beside kernel 5's; (c) run.py --export (its own
    process, ``procs``), the artifact's bytes and seconds, eval/server.py
    --artifact's backend against the plain path and the kernel path at
    batch 1 and 8 and timed, and a torch-only subprocess that runs the
    payload; (d) eval.interp (its own process, ``procs``): the endpoints
    reproduce each pack, alpha 0.5 serves (BLEND_SERVE, started here)."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(TEST_CFG)
    # (c)'s torch-only run of the artifact and (d)'s blended artifact,
    # each read on the host by a process of its own while (a) and (b) run;
    # both touch the card only once (c) writes the fields' file
    exported = finish("export", procs, TIMEOUT_S * 5)
    interp = finish("interp", procs, TIMEOUT_S * 5)
    fields = os.path.join(tmp, "blend_fields.npz")
    children = {}
    for name, argv in (
            ("torch_only", [TORCH_ONLY, exported[1],
                            os.path.join(tmp, "torch_only.pt"), str(dev),
                            fields]),
            ("blend", [BLEND_SERVE, REPO, interp[1], fields,
                       os.path.join(tmp, "blend_sr.npy"), str(dev)])):
        children[name] = subprocess.Popen(
            [sys.executable, "-c", *argv], cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(children[name])
    log(f"deploy: int8 conv kernel at {os.path.basename(TEST_CFG)}'s full "
        f"width ({card})")
    kernels = check_int8_kernel(cfg, dev, card, built)
    done("(a)")
    return _deploy(dev, card, tmp, cfg, test_copy(tmp, "deploy"), kernels,
                   (exported, interp, children, fields))


# phase 10 (c): the artifact's payload run by torch alone in a process of
# its own (argv: artifact, output .pt, device, the file to wait for): read
# on the host as soon as it starts, on the card once the file appears;
# it must import nothing of this repository
TORCH_ONLY = (
    "import json, os, struct, sys, time, torch\n"
    "from torch.export.passes import move_to_device_pass\n"
    "f = open(sys.argv[1], 'rb')\n"
    "assert f.read(4) == b'WSRX'\n"
    "(n,) = struct.unpack('<I', f.read(4))\n"
    "h = json.loads(f.read(n))\n"
    "program = torch.export.load(f)\n"
    "while not os.path.exists(sys.argv[4]):\n"
    "    time.sleep(0.05)\n"
    "dev = sys.argv[3]\n"
    "m = move_to_device_pass(program, dev).module()\n"
    "g = torch.Generator().manual_seed(2014)\n"
    "lr = torch.randn(2, *h['lr_shape'][1:], generator=g)\n"
    "z = torch.rand(2, *h['z_shape'][1:], generator=g)\n"
    "with torch.inference_mode():\n"
    "    torch.save(m(lr.to(dev), z.to(dev)).cpu(), sys.argv[2])\n"
    "bad = [k for k in sys.modules if k.startswith('gan_sr')]\n"
    "assert not bad, bad\n"
)
# phase 10 (d): the blended artifact served on the card in a process of
# its own (argv: repo, artifact, the fields' .npz, the output .npy,
# device): load_exported on the CPU as soon as it starts (deserializing is
# the load's cost), then, once the fields' file appears, the artifact
# moved to the card (ExportedSR.to) serves them
BLEND_SERVE = (
    "import os, sys, time\n"
    "t = time.monotonic()\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import numpy as np\n"
    "from gan_sr_wind_field_tpu_torch.eval.export import load_exported\n"
    "ex = load_exported(sys.argv[2], device='cpu')\n"
    "loaded = time.monotonic() - t\n"
    "while not os.path.exists(sys.argv[3]):\n"
    "    time.sleep(0.05)\n"
    "t = time.monotonic()\n"
    "ex = ex.to(sys.argv[5])\n"
    "f = np.load(sys.argv[3])\n"
    "np.save(sys.argv[4], ex.upscale(f['lr'], f['z']))\n"
    "print(f'the blended artifact: load_exported in {loaded:.3f} s (its own "
    "process, from phase 10 (a)), on {ex.device} and served '\n"
    "      f'{len(f[\"lr\"])} fields in {time.monotonic() - t:.3f} s')\n"
)


def _deploy(dev, card, tmp, cfg, ini, kernels, started):
    """Phase 10 (b) to (d); ``started`` is (run.py --export's and
    eval.interp's ``finish``, the TORCH_ONLY and BLEND_SERVE processes by
    name, the path of the fields' file they wait for)."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval import interp, server
    from gan_sr_wind_field_tpu_torch.eval.export import (
        ExportedSR,
        read_header,
    )
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR

    # (b) int8 serving through the command line
    cwd = os.path.join(tmp, "cwd_deploy")
    os.makedirs(cwd, exist_ok=True)
    kept = {}
    real_serve, real_pre = server.serve, run.preprocess

    def keep_data(*a, **kw):
        kept["data"] = real_pre(*a, **kw)
        return kept["data"]

    server.serve = lambda backend, **kw: kept.update(backend=backend)
    run.preprocess = keep_data
    old = os.getcwd()
    t = time.monotonic()
    try:
        os.chdir(cwd)
        run.main(["--cfg", ini, "--serve", "0", "--serve_int8", "8",
                  "--serve_int8_trunk", "8", "--synthetic", *LEG_DATA])
    finally:
        os.chdir(old)
        server.serve, run.preprocess = real_serve, real_pre
    sr = kept.pop("backend")
    ds_test = kept.pop("data")[1]
    log(f"  run.py --serve 0 --serve_int8 8 --serve_int8_trunk 8: "
        f"calibrated on the first {min(8, len(ds_test))} of "
        f"{len(ds_test)} test fields, "
        f"backend ready in {time.monotonic() - t:.3f} s wall")
    if sr.qhead is None or sr.qtrunk is None:
        fail("--serve_int8[_trunk] did not calibrate the served backend")
    rng = np.random.default_rng(2013)
    # 8 other test fields, each cut to the training patch at its centre
    n_test = len(ds_test)
    fields = [ds_test.get((8 + i) % n_test, rng) for i in range(8)]
    p = cfg.gan_config.slice_size // cfg.scale
    o = (fields[0][0].shape[0] - p) // 2
    lr = np.stack([f[0][o:o + p, o:o + p] for f in fields])
    s = cfg.scale
    z = np.stack([f[2][s * o:s * (o + p), s * o:s * (o + p)]
                  for f in fields])
    qh, qt = sr.qhead, sr.qtrunk
    # the exact path with the module head, the int8 paths' yardstick; kernel
    # 5 (the exact path as committed) is timed beside them below
    module_head(sr)
    paths = {"bf16 module head": (None, None), "int8 head": (qh, None),
             "int8 trunk": (None, qt), "both": (qh, qt)}
    J = 3 * cfg.generator.num_RRDB
    per_trunk = J * cfg.generator.num_RDB_convs
    # one launch of the head pair; per RDB step the growth convs and the LFF
    want_launches = {"bf16 module head": (1, 0), "int8 head": (1, 1),
                     "int8 trunk": (0, per_trunk),
                     "both": (0, per_trunk + 1)}
    outs = {}
    reset_counters()
    for name, (h, q) in paths.items():
        sr.qhead, sr.qtrunk = h, q
        before = (counters()[0], counters()[4], int8_launches())
        outs[name] = sr.upscale(lr, z)
        got = (counters()[0] - before[0], int8_launches() - before[2])
        log(f"  {name}: served 8 test fields at LR {lr.shape[1:4]}; "
            f"launches trunk kernel / conv_int8 {got}, predicted "
            f"{want_launches[name]}; head kernel "
            f"{counters()[4] - before[1]}")
        if got != want_launches[name] or counters()[4] != before[1]:
            fail(f"{name} launched {got}")
        if not np.isfinite(outs[name]).all():
            fail(f"{name} served a non-finite output")
    serve_int8 = int8_launches(each=True)
    log(f"  conv_int8 launches by entry point (head pair, requantizing "
        f"growth conv, conv): {serve_int8}")
    if not all(serve_int8):
        fail(f"an entry point of conv_int8 was not launched: {serve_int8}")
    # the same batch through the plain versions of the entry points on the
    # card: the served int8 outputs do not change by a bit
    with plain_int8_paths():
        for name in INT8_TOL:
            sr.qhead, sr.qtrunk = paths[name]
            before = int8_launches()
            same = np.array_equal(sr.upscale(lr, z), outs[name])
            log(f"  {name}: the kernels' served output equals the plain "
                f"composition's bit for bit: {same}")
            if not same or int8_launches() != before:
                fail(f"{name}: the served int8 output differs from the plain "
                     f"composition's")
    exact = outs["bf16 module head"]
    for name, tol in INT8_TOL.items():
        err = rel_l2(torch.from_numpy(outs[name]), torch.from_numpy(exact))
        log(f"  {name} vs the exact bf16 path: PSNR "
            f"{psnr_db(outs[name], exact):.1f} dB (the JAX package's int8 "
            f"head on a TPU: {JAX_INT8_PSNR_DB} dB)")
        check(f"{name} vs the exact bf16 path", err, tol)
    sr_h = WindFieldSR(load_config(ini), sr.G.state_dict(), device=dev)
    if sr_h.head_packed is None:
        fail("the exact path as committed does not take kernel 5")
    lr_d, z_d = (torch.from_numpy(v).to(dev) for v in (lr, z))
    lr32, z32 = (torch.cat([v] * 4) for v in (lr_d, z_d))
    serve_ms = {}
    for n, (lb, zb) in ((8, (lr_d, z_d)), (32, (lr32, z32))):
        kw = dict(reps=5 if n == 8 else 1)
        for name, (h, q) in paths.items():
            sr.qhead, sr.qtrunk = h, q
            serve_ms[(name, n)] = cuda_ms(lambda: sr._generate(lb, zb), **kw)
        serve_ms[("kernel 5", n)] = cuda_ms(lambda: sr_h._generate(lb, zb),
                                            **kw)
        log(f"  serving at batch {n}: " + ", ".join(
            f"{name} {serve_ms[(name, n)]:.3f} ms" for name in
            (*paths, "kernel 5")) + f" ({card})")
    with torch.inference_mode():
        for name in INT8_TOL:
            sr.qhead, sr.qtrunk = paths[name]
            kernel_split(f"  {name} serving at batch 8, by kernel",
                         lambda: sr._generate(lr_d, z_d), card,
                         INT8_SPLIT_NAMES)
    # the served backend, back on the exact path: the 6k pack's EMA
    # generator, as --use and --export take it
    sr.dequantize()
    sr6 = sr
    del sr, sr_h, lr32, z32, outs
    torch.cuda.empty_cache()

    done("(b)")
    # (c) the artifact of run.py --export (phase 8 runs --use on the same
    # weights), eval/server.py --artifact. The export's own seconds: from
    # its EMA weights' status line to its artifact's
    (export_out, art, export_end), (interp_out, blend, interp_end), \
        children, fields_npz = started
    export_s = log_seconds(export_out, "using EMA generator weights",
                           "exported generator")
    # the two processes go on to the card once the fields' file is there
    # (written whole, then renamed), beside this one's load
    np.savez(fields_npz + ".part.npz", lr=lr, z=z)
    os.replace(fields_npz + ".part.npz", fields_npz)
    for line in re.findall(r"^\S+ (\S+) INFO: (.{0,60})", export_out, re.M):
        log(f"    run.py --export at {line[0]}: {line[1]}")
    header = read_header(art)
    if header["format_version"] != 2 or "norm_stats" not in header:
        fail(f"the artifact's header is {header}")
    t = time.monotonic()
    server.serve = lambda backend, **kw: kept.update(backend=backend, **kw)
    try:
        server.main(["--artifact", art, "--port", "0"])
    finally:
        server.serve = real_serve
    load_s = time.monotonic() - t
    ex = kept.pop("backend")
    log(f"  run.py --export (its own process from phase 7's start, its "
        f"artifact written {export_end:.3f} s after it): "
        f"{os.path.getsize(art)} bytes, exported in {export_s:.3f} s; "
        f"eval/server.py --artifact built its {type(ex).__name__} backend "
        f"in {load_s:.3f} s (tile {kept['tile']}, overlap "
        f"{kept['tile_overlap']})")
    if not isinstance(ex, ExportedSR) or ex.device.type != dev.type:
        fail("eval/server.py --artifact built no ExportedSR on the card")
    for n in (1, 8):
        reset_counters()
        got = torch.from_numpy(ex.upscale(lr[:n], z[:n]))
        with torch.inference_mode():
            plain = sr6.G(lr_d[:n], z_d[:n]).cpu()
        if counters() != (0, 0, 0, 0, 0) or int8_launches():
            fail(f"the artifact or the plain path launched {counters()}")
        check(f"artifact at batch {n} vs WindFieldSR's plain path",
              rel_l2(got, plain), EXPORT_PLAIN_TOL)
        check(f"artifact at batch {n} vs the kernel path",
              rel_l2(got, torch.from_numpy(sr6.upscale(lr[:n], z[:n]))),
              EXPORT_KERNEL_TOL)
    # both processes are done with the card before anything here is timed
    outs = {}
    for name, proc in children.items():
        outs[name], _ = proc.communicate(timeout=TIMEOUT_S * 2)
        if proc.returncode != 0:
            fail(f"the {name} process failed:\n{outs[name]}")
    with torch.inference_mode():
        art_ms = cuda_ms(lambda: ex._module(lr_d, z_d))
        kern_ms = cuda_ms(lambda: sr6._generate(lr_d, z_d))
    log(f"  serving at batch 8: artifact {art_ms:.3f} ms, kernel path "
        f"{kern_ms:.3f} ms ({card})")

    # (d) network interpolation of the two committed packs
    sr9 = WindFieldSR.from_continuation(load_config(ini), PACK_9K,
                                        device=dev)
    p9, p6 = sr9.G.state_dict(), sr6.G.state_dict()
    for alpha, want in ((1.0, p9), (0.0, p6)):
        got = interp.blend_params(p9, p6, alpha)
        same = all(torch.equal(got[k], v) for k, v in want.items())
        log(f"  blend_params(9k, 6k, {alpha}) equals the "
            f"{'9k' if alpha else '6k'} pack's generator tensor by tensor: "
            f"{same}")
        if not same:
            fail(f"alpha {alpha} does not reproduce its pack")
    log(f"  {interp_out.strip().splitlines()[-1]}")
    log(f"  {outs['blend'].strip().splitlines()[-1]}")
    got = torch.from_numpy(np.load(os.path.join(tmp, "blend_sr.npy")))
    mid = WindFieldSR(load_config(ini), interp.blend_params(p9, p6, 0.5),
                      device=dev)
    with torch.inference_mode():
        plain = mid.G(lr_d, z_d).cpu()
    log(f"  eval.interp --alpha 0.5 (its own process from phase 7's start, "
        f"its artifact written {interp_end:.3f} s after it): "
        f"{os.path.getsize(blend)} bytes; served 8 fields, finite "
        f"{bool(torch.isfinite(got).all())}")
    if not torch.isfinite(got).all():
        fail("the blended artifact served a non-finite output")
    check("blended artifact vs WindFieldSR's plain path on the blend",
          rel_l2(got, plain), EXPORT_PLAIN_TOL)
    del sr9, mid, p9, p6
    # the torch-only process, against this one on its inputs
    gen = torch.Generator().manual_seed(2014)
    lr2 = torch.randn(2, *header["lr_shape"][1:], generator=gen)
    z2 = torch.rand(2, *header["z_shape"][1:], generator=gen)
    with torch.inference_mode():
        want = ex._module(lr2.to(dev), z2.to(dev)).cpu()
    check("the payload run by torch alone in a subprocess vs ExportedSR",
          rel_l2(torch.load(os.path.join(tmp, "torch_only.pt")), want),
          EXPORT_PLAIN_TOL)
    del ex, sr6
    torch.cuda.empty_cache()
    return dict(kernels=kernels, launches=serve_int8,
                serve_ms=serve_ms, artifact_ms=art_ms, kernel_path_ms=kern_ms,
                export_s=export_s, load_s=load_s,
                artifact_bytes=os.path.getsize(art))


# conv_int8's entry points: (key in check_int8_kernel's results, index in
# int8_launches(each=True))
INT8_ENTRY = {"conv_int8_head_pair": ("pair", 0),
              "conv_int8_requant": ("requant", 1), "conv_int8": ("lff", 2)}


def int8_row(name, dp, replaces, **extra):
    """The kernel line's row of one conv_int8 entry point: its launches in
    phase 10 (b)'s served batches, its check and times at full width."""
    key, i = INT8_ENTRY[name]
    err, ms, plain_ms, bd, lib_ms = dp["kernels"][key]
    return {"name": name, "route": "cuda", "source": f"{CSRC}/conv_int8.cu",
            "replaces": f"gan_sr_wind_field_tpu/ops/{replaces}",
            "replaces_kind": "XLA int8 conv_general_dilated, no Pallas kernel",
            "launches": dp["launches"][i], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bd[0], "bound_by": bd[1],
            "library_ms": lib_ms, "mma": "wgmma s8", **extra}


# phase 11: the reference's users on the card. Its .pth files into the
# readers at 8x and 16x (configs/fullvol8x3k.ini, fullvol16x2k.ini), the
# physics-weight search on milestone9k and the bf16 Adam moments, in phase
# 7's temporary directory on its data
CFG_8X = os.path.join(REPO, "configs", "fullvol8x3k.ini")
CFG_16X = os.path.join(REPO, "configs", "fullvol16x2k.ini")
FULL_VOLUME = 128                    # HR x and y of a full volume
REF_LEG_STEPS = 4                    # (c): 4 G steps, one validation
SEARCH_TRIALS = 3
SEARCH_ARGS = ("--num_samples", str(SEARCH_TRIALS), "--asha_grace", "2",
               "--asha_eta", "2")
SEARCH_SCHEDULE = dict(niter=4, val_period=2)
SEARCH_BATCH = 8
SEARCH_TOL = 1e-5   # the first G step's total against sum(w_k loss_k)
SR_BATCH = 32


def seeded_discriminator(cfg, seed, dev):
    """The configuration's discriminator at its training patch, weights
    drawn from ``seed`` (as ``WindFieldGAN._build_D`` builds it)."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.discriminator import (
        Discriminator3D,
    )

    d, g = cfg.discriminator, cfg.gan_config
    return Discriminator3D(
        in_channels=d.in_num_ch, base_features=d.num_features,
        feat_kern_size=d.feat_kern_size, norm=d.norm_type,
        number_of_z_layers=g.number_of_z_layers,
        enable_slicing=g.enable_slicing,
        dropout_probability=d.dropout_probability,
        init_scale=d.weight_init_scale, dtype=torch.bfloat16,
        spatial=(g.slice_size, g.slice_size),
        generator=torch.Generator().manual_seed(seed)).to(dev)


def ref_config(tmp, root, path, ini_path, **training):
    """A copy of ``path`` with its folders in ``tmp`` (runs under
    ``root``), phase 7's data, no tensorboard and ``training``
    overrides; → (config, its INI)."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(path)
    cfg.env.root_path = os.path.join(tmp, root)
    cfg.env.this_runs_folder = os.path.join(tmp, root, "runs", "unset")
    cfg.env.data_root = os.path.join(tmp, "data")
    cfg.use_tensorboard_logger = False
    for k, v in training.items():
        setattr(cfg.training, k, v)
    cfg.save(ini_path)
    return cfg, ini_path


def check_stencils_at(dev):
    """Phase 11: kernels 3 and 4 at the shapes its G steps and validations
    give them: HR 128x128x10 at batch 8 and 1 (8x), 64x64x10 at batch 8
    (the search). Returns the max abs errors (gradient, adjoint)."""
    errs = [check_stencil_kernels(dev, n, xy)
            for n, xy in ((8, FULL_VOLUME), (1, FULL_VOLUME), (8, 64))]
    return tuple(max(e[i] for e in errs) for i in range(2))


def reference_files(dev, card, tmp):
    """Phase 11 (a): seeded full-width generators of the 8x and 16x
    configurations written as reference G.pth files and read back bit for
    bit; WindFieldSR.from_checkpoint on each serves full volumes equal bit
    for bit to WindFieldSR on the seeded weights, one trunk launch a batch;
    a seeded milestone9k D through D.pth forwards as the seeded one.
    Returns {scale: G.pth}, the launches and the forward ms."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.utils.torch_import import (
        export_discriminator_state_dict,
        load_reference_checkpoint,
        load_reference_discriminator,
        save_reference_checkpoint,
    )

    paths, launches, fwd_ms, errs = {}, [0] * 5, {}, []
    rng = np.random.default_rng(2011)
    for ini, n in ((CFG_8X, 8), (CFG_16X, 1)):
        cfg = load_config(ini)
        s, zl = cfg.scale, cfg.gan_config.number_of_z_layers
        G0 = generator_from_config(cfg, device=dev, seed=2001 + s)
        params = G0.state_dict()
        path = os.path.join(tmp, f"G_{s}x.pth")
        t = time.monotonic()
        save_reference_checkpoint(path, params, G0)
        secs = time.monotonic() - t
        back, _, _ = load_reference_checkpoint(G0, path)
        same = (list(back) == list(params) and all(
            torch.equal(back[k], params[k].cpu()) for k in params))
        log(f"  {s}x: {os.path.basename(ini)} G.pth {os.path.getsize(path)} "
            f"bytes written in {secs:.2f} s; {len(back)} tensors read back "
            f"bit for bit {same} ({len(G0.upconvs)} upconvs)")
        if not same or len(G0.upconvs) != int(math.log2(s)):
            fail(f"the {s}x G.pth does not read back as written")
        coords = np.arange(FULL_VOLUME, dtype=np.float32) * 150.0
        sr = WindFieldSR.from_checkpoint(cfg, path, coords, coords,
                                         device=dev)
        direct = WindFieldSR(cfg, params, device=dev)
        del G0
        lr, z = sample(rng, n, FULL_VOLUME // s, FULL_VOLUME, zl,
                       cfg.lr_num_channels)
        reset_counters()
        got = sr.upscale(lr, z)
        served = counters()
        want = direct.upscale(lr, z)
        exact = bool(np.array_equal(got, want))
        lr_d, z_d = (torch.from_numpy(a).to(dev) for a in (lr, z))
        with torch.inference_mode():
            ms = cuda_ms(lambda: sr._generate(lr_d, z_d))
        fwd_ms[s] = ms
        log(f"  {s}x: from_checkpoint(G.pth) served {n} full volume(s) LR "
            f"{FULL_VOLUME // s}x{FULL_VOLUME // s}x{zl} -> HR "
            f"{FULL_VOLUME}x{FULL_VOLUME}x{zl}: launches {LAUNCH_LABELS} "
            f"{served}; vs WindFieldSR on the seeded weights bit for bit "
            f"{exact}; forward {ms:.3f} ms per batch of {n} ({card})")
        if (got.shape != (n, FULL_VOLUME, FULL_VOLUME, zl, 3)
                or not np.isfinite(got).all()):
            fail(f"the {s}x output is {got.shape}, finite "
                 f"{bool(np.isfinite(got).all())}")
        if not exact or served != (1, 0, 0, 0, 1):
            fail(f"the {s}x G.pth served with launches {served}, equal "
                 f"{exact}")
        launches = [a + b for a, b in zip(launches, served)]
        # kernel 1 (at 8x also its residual mode and kernel 2, as the 8x
        # leg trains at batch 8) at this scale's served batch, and at the
        # test chain's batch of 1
        errs.append(check_trunk_at(sr.G, sr.packed, lr_d, s == 8, 2011 + s))
        if n > 1:
            errs.append(check_trunk_at(sr.G, sr.packed, lr_d[:1], False, 0))
        paths[s] = path
        del sr, direct
        torch.cuda.empty_cache()

    # D: a seeded milestone9k D whose statistics have moved, through D.pth
    cfg9 = load_config(CFG)
    D = seeded_discriminator(cfg9, 2001, dev)
    p = cfg9.gan_config.slice_size
    x = torch.from_numpy(0.1 * rng.standard_normal(
        (8, p, p, cfg9.gan_config.number_of_z_layers, 3)).astype(
            np.float32)).to(dev)
    with torch.no_grad():
        D(x, train=True, update_stats=True)
    buffers = dict(D.named_buffers())
    params = {k: v for k, v in D.named_parameters()}
    d_path = os.path.join(tmp, "D.pth")
    torch.save(export_discriminator_state_dict(params, buffers, D), d_path)
    D2 = seeded_discriminator(cfg9, 7, dev)
    p2, s2 = load_reference_discriminator(D2, d_path)
    D2.load_state_dict({**p2, **s2})
    with torch.no_grad():
        a, b = D(x, train=False), D2(x, train=False)
    exact = torch.equal(a, b)
    log(f"  D.pth (milestone9k's D, enable_slicing, {len(p2)} parameters, "
        f"{len(s2)} statistics): logits of D from the file vs the seeded D "
        f"bit for bit {exact}")
    if not exact or not bool(torch.isfinite(a).all()):
        fail("the D from D.pth does not forward as the seeded D")
    err_fwd = max(e[0] for e in errs)
    err_bwd = max(e[1] for e in errs if e[1] is not None)
    return paths, tuple(launches), fwd_ms, (err_fwd, err_bwd)


def reference_test(dev, card, tmp, g_path):
    """Phase 11 (b): run.py --test on a copy of fullvol8x3k from G.pth:
    23 finite rows, one trunk launch per field, PSNR against trilinear.
    Returns the launches and wall seconds."""
    ini = os.path.join(tmp, "ref8x_test.ini")
    cfg, _ = ref_config(tmp, "ref8x_test", CFG_8X, ini)
    cfg.env.generator_load_path = g_path
    cfg.save(ini)
    cwd = os.path.join(tmp, "cwd_ref8x")
    avgs, _, launches, secs = cli_pass("--test 8x from G.pth", cwd,
                                       "--cfg", ini, "--test")
    _, rows = read_metrics(os.path.join(cwd, "test_output",
                                        f"{cfg.name}____metrics.csv"))
    ok = len(rows) == TEST_FIELDS and all(math.isfinite(v)
                                          for v in rows.values())
    log(f"  --test 8x: {len(rows)} rows, all finite {ok}; PSNR "
        f"{avgs['PSNR']:.6f} dB, trilinear {avgs['PSNR_trilinear']:.6f} dB "
        f"(seeded weights: no quality bound)")
    if not ok:
        fail(f"--test 8x wrote {len(rows)} rows")
    return launches, secs


def reference_leg(dev, card, tmp, g_path):
    """Phase 11 (c): run.py --train on a copy of fullvol8x3k warm-started
    from G.pth, 4 G steps at batch 8 on full volumes and one validation:
    finite losses, the EMA at the first step the imported G, launches as
    predicted, the G step's ms. Returns the launches and that ms."""
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN
    from gan_sr_wind_field_tpu_torch.utils.torch_import import (
        load_reference_checkpoint,
    )

    ini = os.path.join(tmp, "ref8x_leg.ini")
    cfg, _ = ref_config(tmp, "ref8x_leg", CFG_8X, ini,
                        niter=REF_LEG_STEPS, val_period=REF_LEG_STEPS,
                        log_period=REF_LEG_STEPS, save_model_period=10_000)
    cfg.load_model_from_save = True
    cfg.env.generator_load_path = g_path
    cfg.save(ini)
    first, totals = {}, []

    def check_first(step):
        def call(gan, state, *a, **kw):
            if not first:
                want, _, _ = load_reference_checkpoint(gan.G, g_path)
                first["G"] = all(torch.equal(state.params_G[k].cpu(), v)
                                 for k, v in want.items())
                first["EMA"] = all(
                    torch.equal(state.params_G_ema[k].cpu(), v)
                    for k, v in want.items())
            out = step(gan, state, *a, **kw)
            totals.append(out[1]["total"])  # read after the leg: no sync
            return out
        return call

    probe = LegProbe()
    probe.patch(WindFieldGAN, "train_step", check_first)
    reset_counters()
    t = time.monotonic()
    try:
        state = run.main(["--cfg", ini, "--train", "--synthetic",
                          *LEG_DATA])
    finally:
        probe.close()
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    launches = counters()
    totals = [float(v) for v in totals]
    n_val = probe.calls["val_step"]
    predicted = tuple(REF_LEG_STEPS * a + n_val * c + e for a, c, e in
                      zip(G_STEP_LAUNCHES, VAL_LAUNCHES, GENERATE_LAUNCHES))
    finite = (len(totals) == REF_LEG_STEPS
              and all(math.isfinite(v) for v in totals))
    # G steps only (no D step to take a median of): its 2 and 3, away
    # from the first step and the boundary at 4
    each = [a[2].elapsed_time(b[2]) for a, b in
            zip(probe.steps, probe.steps[1:]) if 1 < a[0] < REF_LEG_STEPS]
    ms, count = statistics.median(each), len(each)
    lr_xy = FULL_VOLUME // cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    log(f"  --train 8x from G.pth: {REF_LEG_STEPS} G steps at batch "
        f"{cfg.dataset_train.batch_size} (LR {lr_xy}x{lr_xy}x{zl}, HR "
        f"{FULL_VOLUME}x{FULL_VOLUME}x{zl}), "
        f"{n_val} validation batches, in {secs:.1f} s; the first step's G "
        f"and EMA the imported G: {first.get('G')}, {first.get('EMA')}; "
        f"G totals {[round(v, 6) for v in totals]}; launches "
        f"{LAUNCH_LABELS} {launches}, predicted {predicted}")
    log(f"  8x G step {ms:.3f} ms (median of {count}, CUDA events from one "
        f"step's start to the next; {card})")
    if not (first.get("G") and first.get("EMA") and finite):
        fail("the 8x warm start from G.pth is not the imported G, or a loss "
             "is not finite")
    if (state.it != REF_LEG_STEPS or launches != predicted
            or probe.calls["generate"] != 1):
        fail(f"the 8x leg ended at {state.it}, launched {launches}, "
             f"predicted {predicted}")
    return launches, ms


class SearchProbe(Patches):
    """What the search runs, from the outside: each trial's arguments,
    host seconds and final state; each trial's first step, its state
    (after the step's host part), inputs and weights kept for
    ``first_totals``, which runs after the search's counts are read; the
    steps and validation calls."""

    def __init__(self):
        import torch

        from gan_sr_wind_field_tpu_torch.search import asha, driver
        from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

        super().__init__()
        self.trials, self.firsts, self.reports = [], [], []
        self.steps = self.val_steps = 0
        probe = self

        def on_report(real):
            def call(sched, it, metric):
                keep = real(sched, it, metric)
                probe.reports.append((len(probe.trials), it, metric, keep))
                return keep
            return call

        def on_trial(real):
            def call(gan, cfg, ds_train, ds_val, point, asha, trial_id,
                     batch_size, status, resident=None):
                torch.cuda.synchronize()
                t = time.monotonic()
                rec = real(gan, cfg, ds_train, ds_val, point, asha,
                           trial_id, batch_size, status, resident)
                torch.cuda.synchronize()
                probe.trials.append(dict(
                    rec=rec, secs=time.monotonic() - t, gan=gan, cfg=cfg,
                    ds=(ds_train, ds_val), resident=resident,
                    state=probe.last, point=point))
                return rec
            return call

        def on_train_step(real):
            def step(gan, state, *a, **kw):
                probe.steps += 1
                probe.last = state
                out = real(gan, state, *a, **kw)
                if state.it == 1:
                    probe.firsts[-1]["total"] = out[1]["total"]
                return out
            return step

        def on_step(real):
            # the device part of a step: on a trial's first, a copy of its
            # state (the random generator's included) and its inputs
            def step(gan, state, lr, hr, z, augment, g_step, weights=None):
                if not state.it:
                    probe.firsts.append(dict(
                        gan=gan, state=copy_state(state), weights=weights,
                        batch=tuple(a.clone() for a in (lr, hr, z)),
                        augment=augment, g_step=g_step))
                return real(gan, state, lr, hr, z, augment, g_step, weights)
            return step

        def on_val(real):
            def call(*a, **kw):
                probe.val_steps += 1
                return real(*a, **kw)
            return call

        self.last = None
        self.patch(asha.ASHAScheduler, "report", on_report)
        self.patch(driver, "run_trial", on_trial)
        self.patch(WindFieldGAN, "train_step", on_train_step)
        self.patch(WindFieldGAN, "_step", on_step)
        self.patch(WindFieldGAN, "val_step", on_val)

    def first_totals(self):
        """Each trial's first G-step total against sum(w_k loss_k) of its
        own weights, the losses recomputed with unit weights on the kept
        state, batch and draws; call it after the counts are read."""
        import torch

        from gan_sr_wind_field_tpu_torch.data.augment import augment_batch

        keys = {"pix": "pix", "gxy": "xy_gradient", "gz": "z_gradient",
                "div": "divergence", "xydiv": "xy_divergence"}
        out = []
        for f in self.firsts:
            gan, st, w = f["gan"], f["state"], f["weights"]
            if not (f["augment"] and f["g_step"]):
                fail("a trial's first step is not an augmented G step")
            batch = augment_batch(st.rng, *f["batch"])
            params = {k: v.requires_grad_() for k, v in st.params_G.items()}
            # it 1: the schedules' values the step's host part wrote
            _, (raw, _) = gan._g_losses(params, st, *batch, 1, st.rng, True,
                                        {k: 1.0 for k in w})
            want = (raw["adversarial"] + raw["feature_D"]
                    + sum(w[k] * raw[v] for k, v in keys.items())).detach()
            out.append((float(f["total"]), float(want)))
        self.firsts = []
        torch.cuda.empty_cache()
        return out


def reference_search(dev, card, tmp):
    """Phase 11 (d): run.py --param_search on a copy of milestone9k (batch
    8, niter 4, validation every 2 its, 3 trials under ASHA grace 2, eta
    2): 3 records with finite PSNRs, ASHA's stops, each trial's first G
    step the sum of its own weights' losses, trial 0 a bare weighted
    train_step loop from its seed, launches as the steps and validations
    predict. Returns the launches, the seconds per trial and the search's
    resident volumes (for (e))."""
    import json

    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.search import driver
    from gan_sr_wind_field_tpu_torch.train.loop import val_seed

    ini = os.path.join(tmp, "search.ini")
    cfg, _ = ref_config(tmp, "search", CFG, ini, **SEARCH_SCHEDULE)
    cfg.dataset_train.batch_size = cfg.dataset_val.batch_size = SEARCH_BATCH
    cfg.save(ini)
    probe = SearchProbe()
    reset_counters()
    t = time.monotonic()
    try:
        recs = run.main(["--cfg", ini, "--param_search", "--synthetic",
                         *LEG_DATA, *SEARCH_ARGS])
    finally:
        probe.close()
    secs = time.monotonic() - t
    launches = counters()
    firsts = probe.first_totals()  # its launches after the counts' read
    folder = cfg_run_folder(tmp, "search")
    with open(os.path.join(folder, "param_search.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    with open(os.path.join(folder, "param_search_best.json")) as f:
        best = json.load(f)
    for r, tr in zip(recs, probe.trials):
        log(f"  trial {r['trial']}: {r['point']}; it {r['it']}, PSNR "
            f"{r['PSNR']:.4f}, best {r['best_PSNR']:.4f}, stopped early "
            f"{r['stopped_early']}; {tr['secs']:.2f} s")
    if (len(recs) != SEARCH_TRIALS
            or lines != json.loads(json.dumps(recs))
            or best != max(lines, key=lambda r: r["best_PSNR"])
            or not all(math.isfinite(r["PSNR"]) for r in recs)
            or [r["point"] for r in recs]
            != driver.INITIAL_POINTS[:SEARCH_TRIALS]):
        fail(f"the search's records: {recs}")
    # ASHA's reports in order (trial, rung, PSNR, continue); a trial stops
    # where its report said stop, at a rung
    niter, period = SEARCH_SCHEDULE["niter"], SEARCH_SCHEDULE["val_period"]
    rungs = driver.ASHAScheduler(max_t=niter, grace_period=2,
                                 reduction_factor=2).rung_iterations()
    log("  ASHA reports (trial, it, PSNR, continue): " + ", ".join(
        f"({t}, {it}, {m:.4f}, {k})" for t, it, m, k in probe.reports))
    stops = {t: it for t, it, _, k in probe.reports if not k}
    if any(stops.get(r["trial"]) != (r["it"] if r["stopped_early"]
                                     else None) for r in recs):
        fail(f"the records' stops are not ASHA's: {stops}")
    if any(r["stopped_early"] != (r["it"] < niter) or
           (r["stopped_early"] and r["it"] not in rungs) for r in recs):
        fail(f"ASHA's stops are not at its rungs {rungs}: {recs}")
    gaps = [abs(a - b) / abs(a) for a, b in firsts]
    log(f"  each trial's first G-step total vs sum(w_k loss_k) of its own "
        f"weights: " + ", ".join(f"{a:.6f} / {b:.6f}" for a, b in firsts)
        + f"; largest rel gap {max(gaps):.3e} (tol {SEARCH_TOL:.0e})")
    if len(gaps) != SEARCH_TRIALS or max(gaps) > SEARCH_TOL:
        fail("a trial's first G step did not take its own weights")
    n_val_sweeps = sum(len([it for it in range(1, r["it"] + 1)
                            if it % period == 0 or it in rungs])
                       for r in recs)
    per_sweep = probe.val_steps // max(n_val_sweeps, 1)
    predicted = tuple(probe.steps * a + probe.val_steps * c for a, c in
                      zip(G_STEP_LAUNCHES, VAL_LAUNCHES))
    log(f"  search: {probe.steps} G steps, {n_val_sweeps} validations of "
        f"{per_sweep} batches in {secs:.1f} s, "
        f"{np.mean([tr['secs'] for tr in probe.trials]):.2f} s per trial; "
        f"launches {LAUNCH_LABELS} {launches}, predicted {predicted} "
        f"({card})")
    if (probe.steps != sum(r["it"] for r in recs) or launches != predicted
            or probe.val_steps != n_val_sweeps * per_sweep):
        fail(f"the search launched {launches}, predicted {predicted}")

    # trial 0 against a bare weighted train_step loop from its seed
    tr = probe.trials[0]
    gan, tcfg, (ds_train, ds_val), resident = (
        tr["gan"], tr["cfg"], tr["ds"], tr["resident"])
    fixed = tcfg.env.fixed_seed
    seed = fixed + recs[0]["trial"]
    weights = driver.point_to_weights(tr["point"], dev)
    rng_np = np.random.default_rng(seed)
    lr0, hr0, _ = ds_train.get(0, rng_np)
    state = gan.init_state(seed, (SEARCH_BATCH,) + lr0.shape,
                           (SEARCH_BATCH,) + hr0.shape)
    resident.seed, resident.count = seed, 0
    for it in range(1, recs[0]["it"] + 1):
        state, _ = gan.train_step(state, *next(resident), augment=True,
                                  weights=weights)
        if it % period == 0 or it in rungs:
            for bi, vb in enumerate(ds_val.batches(
                    SEARCH_BATCH, np.random.default_rng(fixed),
                    shuffle=False, drop_remainder=False)):
                gen = torch.Generator(device=dev).manual_seed(
                    val_seed(seed, it, bi))
                gan.val_step(state, *vb, generator=gen, weights=weights)
    diffs = tree_diffs(tr["state"], state)
    exact = all(v[2] for v in diffs.values())
    worst = max(v[1] for v in diffs.values())
    log(f"  trial 0 vs a bare weighted train_step loop from its seed: "
        f"bit-exact {exact}, largest rel L2 {worst:.3e}")
    if not exact and worst > RESUME_TOL:
        fail("trial 0 is not the bare weighted train_step loop")
    return launches, [tr["secs"] for tr in probe.trials], resident


def reference_sr_adam(dev, card, tmp, resident, f32_g_ms):
    """Phase 11 (e): optimizer_state_dtype bfloat16_sr on a copy of
    milestone9k at batch 32: steps 48-51 (G, G, D, D) through train_step
    and through train_chunk (CUDA graphs) from copies of one state, on the
    batches batch_at cuts from the search's resident volumes: bit for bit,
    bf16 moments, their bytes, the G step's ms beside phase 6's float32
    one. Returns the launches of both legs and the G step's ms."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    cfg = load_config(CFG)
    cfg.training.optimizer_state_dtype = "bfloat16_sr"
    g = cfg.gan_config
    p, zl = g.slice_size, g.number_of_z_layers
    coords = np.arange(p, dtype=np.float32) * 150.0
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    a = gan.init_state(2001, (SR_BATCH, p // cfg.scale, p // cfg.scale, zl,
                              cfg.lr_num_channels), (SR_BATCH, p, p, zl, 3))
    a.it = 47
    b = copy_state(a)
    kw = dict(resident.slice_kwargs(), batch_size=SR_BATCH)
    seed = 2011
    gen = torch.Generator(device=dev)
    reset_counters()
    ev, metrics = [], []
    for _ in range(4):
        batch = batch_at(resident.full, resident.zraw, seed, a.it, gen, **kw)
        ev.append((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)))
        ev[-1][0].record()
        a, m = gan.train_step(a, *batch, augment=True)
        ev[-1][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    per_step = counters()
    if not all(bool(torch.isfinite(v).all()) for m in metrics
               for v in m.values()):
        fail("a non-finite metric with bf16 moments")
    # the G step's time: it 49 (after it 48's warm-up) and the next two G
    # steps on a copy of the per-step leg's state, outside the counted legs
    c = copy_state(a)
    more = [it for it in range(c.it + 1, c.it + 64) if gan.is_g_step(it)][:2]
    for it in more:
        c.it = it - 1
        batch = batch_at(resident.full, resident.zraw, seed, c.it, gen, **kw)
        ev.append((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)))
        ev[-1][0].record()
        c, _ = gan.train_step(c, *batch, augment=True)
        ev[-1][1].record()
    torch.cuda.synchronize()
    del c
    reset_counters()
    b, _ = gan.train_chunk(b, resident.full, resident.zraw, seed, n_steps=4,
                           augment=True, **kw)
    torch.cuda.synchronize()
    chunked = counters()
    diffs = tree_diffs(b, a)
    exact = all(v[2] for v in diffs.values()) and torch.equal(
        a.rng.get_state(), b.rng.get_state())
    dtypes = {m.dtype for o in (a.opt_state_G, a.opt_state_D)
              for m in [*o.mu.values(), *o.nu.values()]}
    nbytes = sum(m.numel() * m.element_size()
                 for o in (a.opt_state_G, a.opt_state_D)
                 for m in [*o.mu.values(), *o.nu.values()])
    f32 = sum(m.numel() * 4 for o in (a.opt_state_G, a.opt_state_D)
              for m in [*o.mu.values(), *o.nu.values()])
    want = tuple(2 * x + 2 * y for x, y in zip(G_STEP_LAUNCHES,
                                               D_STEP_LAUNCHES))
    log(f"  bfloat16_sr: steps 48-51 (G, G, D, D) at batch {SR_BATCH}: "
        f"launches per step {per_step}, chunked (CUDA graphs, "
        f"{gan._graphs.replays} replays) {chunked}, predicted {want}; "
        f"chunked vs per-step bit-exact {exact} "
        + ", ".join(f"{k} {v[1]:.1e}" for k, v in diffs.items() if not v[2]))
    log(f"  bfloat16_sr: moments {sorted(str(d) for d in dtypes)}, "
        f"{nbytes} bytes against {f32} in float32 ({nbytes / f32:.3f})")
    if dtypes != {torch.bfloat16} or per_step != want or chunked != want \
            or gan._graphs.replays != 2:
        fail(f"the bfloat16_sr legs: moments {dtypes}, launches "
             f"{per_step} and {chunked}, predicted {want}, "
             f"{gan._graphs.replays} replays")
    if not exact:
        fail("the chunked bfloat16_sr leg is not the per-step leg")
    each = [ev[i][0].elapsed_time(ev[i][1]) for i in (1, 4, 5)]
    g_ms = statistics.median(each)
    log(f"  bfloat16_sr: G step {g_ms:.3f} ms, median of its 49, "
        f"{more[0]} and {more[1]} "
        f"({', '.join(f'{t:.3f}' for t in each)}; spread "
        f"{100 * (max(each) - min(each)) / g_ms:.1f} %), phase 6's float32 "
        f"G step {f32_g_ms:.3f} ms (one call after a warm-up) ({card})")
    gan._graphs = None
    return per_step, chunked, g_ms


def copy_state(state, device=None):
    """A deep copy of a training state, its generator's state included;
    its tensors on ``device`` (default: where they are)."""
    import dataclasses

    import torch

    def tree(t):
        return None if t is None else {
            k: v.to(device, copy=True) if device else v.clone()
            for k, v in t.items()}

    def adam(o):
        return type(o)(o.count.to(device, copy=True) if device
                       else o.count.clone(), tree(o.mu), tree(o.nu))

    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    return dataclasses.replace(
        state, params_G=tree(state.params_G), params_D=tree(state.params_D),
        batch_stats_D=tree(state.batch_stats_D),
        params_D_frozen=tree(state.params_D_frozen),
        params_G_ema=tree(state.params_G_ema),
        opt_state_G=adam(state.opt_state_G),
        opt_state_D=adam(state.opt_state_D), rng=rng)


def reference_phase(dev, card, tmp, f32_g_ms):
    """Phase 11: (a) .pth files at 8x and 16x, (b) --test and (c) --train
    on the 8x configuration from G.pth, (d) --param_search, (e) bf16 Adam
    moments. Returns the launches by part and the numbers it printed."""
    log(f"reference users: .pth import at {os.path.basename(CFG_8X)} and "
        f"{os.path.basename(CFG_16X)}, the search and bfloat16_sr on "
        f"{os.path.basename(CFG)} ({card})")
    t = [time.monotonic()]

    def took(part):
        t.append(time.monotonic())
        log(f"  ({part}) took {t[-1] - t[-2]:.1f} s")

    paths, served, fwd_ms, trunk_err = reference_files(dev, card, tmp)
    stencil_err = check_stencils_at(dev)
    took("a")
    test_launches, test_s = reference_test(dev, card, tmp, paths[8])
    took("b")
    leg_launches, g8_ms = reference_leg(dev, card, tmp, paths[8])
    took("c")
    search_launches, trial_s, resident = reference_search(dev, card, tmp)
    took("d")
    sr_step, sr_chunk, sr_g_ms = reference_sr_adam(dev, card, tmp, resident,
                                                   f32_g_ms)
    took("e")
    parts = dict(served=served, test=test_launches, leg=leg_launches,
                 search=search_launches, sr_steps=sr_step,
                 sr_chunk=sr_chunk)
    total = tuple(sum(v) for v in zip(*parts.values()))
    return dict(parts=parts, total=total, fwd_ms=fwd_ms, test_s=test_s,
                g8_ms=g8_ms, trial_s=trial_s, sr_g_ms=sr_g_ms,
                max_abs_err=(*trunk_err, *stencil_err), resident=resident)


# phase 12: conv_mode = horizontal_3D and D's instance norm at full width
H_INI = "milestone9k_horizontal.ini"
H_CONV_TOL = 1e-4   # the horizontal conv against a per-window F.conv3d loop
H_NORM_TOL = 1e-5   # instance norm, float32 against float64
H_INIT_TOL = 0.03   # a growth conv's init std against JAX's fan-in
# one horizontal step's launches: no trunk or head kernel (they need "3D",
# as JAX's trunk_fusable does), the stencil pair in G steps
H_G_STEP_LAUNCHES = (0, 0, 2, 1, 0)
H_D_STEP_LAUNCHES = (0, 0, 0, 0, 0)
H_LAUNCHES = (0, 0, 6, 2, 0)  # steps 48-51 and one val_step
# the card's kernels of a horizontal G step, for kernel_split: cuDNN's
# grouped 2D convs by pass, then the stencil pair
H_SPLIT_NAMES = ("dgrad", "wgrad", "fprop", *STENCIL_KERNELS.values(),
                 "implicit_convolve", "xmma", "cutlass", "elementwise",
                 "reduce", "Memcpy", "Memset")


def per_window_conv(x, w, padding, strides):
    """The horizontal conv's plain version: one F.conv3d per z-window on
    the zero-padded z axis, window i from z = i·sz, channels-last in and
    out; w is (W, O, C, kx, ky, kz)."""
    import torch
    import torch.nn.functional as F

    (px, py, pz), (sx, sy, sz) = padding, strides
    kz = w.shape[-1]
    xp = F.pad(x, (0, 0, pz, pz)).permute(0, 4, 1, 2, 3)
    out = [F.conv3d(xp[..., i * sz:i * sz + kz], w[i], stride=(sx, sy, 1),
                    padding=(px, py, 0)) for i in range(w.shape[0])]
    return torch.cat(out, dim=-1).permute(0, 2, 3, 4, 1)


def check_horizontal_blocks(state, dev):
    """Phase 12 (b): the horizontal conv against per_window_conv in
    float32 (TF32 off) on the state's own kernels at the shapes they run
    at: a growth conv 224 -> 32 at LR batch 8, hr_conv0 144 -> 144 (k = 5)
    at HR batch 2, D's block-0 strided (4, 4, 3) conv with stride (2, 2, 1)
    and its head_conv1 with stride (1, 1, 2); instance norm against a
    float64 version."""
    import torch

    from gan_sr_wind_field_tpu_torch.models.blocks import (
        horizontal_conv3d_cl,
        instance_norm,
    )

    gen = torch.Generator().manual_seed(2012)
    G, D = state.params_G, state.params_D
    cases = (
        ("growth conv 224->32, LR batch 8",
         G["rrdbs.0.rdbs.0.convs.3.weight"], (8, 16, 16, 10), (1, 1, 1),
         (1, 1, 1)),
        ("hr_conv0 144->144 k=5, HR batch 2", G["hr_conv0.weight"],
         (2, 64, 64, 10), (2, 2, 2), (1, 1, 1)),
        ("D block 0's strided (4, 4, 3) conv, stride (2, 2, 1), batch 8",
         D["blocks.0.strided_conv.weight"], (8, 64, 64, 10), (1, 1, 1),
         (2, 2, 1)),
        ("D head_conv1, stride (1, 1, 2), batch 8",
         D["head_conv1.weight"], (8, 4, 4, 10), (1, 1, 1), (1, 1, 2)),
    )
    for label, w, shape, pad, stride in cases:
        x = torch.randn(*shape, w.shape[2], generator=gen).to(dev)
        with torch.no_grad():
            got = horizontal_conv3d_cl(x, w, pad, stride)
            want = per_window_conv(x, w, pad, stride)
        if got.shape != want.shape:
            fail(f"{label}: shape {tuple(got.shape)}, plain "
                 f"{tuple(want.shape)}")
        check(f"horizontal conv vs per-window F.conv3d, {label}, "
              f"{tuple(w.shape)}", rel_l2(got, want), H_CONV_TOL)
    x = (torch.randn(8, 32, 32, 10, 64, generator=gen) * 3 + 1).to(dev)
    xd = x.double()
    mean = xd.mean((1, 2, 3), keepdim=True)
    var = ((xd - mean) ** 2).mean((1, 2, 3), keepdim=True)
    check("instance norm (8, 32, 32, 10, 64) vs float64",
          rel_l2(instance_norm(x, torch.float32),
                 (xd - mean) / torch.sqrt(var + 1e-5)), H_NORM_TOL)


def horizontal_phase(dev, card, tmp, resident, p6):
    """Phase 12: a copy of milestone9k with [GAN] conv_mode =
    horizontal_3D and [DISCRIMINATOR] norm_type = instance, written in
    phase 7's temporary directory, all else as committed (bf16, batch 32,
    seeded weights at the config's init scales, slicing, the stencil
    kernels): (a) parameter counts and a growth conv's init std against
    JAX's fan-in; (b) check_horizontal_blocks; (c) one G step's bf16
    gradients with kernels 3 and 4 against the same step with the plain
    stencil; (d) steps 48-51 and one val_step (drive_steps) with launches
    H_LAUNCHES; (e) steps 49 and 50 (G, D) through train_chunk against
    train_step from a copy of the state; (f) WindFieldSR serves a batch of
    8 with no trunk or head launch; (g) the G and D steps' ms beside phase
    6's and the G step by kernel; (h) peak memory and seconds. Returns the
    launches of (d) and (e) and the steps' ms."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    ini = os.path.join(tmp, H_INI)
    cfg = load_config(CFG)
    cfg.gan_config.conv_mode = "horizontal_3D"
    cfg.discriminator.norm_type = "instance"
    cfg.save(ini)
    cfg = load_config(ini)
    g = cfg.gan_config
    n, p, zl = cfg.dataset_train.batch_size, g.slice_size, g.number_of_z_layers
    coords = np.arange(p, dtype=np.float32) * 150.0
    gan = WindFieldGAN(cfg, coords, coords, device=dev)
    if gan.use_fused_trunk or gan._head_nograd != "modules" \
            or gan._wind_gradient is wind_field_gradient:
        fail("the horizontal GAN does not take the module path with the "
             "stencil kernels")
    state = gan.init_state(2001, (n, p // cfg.scale, p // cfg.scale, zl,
                                  cfg.lr_num_channels), (n, p, p, zl, 3))
    done("the models, seeded on the host")
    # (a) sizes and JAX's fan-in: W · kx · ky · kz · Cin
    n_g = sum(v.numel() for v in state.params_G.values())
    n_d = sum(v.numel() for v in state.params_D.values())
    w = state.params_G["rrdbs.0.rdbs.0.convs.3.weight"]
    W, _, cin = w.shape[:3]
    want = cfg.generator.weight_init_scale * math.sqrt(2.0 / (W * 27 * cin))
    std = w.float().std().item()
    log(f"horizontal: {H_INI} (conv_mode {g.conv_mode}, D norm "
        f"{cfg.discriminator.norm_type}), batch {n}; G {n_g} parameters, "
        f"D {n_d}, D's statistics {len(state.batch_stats_D)} tensors (the "
        f"slicing head's batch norms); growth conv {tuple(w.shape)} init "
        f"std {std:.6f}, JAX's fan-in sqrt(2 s^2/(W 27 Cin)) {want:.6f} "
        f"({100 * (std / want - 1):+.2f} %)")
    if abs(std / want - 1) > H_INIT_TOL or not state.batch_stats_D:
        fail("the horizontal init does not follow JAX's fan-in, or D has "
             "no slicing-head statistics")
    # (b) the blocks in float32
    check_horizontal_blocks(state, dev)
    done("(a, b)")
    kw = dict(resident.slice_kwargs(), batch_size=n)
    gen = torch.Generator(device=dev)
    seed = 2012

    def batch():
        out = batch_at(resident.full, resident.zraw, seed, batch.count, gen,
                       **kw)
        batch.count += 1
        return out

    batch.count = 0
    # (c) one G step's bf16 gradients, kernels 3 and 4 against the plain
    # stencil, on the same weights, batch, dropout mask and draws
    lr, hr, z = batch()
    keep = torch.rand((n, 1, 1, 1, gan.G.hr_conv1.weight.shape[2]),
                      generator=torch.Generator(device=dev).manual_seed(11),
                      device=dev) < 0.9
    res = []
    stencil = gan._wind_gradient
    for fn in (stencil, wind_field_gradient):
        gan._wind_gradient = fn
        try:
            res.append(gan.g_grads(
                state, lr, hr, z, 48,
                torch.Generator(device=dev).manual_seed(12),
                dropout_mask=keep))
        finally:
            gan._wind_gradient = stencil
    (loss_k, _, grads_k), (loss_p, _, grads_p) = res
    flat_k, flat_p = (torch.cat([x.flatten() for x in gs])
                      for gs in (grads_k, grads_p))
    log(f"  G step total loss: stencil kernels {loss_k.item():.6e}, plain "
        f"stencil {loss_p.item():.6e}")
    check("horizontal G gradients, stencil kernels vs plain stencil (bf16)",
          rel_l2(flat_k, flat_p), G_GRAD_TOL)
    del res, grads_k, grads_p, flat_k, flat_p
    done("(c)")
    # (d) four steps and a validation, the counts from 0
    step_ms = {}
    steps = drive_steps(gan, state, batch, H_G_STEP_LAUNCHES,
                        H_D_STEP_LAUNCHES, card, "horizontal path", step_ms)
    if steps != H_LAUNCHES:
        fail(f"the horizontal steps launched {steps}, expected {H_LAUNCHES}")
    done("(d)")
    # (e) steps 49 (G) and 50 (D) through train_chunk's CUDA graphs from a
    # copy of the state, against train_step on the same batches
    state.it = 48
    other = copy_state(state)
    for _ in range(2):
        state, _ = gan.train_step(state, *batch_at(
            resident.full, resident.zraw, seed, state.it, gen, **kw))
    reset_counters()
    other, _ = gan.train_chunk(other, resident.full, resident.zraw, seed,
                               n_steps=2, **kw)
    torch.cuda.synchronize()
    chunk = counters()
    diffs = tree_diffs(other, state)
    exact = all(v[2] for v in diffs.values())
    worst = max(v[1] for v in diffs.values())
    log(f"  train_chunk (G, D as CUDA graphs, captured in "
        f"{gan._graphs.capture_s:.2f} s) vs train_step: bit-exact {exact}, "
        f"largest rel L2 {worst:.3e}; launches {LAUNCH_LABELS} {chunk}")
    if (not exact and worst > RESUME_TOL) or chunk != tuple(
            a + b for a, b in zip(H_G_STEP_LAUNCHES, H_D_STEP_LAUNCHES)):
        fail("the chunked horizontal steps are not train_step's")
    gan._graphs = None
    del other
    torch.cuda.empty_cache()
    done("(e)")
    # (f) serving on the module path
    sr = WindFieldSR(cfg, state.params_G_ema, device=dev)
    done("WindFieldSR built")
    if sr.packed is not None or sr.head_packed is not None:
        fail("WindFieldSR packed kernel weights for a horizontal G")
    lr8, _, z8 = (t[:8] for t in batch())
    reset_counters()
    with torch.inference_mode():
        out = sr._generate(lr8, z8)
    served = counters()
    ema_state = copy.copy(state)
    ema_state.params_G = state.params_G_ema
    same = torch.equal(out, gan.generate(ema_state, lr8, z8))
    with torch.inference_mode():
        serve_ms = cuda_ms(lambda: sr._generate(lr8, z8))
    log(f"  WindFieldSR served 8 samples {tuple(out.shape)}, finite "
        f"{bool(out.isfinite().all())}; launches {LAUNCH_LABELS} {served}; "
        f"equal to gan.generate with the EMA bit for bit {same}; "
        f"{serve_ms:.3f} ms per batch of 8 (phase 6's 3D module head "
        f"{p6['fwd_ms']:.3f}) ({card})")
    if served != (0, 0, 0, 0, 0) or not out.isfinite().all() or not same:
        fail("the horizontal serving path")
    del sr, out
    done("(f)")
    # (g) the steps' times, (d)'s second G step and second D step (CUDA
    # events, each warm), beside phase 6's 3D steps; the G step by kernel
    g_ms, d_ms = step_ms[49], step_ms[51]
    log(f"  horizontal G step {g_ms:.3f} ms, D step {d_ms:.3f} ms at batch "
        f"{n} (its 49 and 51; 48 and 50 took {step_ms[48]:.3f} and "
        f"{step_ms[50]:.3f}); phase 6's 3D steps (trunk kernels) "
        f"{p6['g_ms']:.3f} / {p6['d_ms']:.3f} ms ({card})")
    lr, hr, z = batch()

    def g_step():
        state.it = 48
        gan.train_step(state, lr, hr, z)

    kernel_split("  horizontal G step, by kernel", g_step, card,
                 H_SPLIT_NAMES, warm_up=False)
    log(f"  horizontal: peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase 12 "
        f"took {time.monotonic() - t0:.1f} s")
    del gan, state
    torch.cuda.empty_cache()
    return dict(steps=steps, chunk=chunk, g_ms=g_ms, d_ms=d_ms)


# ------------------------------------------------ phase 13: the data mesh
# leg (a): run.py --train under torchrun, world size 1 (NCCL), resumes phase
# 7's one-process leg from its ckpt_6004 to 6008 and writes its checkpoint
MESH_STEP_TOL = 1e-6     # (b) world size 1 against no mesh, rel L2 per tree
MESH_GRAD_TOL = 1e-2     # (c) two ranks' summed G gradients, bf16, rel L2
# (c) their D gradients in float32 (TF32 off): bf16's are dominated by its
# rounding (PERF.md section 6: one process's bf16 D gradients lie far
# from its float32 ones), so D is held in float32 and bf16 is printed
MESH_D32_TOL = 1e-4
MESH_LOSS_TOL = 1e-3     # (c) their losses, relative
# (d) two ranks' served batch of 8 against one process's at batch 8, rel L2
# (bf16: cuDNN picks its conv algorithms by the batch, 1.6e-3 measured);
# against one process on the same rows it must be equal bit for bit
MESH_SERVE_TOL = 1e-2
MESH_RANKS = 2
# from phase 12 on, when the torchrun leg, phase 13's two ranks and phase
# 14's eight share the card with this process, this process takes at most
# this share of its memory (phase 12's chunk check holds over 50 GiB of
# 79, 33 of them in its CUDA graphs' pools: 0.7 ran out at 56.6), so that
# the torchrun leg, started at phase 12's start, finds room for its
# context; the others take the card in turn: the two ranks after phase
# 14's references, the eight once the leg has ended
MAIN_CARD_SHARE = 0.9


# (e) the model axis: the same two ranks as data 1 x model 2 (G's output
# channels over them), milestone9k as committed at a global batch of 16
# (bf16) and its float32 copy at 2, one D step (it 50) then one G step (it
# 49) from phase 5's seeded state, against this process on the same
# batches (model_reference, alone on the card at phase 13's start)
MODEL_AXES = (1, 2)
MODEL_BATCH = 16
MODEL_F32_BATCH = 2
MODEL_SEED = 2019        # the steps' generator, on both sides
MODEL_G_TOL = 1e-2       # bf16 G gradients, gathered whole, rel L2
MODEL_LOSS_TOL = 1e-3    # bf16 losses, relative
MODEL_F32_TOL = 1e-4     # float32 G and D gradients, rel L2
MODEL_PHYS_TOL = 1e-5    # float32 physics terms, relative
MODEL_SERVE_TOL = 1e-2   # 8 fields served on the mesh vs one process
STEP_LOSSES = ("total", "pix", "adversarial", "D_train_loss",
               "xy_gradient", "z_gradient", "divergence", "xy_divergence")


def model_batches(batches):
    """(e)'s batches, cut from (c)'s steps' batches: two of 16 rows for
    the bf16 steps, two of 2 for the float32 ones (each pair the D step's,
    then the G step's)."""
    return dict(a=[tuple(t[:MODEL_BATCH].cpu() for t in b)
                   for b in batches[1:3]],
                b=[tuple(t[:MODEL_F32_BATCH].cpu() for t in b)
                   for b in batches[3:5]])


def model_steps(gan, state, batches, dev, spy=None):
    """One D step (it 50) then one G step (it 49) from ``state``'s weights
    and MODEL_SEED's draws, each on the host clock with its launches, the
    model axis's collectives (``spy``) and its losses. → (state, the
    steps' figures)."""
    import torch

    state.rng.manual_seed(MODEL_SEED)
    out = []
    for it, b in zip(SPATIAL_ITS, batches):
        state.it = it
        b = tuple(t.to(dev) for t in b)
        if spy is not None:
            spy.calls.clear()
        reset_counters()
        torch.cuda.synchronize()
        t = time.monotonic()
        state, m = gan.train_step(state, *b)
        torch.cuda.synchronize()
        out.append(dict(it=state.it, g_step=bool(m["is_g_step"]),
                        ms=1e3 * (time.monotonic() - t),
                        launches=counters(),
                        collectives=None if spy is None else spy.summary(),
                        losses={k: float(m[k]) for k in STEP_LOSSES}))
    return state, out


def spy_grads_whole(gan):
    """Keep every Adam step's gradients on the card; the function returned
    gathers G's whole over a model axis (a collective: every rank calls
    it) and gives them flat in float32 on the host, in the parameters'
    order, as spy_grads keeps them. Gathering after the steps keeps the
    gather out of the timed steps."""
    import torch

    from gan_sr_wind_field_tpu_torch.parallel.model import gather_trees

    seen = []
    real = gan._adam_step

    def step(params, grads, *a, **kw):
        seen.append((list(params), [g.detach().clone() for g in grads],
                     kw.get("sharded", frozenset())))
        return real(params, grads, *a, **kw)

    def whole():
        out = []
        for keys, grads, sharded in seen:
            named = dict(zip(keys, grads))
            if sharded and gan._channels is not None:
                named = gather_trees([named], sharded, gan._channels)[0]
            out.append(torch.cat([g.float().flatten()
                                  for g in named.values()]).cpu())
        return out

    gan._adam_step = step
    return whole


def module_path(cfg):
    """``cfg`` on the path a model or spatial axis takes: the trunk and
    head kernels off (JAX's dp_only), the stencil kernels as configured."""
    import dataclasses

    return dataclasses.replace(cfg, use_fused_trunk=False)


def model_reference(dev, started, p5):
    """(e)'s one-process references, at phase 13's start, alone on the
    card: from phase 5's seeded state (the weights (c)'s ranks draw), on
    the path the model axis takes (module_path), the D step and the G step
    on (e)'s batches in bf16 at 16 rows and in float32 at 2 (gradients,
    losses, host-clock ms, launches)."""
    import dataclasses

    import torch

    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    cfg, coords = module_path(started["cfg"]), started["coords"]
    ref = {}
    for key, c in (("a", cfg),
                   ("b", dataclasses.replace(cfg, compute_dtype="float32"))):
        gan = WindFieldGAN(c, coords, coords, device=dev)
        gan.D = gan._build_D(started["shapes"][1])
        whole = spy_grads_whole(gan)
        st, ref[key] = model_steps(gan, copy_state(p5["before"], dev),
                                   started["model"][key], dev)
        ref[f"{key}_grads"] = whole()
        if key == "a":
            ref["names"] = [(k, v.numel()) for tree in (st.params_G,
                                                         st.params_D)
                            for k, v in tree.items()]
            ref["n_G"] = len(st.params_G)
        del gan, st
        torch.cuda.empty_cache()
    return ref


def model_checksum(state, mesh):
    """``tree_digests`` of the state gathered whole over the model axis
    (``gather_state``: G's parameters, EMA and Adam moments): equal on
    every rank when the replicated leaves stayed equal bit for bit and
    every model group holds the same G. A collective of the model
    group."""
    from gan_sr_wind_field_tpu_torch.parallel import gather_state

    return tree_digests(gather_state(state, mesh))


def model_setup(dev, src, state, params0):
    """(e)'s untimed set-up on mesh_rank's two processes, before their go:
    the data 1 x model 2 mesh, a trainer for each leg (bf16 as committed,
    its float32 copy) with its gradient spy, the seeded ``state`` (whole,
    on the card, before any step) placed on the mesh once, and the server
    of ``params0``. → what model_leg takes."""
    import dataclasses

    import torch.distributed as dist

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.parallel import make_mesh, shard_state
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    mesh = make_mesh(*MODEL_AXES, devices=dev)
    cfg = load_config(src["ini"])
    legs = {}
    for key, c in (("a", cfg),
                   ("b", dataclasses.replace(cfg, compute_dtype="float32"))):
        gan = WindFieldGAN(c, src["coords"], src["coords"], device=dev,
                           mesh=mesh)
        gan.D = gan._build_D(src["shapes"][1])
        legs[key] = (gan, spy_grads_whole(gan))
    # both legs start from the same weights: placed once, copied per leg
    return dict(mesh=mesh, legs=legs, spy=CollectiveSpy(dist, kind="model"),
                placed=shard_state(copy_state(state), mesh),
                sr=WindFieldSR(cfg, params0, device=dev, mesh=mesh))


def model_leg(dev, src, prep):
    """(e) on mesh_rank's two processes, after (d), on model_setup's
    ``prep``: data 1 x model 2, each rank holding its output channels of
    G's sharded leaves (its parameters, EMA and Adam moments): (e)'s steps
    on the whole batches from the seeded state, in bf16 and in float32,
    then 8 fields served. → (this rank's figures, G's and D's gradients
    with G's gathered whole, the served fields)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from gan_sr_wind_field_tpu_torch.parallel import model as model_mod

    mesh, spy = prep["mesh"], prep["spy"]
    model_mod.dist = spy
    res, grads = {"shape": mesh.shape, "model_rank": mesh.model_rank}, {}
    for key, (gan, whole) in prep["legs"].items():
        torch.cuda.reset_peak_memory_stats(dev)
        st, res[key] = model_steps(gan, copy_state(prep["placed"]),
                                   src["model"][key], dev, spy)
        res[f"{key}_peak"] = torch.cuda.max_memory_allocated(dev)
        grads[key] = whole()
        res[f"{key}_sum"] = model_checksum(st, mesh)
        del st
        torch.cuda.empty_cache()
    spy.calls.clear()
    reset_counters()
    torch.cuda.synchronize()
    t = time.monotonic()
    served = prep["sr"].upscale(*src["serve"])
    res["serve_ms"] = 1e3 * (time.monotonic() - t)
    res["serve_launches"] = counters()
    res["serve_collectives"] = spy.summary()
    res["serve_sum"] = hashlib.sha256(served.tobytes()).hexdigest()
    model_mod.dist = dist
    return res, grads, served


def grad_errs(got, want, names, n_g):
    """G's and D's relative L2 (the spied gradients come D step first)
    and their three worst tensors by name."""
    errs, worst = [], []
    for i, (g, w) in enumerate(zip(got[::-1], want[::-1])):
        errs.append(rel_l2(g, w))
        part = names[:n_g] if i == 0 else names[n_g:]
        each, at = [], 0
        for name, n in part:
            each.append((rel_l2(g[at:at + n], w[at:at + n])
                         if w[at:at + n].norm() > 0 else 0.0, name))
            at += n
        worst.append(sorted(each, reverse=True)[:3])
    return errs, worst


def check_model_steps(label, every, got_grads, ref, key, names, n_g, card,
                      f32):
    """Report and hold one leg of model-mesh steps (``every``: each rank's
    figures under ``key``) against one process (``ref``): per rank and
    step its ms, the model axis's collectives and launches; G's and D's
    gradients, the losses (bf16: G <= MODEL_G_TOL, losses <=
    MODEL_LOSS_TOL) or the physics terms (float32: G and D <=
    MODEL_F32_TOL, physics <= MODEL_PHYS_TOL); kernels 3 and 4 on every
    rank's G step and kernels 1, 2 and 5 on none; every rank's whole state
    equal. Returns each rank's launches summed over its steps."""
    for st in ref[key]:
        log(f"  {label}, one process on the same path: "
            f"{'G' if st['g_step'] else 'D'} step {st['ms']:.1f} ms host "
            f"clock, launches {LAUNCH_LABELS} {st['launches']} ({card})")
    for r, v in enumerate(every):
        for st in v[key]:
            c = st["collectives"]["model"]
            log(f"  {label} rank {r} (model index {r % MODEL_AXES[1]}) it "
                f"{st['it']} ({'G' if st['g_step'] else 'D'} step): "
                f"{st['ms']:.1f} ms host clock; {c[0]} model-axis "
                f"collectives (channel gathers, cotangent sums, the norm), "
                f"{c[1] / 1e6:.1f} MB, {c[2]:.1f} ms; launches "
                f"{LAUNCH_LABELS} {st['launches']} ({card})")
            if st["launches"][:2] != (0, 0) or st["launches"][4] != 0 or (
                    st["g_step"] and not (st["launches"][2] >= 2
                                          and st["launches"][3] >= 1)):
                fail(f"{label} rank {r} launched {st['launches']}: kernels "
                     "3 and 4 on the G step, kernels 1, 2 and 5 off")
    (g_err, d_err), worst = grad_errs(got_grads, ref[f"{key}_grads"],
                                      names, n_g)
    log(f"  {label}: the worst tensors, G: "
        + ", ".join(f"{n} {e:.2e}" for e, n in worst[0]) + "; D: "
        + ", ".join(f"{n} {e:.2e}" for e, n in worst[1]))
    lerr = max(abs(v - w) / max(abs(w), 1e-12)
               for st, wt in zip(every[0][key], ref[key])
               for k, w in wt["losses"].items()
               for v in [st["losses"][k]] if w != 0.0 or v != 0.0)
    apart = differing_trees([v[f"{key}_sum"] for v in every])
    log(f"  {label}: G gradients gathered whole vs one process rel L2 "
        f"{g_err:.3e}, D gradients {d_err:.3e}; losses' largest relative "
        f"difference {lerr:.3e}; G gathered (with its EMA and moments) and "
        f"the replicated leaves equal on every rank after the steps: "
        f"{not apart}")
    if apart:
        fail(f"{label}: the ranks' states differ in {apart}")
    if f32:
        perr = max(abs(st["losses"][k] - wt["losses"][k])
                   / max(abs(wt["losses"][k]), 1e-30)
                   for st, wt in zip(every[0][key], ref[key])
                   if st["g_step"] for k in PHYSICS_KEYS)
        log(f"  {label}: the four physics terms' largest relative difference"
            f" {perr:.3e} (tol {MODEL_PHYS_TOL:.0e}); gradients tol "
            f"{MODEL_F32_TOL:.0e}")
        if not (g_err <= MODEL_F32_TOL and d_err <= MODEL_F32_TOL
                and perr <= MODEL_PHYS_TOL):
            fail(f"{label}: the float32 model mesh disagrees with one "
                 "process")
    elif not (g_err <= MODEL_G_TOL and lerr <= MODEL_LOSS_TOL):
        fail(f"{label}: the model mesh disagrees with one process (tol "
             f"{MODEL_G_TOL:.0e} / {MODEL_LOSS_TOL:.0e})")
    return [tuple(map(sum, zip(*[st["launches"] for st in v[key]])))
            for v in every]


def model_report(card, out, model_ref, served1):
    """Phase 13 (e) from the two ranks' results ``out`` (mesh_out.pt)
    against this process's: the bf16 and float32 legs, and 8 fields served
    on the model mesh against one process at batch 8 (``served1``). →
    each rank's launches in (e)."""
    import numpy as np
    import torch

    every = [v["e"] for v in out["ranks"]]
    log(f"  (e) the same two processes as data {MODEL_AXES[0]} x model "
        f"{MODEL_AXES[1]} ({every[0]['shape']}), G's output channels over "
        f"the two, sharing one {card} over gloo; "
        f"{[round(v['e_s'], 1) for v in out['ranks']]} s a rank")
    names = model_ref["names"]
    launches = [(0,) * 5] * len(every)
    for key, label, f32 in (
            ("a", f"(e) bf16, batch {MODEL_BATCH}", False),
            ("b", f"(e) float32, batch {MODEL_F32_BATCH}", True)):
        leg = check_model_steps(label, every, out["e_grads"][key],
                                model_ref, key, names, model_ref["n_G"],
                                card, f32)
        launches = [tuple(a + b for a, b in zip(x, y))
                    for x, y in zip(launches, leg)]
        log(f"  {label}: peak "
            f"{[round(v[f'{key}_peak'] / 2**30, 2) for v in every]} GiB a "
            f"rank ({card})")
    err = rel_l2(torch.from_numpy(out["e_served"]),
                 torch.from_numpy(served1))
    same = len({v["serve_sum"] for v in every}) == 1
    c = every[0]["serve_collectives"]["model"]
    log(f"  (e) WindFieldSR(mesh=).upscale of 8 fields on data 1 x model 2: "
        f"rel L2 {err:.3e} against one process at batch 8 (tol "
        f"{MODEL_SERVE_TOL:.0e}), the whole batch on both ranks {same}, "
        f"{[round(v['serve_ms'], 1) for v in every]} ms host clock, "
        f"{c[0]} model-axis gathers {c[1] / 1e6:.1f} MB {c[2]:.1f} ms, "
        f"launches {[v['serve_launches'] for v in every]} ({card})")
    if not (err <= MODEL_SERVE_TOL and same and bool(
            np.isfinite(out["e_served"]).all())) or any(
            any(v["serve_launches"]) for v in every):
        fail("(e) serving on the model mesh disagrees")
    done("(e) the model axis")
    return [tuple(a + b for a, b in zip(x, v["serve_launches"]))
            for x, v in zip(launches, every)]


def mesh_leg_start(tmp):
    """Leg (a): ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 -m gan_sr_wind_field_tpu_torch.run --train`` on
    phase 7's copy of milestone9k and data, resuming its ckpt_6004 (a
    one-process checkpoint into a mesh) to 6008, in a process group of its
    own, at a lower scheduling priority. → (the process, its start)."""
    cfg, ini = leg_config(tmp, "mesh_leg", resume_training_from_save=True)
    cfg.env.state_load_path = os.path.join(cfg_run_folder(tmp, "leg"),
                                           f"ckpt_{LEG_MID}")
    cfg.save(ini)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *filter(None, [env.get("PYTHONPATH")])])
    out = open(os.path.join(tmp, "mesh_leg.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "gan_sr_wind_field_tpu_torch.run",
         "--cfg", ini, "--train", "--synthetic", *LEG_DATA, "--max_steps",
         str(LEG_TO)], cwd=REPO, env=env, stdout=out,
        stderr=subprocess.STDOUT, start_new_session=True)
    out.close()
    CHILDREN.append(proc)
    os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    return proc, time.monotonic()


def mesh_rank(rank, tmp):
    """One of leg (c)'s two processes on the card, over gloo: waits for
    the parent's go, then on its rows of the batch of 32 the G and D
    gradients summed over the group against the parent's one-process ones,
    steps 49 (G) and 50 (D) (each step's ms, the gradients' all_reduce ms,
    its launches; the leg's peak memory) and (d) WindFieldSR(mesh=).upscale
    of 8 fields; rank 0 writes what it gathered."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    # beside phase 12 the host's cores are shared: two threads each
    torch.set_num_threads(2)
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.parallel import make_mesh
    from gan_sr_wind_field_tpu_torch.train import gan as gan_mod
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # the card only once the parent says it has room (MAIN_CARD_SHARE)
    wait_for(os.path.join(tmp, "mesh_card"))
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo_store",
                            rank=rank, world_size=MESH_RANKS,
                            timeout=__import__("datetime").timedelta(
                                seconds=300))
    try:
        mesh = make_mesh(-1, devices=dev)
        src = torch.load(os.path.join(tmp, "mesh_in.pt"), weights_only=False)
        cfg = load_config(src["ini"])
        gan = WindFieldGAN(cfg, src["coords"], src["coords"], device=dev,
                           mesh=mesh)
        # the parent's state: the same seed, drawn the same way
        state = gan.init_state(TRAIN_SEED, *src["shapes"])
        rows = mesh.rows(src["batch"][0].shape[0])
        lr, hr, z = (t[rows].to(dev) for t in src["batch"])
        params0 = {k: v.clone() for k, v in state.params_G.items()}
        # (e) starts from the same state; its set-up is untimed
        prep = model_setup(dev, src, state, params0)
        wait_for(os.path.join(tmp, "mesh_go"))
        torch.cuda.reset_peak_memory_stats(dev)
        ar_ms = []

        def timed(real):
            def call(tensors, group):
                torch.cuda.synchronize()
                t = time.monotonic()
                real(tensors, group)
                torch.cuda.synchronize()
                ar_ms.append(1e3 * (time.monotonic() - t))
            return call

        gan_mod.all_reduce_flat = timed(gan_mod.all_reduce_flat)
        ref = torch.load(os.path.join(tmp, "mesh_ref.pt"), weights_only=True)
        res = {}
        state.it = 47
        gen = torch.Generator(device=dev).manual_seed(MESH_BATCHES)
        total, losses, grads = gan.g_grads(state, lr, hr, z, 48, gen)
        res["g_err"] = rel_l2(torch.cat([g.flatten() for g in grads]).cpu(),
                              ref["g_grads"])
        res["g_loss"] = {k: float(v) for k, v in losses.items()}
        del grads
        gen = torch.Generator(device=dev).manual_seed(MESH_BATCHES)
        d_loss, d_grads = d_step_grads(gan, state, lr, hr, z, gen)
        res["d_err"] = rel_l2(torch.cat([g.flatten() for g in d_grads]).cpu(),
                              ref["d_grads"])
        res["d_loss"] = d_loss
        gen = torch.Generator(device=dev).manual_seed(MESH_BATCHES)
        twin = float32_twin(gan, src["shapes"][1])
        _, d_grads = d_step_grads(twin, state, lr, hr, z, gen)
        res["d32_err"] = rel_l2(torch.cat([g.flatten() for g in d_grads])
                                .cpu(), ref["d_grads32"])
        del d_grads, twin
        # steps 49 (G) and 50 (D), each timed on its own once the torchrun
        # leg has left the card
        wait_for(os.path.join(tmp, "mesh_leg_done"))
        state.it, steps = 48, []
        for i in range(2):
            ar_ms.clear()
            reset_counters()
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = gan.train_step(state, *(a.to(dev) for a in (
                src["steps"][i][0][rows], src["steps"][i][1][rows],
                src["steps"][i][2][rows])))
            torch.cuda.synchronize()
            steps.append((state.it, bool(m["is_g_step"]),
                          1e3 * (time.monotonic() - t), sum(ar_ms),
                          counters(), float(m["total"]),
                          float(m["D_train_loss"])))
        res["steps"] = steps
        res["peak"] = torch.cuda.max_memory_allocated(dev)
        res["sum"] = state_checksum(state)
        sr = WindFieldSR(cfg, params0, device=dev, mesh=mesh)
        reset_counters()
        res["served"] = sr.upscale(src["serve"][0], src["serve"][1])
        res["serve_launches"] = counters()
        del gan, state, sr
        torch.cuda.empty_cache()
        # (e) the same two ranks on a model axis
        t = time.monotonic()
        res["e"], e_grads, e_served = model_leg(dev, src, prep)
        res["e_s"] = time.monotonic() - t
        every = [None] * MESH_RANKS
        dist.all_gather_object(every, {k: v for k, v in res.items()
                                       if k != "served"},
                               group=mesh.control)
        if rank == 0:
            torch.save(dict(ranks=every, served=res["served"],
                            e_grads=e_grads, e_served=e_served),
                       os.path.join(tmp, "mesh_out.pt"))
    finally:
        dist.destroy_process_group()


def wait_for(path, timeout=600):
    """Until the file ``path`` exists (a flag from the parent process)."""
    t = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t > timeout:
            raise TimeoutError(f"no {os.path.basename(path)} in {timeout} s")
        time.sleep(0.02)


def tree_digests(state):
    """(name, digest) of each tree of a state (its tensors' bytes and
    names), then of its it and its generator's state: two ranks' states
    are equal bit for bit where every pair is."""
    import hashlib

    import torch

    trees = [("params_G", state.params_G), ("params_D", state.params_D),
             ("batch_stats_D", state.batch_stats_D),
             ("params_G_ema", state.params_G_ema or {})]
    for name, opt in (("opt_state_G", state.opt_state_G),
                      ("opt_state_D", state.opt_state_D)):
        trees += [(f"{name}.mu", opt.mu), (f"{name}.nu", opt.nu),
                  (f"{name}.count", {"count": opt.count})]
    out = []
    for name, tree in trees:
        h = hashlib.sha256(" ".join(tree).encode())
        if tree:
            # a tree's bytes in one copy to the host (one wait on the card)
            h.update(torch.cat([v.detach().reshape(-1).view(torch.uint8)
                                for v in tree.values()]).cpu().numpy()
                     .tobytes())
        out.append((name, h.hexdigest()))
    out.append(("it", str(state.it)))
    out.append(("rng", hashlib.sha256(
        state.rng.get_state().numpy().tobytes()).hexdigest()))
    return tuple(out)


def state_checksum(state):
    """A digest of every tensor of a state, its it and its generator's
    state: equal digests on two ranks are equal states, bit for bit."""
    import hashlib

    return hashlib.sha256(repr(tree_digests(state)).encode()).hexdigest()


def differing_trees(sums):
    """The names of the trees whose digests (``tree_digests``) differ
    between the ranks' ``sums``."""
    return sorted({name for i, (name, d) in enumerate(sums[0])
                   if any(s[i][1] != d for s in sums[1:])})


def float32_twin(gan, hr_shape):
    """The same trainer in float32 (its own D module; the state's master
    weights are float32 already), for the D gradients of (c)."""
    import dataclasses

    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    cfg = dataclasses.replace(gan.cfg, compute_dtype="float32")
    twin = WindFieldGAN(cfg, gan.x.cpu().numpy(), gan.y.cpu().numpy(),
                        device=gan.device, mesh=gan.mesh)
    twin.D = twin._build_D(hr_shape)
    return twin


def d_step_grads(gan, state, lr, hr, z, gen):
    """One D step's loss (the batch's) and gradients (summed over a mesh)
    at it 50, without the update; the state's statistics untouched."""
    params = {k: v.detach().requires_grad_() for k, v in
              state.params_D.items()}
    stats = {k: v.clone() for k, v in state.batch_stats_D.items()}
    fake = gan._g_forward_nograd(state.params_G, lr, z)
    loss, _, _ = gan._d_loss(params, stats, hr[..., :3], fake, 50, gen,
                             True)
    grads = gan._grads(loss, params)
    return float(gan._reduce({"d": loss.detach()})["d"]), grads


MESH_BATCHES = 2013


def mesh_start(dev, card, tmp, resident):
    """The start of phase 13, at phase 12's: the card's compute mode; leg
    (a) under torchrun and leg (c)'s two processes, each at a lower
    scheduling priority, so that their start-up (imports, data, the pack,
    the seeded state on the host) takes the host's spare cycles beside
    phase 12, as phase 10's command lines do beside phases 7 to 9; (c)'s
    two take the card once the parent writes the flag mesh_card, and their
    go comes from mesh_phase. The batches (c) and (d) take, cut from
    phase 11's resident volumes, go to a file for them. → what mesh_phase
    needs."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(f"mesh: compute mode {mode} ({card})")
    if "Exclusive" in mode:
        fail(f"compute mode {mode}: two processes cannot share the card")
    leg, leg_t0 = mesh_leg_start(tmp)
    cfg = load_config(CFG)
    ini = os.path.join(tmp, "mesh.ini")
    cfg.save(ini)
    g = cfg.gan_config
    n, p, zl = cfg.dataset_train.batch_size, g.slice_size, g.number_of_z_layers
    coords = np.arange(p, dtype=np.float32) * 150.0
    shapes = ((n, p // cfg.scale, p // cfg.scale, zl, cfg.lr_num_channels),
              (n, p, p, zl, 3))
    kw = dict(resident.slice_kwargs(), batch_size=n)
    gen = torch.Generator(device=dev)
    # batch 0 for (c)'s gradients, 1-4 for steps 48-51, 5 for the val_step
    batches = [batch_at(resident.full, resident.zraw, MESH_BATCHES, i, gen,
                        **kw) for i in range(6)]
    serve_in = sample(np.random.default_rng(MESH_BATCHES), 8, p // cfg.scale,
                      p, zl, cfg.lr_num_channels)
    model = model_batches(batches)
    torch.save(dict(ini=ini, coords=coords, shapes=shapes,
                    batch=tuple(t.cpu() for t in batches[0]),
                    steps=[tuple(t.cpu() for t in b) for b in batches[1:5]],
                    serve=serve_in, model=model),
               os.path.join(tmp, "mesh_in.pt"))
    ctx = mp.start_processes(mesh_rank, args=(tmp,), nprocs=MESH_RANKS,
                             start_method="spawn", join=False)
    CHILDREN.extend(ctx.processes)
    for proc in ctx.processes:
        os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    return dict(leg=leg, leg_t0=leg_t0, ctx=ctx, cfg=cfg, coords=coords,
                shapes=shapes, batches=batches, serve_in=serve_in,
                model=model)


def mesh_phase(dev, card, tmp, started, p5, model_ref, settle=None):
    """Phase 13: the data mesh (parallel/), from ``mesh_start``. (b) phase
    5's steps 48-51 and val_step again on an NCCL mesh of one, from its
    state and on its batches (``p5``), against phase 5's result; (c) the
    two processes sharing the card over gloo against this one at batch 32;
    (d) serving on those two; (a) the entry point under torchrun at world
    size 1 (NCCL), resuming phase 7's checkpoint, against phase 7; (e) the
    two as data 1 x model 2 against this process (``model_ref``,
    model_reference's, made alone on the card at phase 13's start).
    ``settle`` (phase 14's wait for its eight processes' start-up) runs
    once the torchrun leg has ended, before the two ranks' timed steps get
    their go, so that nothing else works on the card beside them. Returns
    the mesh path's launches in this process and the two ranks'
    figures."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
    )
    from gan_sr_wind_field_tpu_torch.train import checkpoint as ckpt
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    t0 = time.monotonic()
    leg, leg_t0, ctx = started["leg"], started["leg_t0"], started["ctx"]
    cfg, coords, batches = (started[k] for k in ("cfg", "coords", "batches"))
    serve_in, seed = started["serve_in"], MESH_BATCHES
    n = cfg.dataset_train.batch_size
    hr_shape = started["shapes"][1]

    # (b) phase 5's steps on an NCCL mesh of one: phase 5's state is
    # init_state(TRAIN_SEED), the state (c)'s ranks seed too
    init_distributed(dev, init_method=f"file://{tmp}/nccl_store", rank=0,
                     world_size=1, timeout_s=300)
    mesh = make_mesh(-1, devices=dev)
    log(f"  (b) {dist.get_backend(mesh.group)} mesh {mesh.shape}, "
        f"{type(mesh.device_mesh).__name__} {mesh.device_mesh}")
    gan_m = WindFieldGAN(cfg, coords, coords, device=dev, mesh=mesh)
    gan_m.D = gan_m._build_D(hr_shape)
    recorded = iter(p5["batches"])
    sm = copy_state(p5["before"], dev)
    on_mesh = drive_steps(gan_m, sm,
                          lambda: [t.to(dev) for t in next(recorded)],
                          G_STEP_LAUNCHES, D_STEP_LAUNCHES, card,
                          "(b) NCCL mesh of 1, phase 5's steps")
    diffs = tree_diffs(sm, copy_state(p5["after"], dev))
    for name, (mx, rel, bits) in diffs.items():
        log(f"  (b) mesh of 1 vs phase 5 (no mesh) {name:<18} max abs "
            f"{mx:.3e}, rel L2 {rel:.3e}, bit for bit {bits}")
    if on_mesh != p5["launches"]:
        fail(f"(b) the mesh launched {on_mesh}, phase 5 {p5['launches']}")
    if not all(diffs[t][1] <= MESH_STEP_TOL for t in
               ("params_G", "params_G_ema", "params_D", "batch_stats_D")):
        fail(f"(b) the mesh of 1 is off by more than {MESH_STEP_TOL:.0e}")
    del sm, gan_m
    dist.destroy_process_group()
    done("(b)")

    gan1 = WindFieldGAN(cfg, coords, coords, device=dev)
    gan1.D = gan1._build_D(hr_shape)
    s0 = copy_state(p5["before"], dev)
    s0.it = 47
    # the one-process references of (c) and (d), from the same state
    st = copy_state(s0)
    lr, hr, z = batches[0]
    gen1 = torch.Generator(device=dev).manual_seed(seed)
    total1, losses1, grads1 = gan1.g_grads(st, lr, hr, z, 48, gen1)
    gen1 = torch.Generator(device=dev).manual_seed(seed)
    d_loss1, d_grads1 = d_step_grads(gan1, st, lr, hr, z, gen1)
    gen1 = torch.Generator(device=dev).manual_seed(seed)
    _, d_grads32 = d_step_grads(float32_twin(gan1, started["shapes"][1]),
                                st, lr, hr, z, gen1)
    ref = dict(g_grads=torch.cat([x.flatten() for x in grads1]).cpu(),
               d_grads=torch.cat([x.flatten() for x in d_grads1]).cpu(),
               d_grads32=torch.cat([x.flatten() for x in d_grads32]).cpu())
    torch.save(ref, os.path.join(tmp, "mesh_ref.pt"))
    bf16_scale = rel_l2(ref["d_grads"], ref["d_grads32"])
    losses1 = {k: float(v) for k, v in losses1.items()}
    del grads1, d_grads1, d_grads32, st, ref
    sr1 = WindFieldSR(cfg, s0.params_G, device=dev)
    served1 = sr1.upscale(*serve_in)
    # the same rows as the two ranks take
    halves = np.concatenate([sr1.upscale(serve_in[0][h], serve_in[1][h])
                             for h in (slice(0, 4), slice(4, 8))])
    del sr1
    done("the references of (c) and (d)")

    # (c) and (d) go once this process has released its cache: their
    # gradients beside the leg's last steps, their timed steps after it
    del gan1
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    t_go = time.monotonic()
    open(os.path.join(tmp, "mesh_go"), "w").close()

    # (a): the leg's checks, its checkpoint against phase 7's; the ranks'
    # timed steps go after it
    t = time.monotonic()
    rc = leg.wait(timeout=600)
    waited = time.monotonic() - t
    leg_s = time.monotonic() - leg_t0
    with open(os.path.join(tmp, "mesh_leg.log")) as f:
        out = f.read()
    if rc != 0:
        fail(f"(a) torchrun exited {rc}:\n{out[-4000:]}")
    folder = cfg_run_folder(tmp, "mesh_leg")
    kept = sorted(d for d in os.listdir(folder) if d.startswith("ckpt_"))
    with open(os.path.join(tmp, "mesh_leg", "log", "status.log")) as f:
        status = f.read()
    axis = re.search(r"data axis of 1 ranks \((\w+)\)", status)
    logged = re.findall(r"it (\d+) G_total (\S+) D (\S+)", status)
    log(f"  (a) its start-up from the run folder to the first step "
        f"{log_seconds(out, 'run folder:', 'beginning run at'):.3f} s, "
        f"the steps and the save "
        f"{log_seconds(out, 'beginning run at', f'ckpt_{LEG_TO}'):.3f} s "
        f"(status lines' clock)")
    log(f"  (a) torchrun --nproc_per_node=1 run.py --train from phase 7's "
        f"ckpt_{LEG_MID} to {LEG_TO}: exit {rc} {leg_s:.1f} s after "
        f"its start at phase 12's (this phase waited {waited:.1f} s), "
        f"backend {axis and axis.group(1)}, logged {logged}, kept {kept}")
    if (axis is None or axis.group(1) != "nccl" or kept != [f"ckpt_{LEG_TO}"]
            or f"at it={LEG_MID}" not in status
            or [int(r[0]) for r in logged] != [LEG_TO]
            or not all(math.isfinite(float(v)) for r in logged
                       for v in r[1:])):
        fail("(a) the leg under torchrun did not resume and train as asked")
    mesh_ckpt = ckpt.restore_checkpoint(os.path.join(folder,
                                                     f"ckpt_{LEG_TO}"), s0)
    one = ckpt.restore_checkpoint(os.path.join(cfg_run_folder(tmp, "leg"),
                                               f"ckpt_{LEG_TO}"), s0)
    diffs = tree_diffs(mesh_ckpt, one)
    exact = all(v[2] for v in diffs.values()) and torch.equal(
        mesh_ckpt.rng.get_state(), one.rng.get_state())
    for tname, (mx, rel, bits) in diffs.items():
        log(f"  (a) the torchrun leg's ckpt_{LEG_TO} vs phase 7's "
            f"{tname:<18} max abs {mx:.3e}, rel L2 {rel:.3e}, bit-exact "
            f"{bits}")
    log(f"  (a) resumed on an NCCL mesh of one from phase 7's one-process "
        f"ckpt_{LEG_MID}, against phase 7's uninterrupted leg: it "
        f"{mesh_ckpt.it}, bit-exact {exact}")
    if mesh_ckpt.it != LEG_TO or (not exact and not all(
            v[1] <= RESUME_TOL for v in diffs.values())):
        fail(f"(a) the resume is off by more than {RESUME_TOL:.0e}")
    del mesh_ckpt, one
    if settle is not None:
        settle()
    open(os.path.join(tmp, "mesh_leg_done"), "w").close()
    done("(a) the leg")

    # join returns when any one ends: wait for both
    while not ctx.join(max(1.0, 600 - (time.monotonic() - t_go))):
        if time.monotonic() - t_go > 600:
            fail("(c) the two ranks did not end within 600 s")
    ranks_s = time.monotonic() - t_go
    res = torch.load(os.path.join(tmp, "mesh_out.pt"), weights_only=False)
    every = res["ranks"]
    log(f"  (c) two processes sharing one {card} over gloo (not a "
        f"multi-card figure), batch {n // MESH_RANKS} each, {free / 2**30:.1f}"
        f" GiB free at their go, {ranks_s:.1f} s from it to their end")
    for r, v in enumerate(every):
        log(f"  (c) rank {r}: summed over the two vs one process at batch "
            f"{n}: G gradients (bf16) rel L2 {v['g_err']:.3e} (tol "
            f"{MESH_GRAD_TOL:.0e}); D gradients in float32 "
            f"{v['d32_err']:.3e} (tol {MESH_D32_TOL:.0e}), in bf16 "
            f"{v['d_err']:.3e} (one process's bf16 D gradients from its "
            f"float32 ones: {bf16_scale:.3e}); peak {v['peak'] / 2**30:.2f} "
            f"GiB")
        for it, g_step, ms, ar, launches, tot, dl in v["steps"]:
            log(f"  (c) rank {r} it {it} ({'G' if g_step else 'D'} step): "
                f"{ms:.1f} ms host clock, of it the gradients' all_reduce "
                f"{ar:.1f} ms; launches {LAUNCH_LABELS} {launches}; G_total "
                f"{tot:.5e} D {dl:.5e} (two ranks time-sharing one H100)")
        if not (v["g_err"] <= MESH_GRAD_TOL and v["d32_err"] <= MESH_D32_TOL):
            fail(f"(c) rank {r}'s summed gradients disagree")
        for it, g_step, _, _, launches, _, _ in v["steps"]:
            if launches != (G_STEP_LAUNCHES if g_step else D_STEP_LAUNCHES):
                fail(f"(c) rank {r} launched {launches} at it {it}")
    lerr = max([abs(every[0]["g_loss"][k] - v) / max(abs(v), 1e-12)
                for k, v in losses1.items()]
               + [abs(every[0]["d_loss"] - d_loss1) / abs(d_loss1)])
    same = len({v["sum"] for v in every}) == 1
    log(f"  (c) losses vs one process: largest relative difference "
        f"{lerr:.3e} (tol {MESH_LOSS_TOL:.0e}); G total {total1:.6e} one "
        f"process, {every[0]['g_loss']['total']:.6e} on the mesh; state "
        f"checksums after steps 49 and 50 equal on both ranks: {same}")
    if not (lerr <= MESH_LOSS_TOL and same):
        fail("(c) the two ranks disagree with one process or each other")
    served = torch.from_numpy(res["served"])
    err = rel_l2(served, torch.from_numpy(served1))
    bits = bool(np.array_equal(res["served"], served1))
    same_rows = bool(np.array_equal(res["served"], halves))
    log(f"  (d) WindFieldSR(mesh=).upscale of 8 fields on 2 ranks vs one "
        f"process at batch 8: rel L2 {err:.3e} (tol {MESH_SERVE_TOL:.0e}), "
        f"bit for bit {bits}; vs one process on each rank's 4 rows: bit for "
        f"bit {same_rows}; launches per rank "
        f"{[v['serve_launches'] for v in every]}")
    if not (err <= MESH_SERVE_TOL and same_rows) or any(
            v["serve_launches"][0] != 1 for v in every):
        fail("(d) serving on two ranks disagrees or skipped the trunk kernel")
    done("(c, d)")
    model_launches = model_report(card, res, model_ref, served1)

    secs = time.monotonic() - t0
    log(f"  phase 13 took {secs:.1f} s")
    g_ms = [[s[2] for s in v["steps"] if s[1]][-1] for v in every]
    d_ms = [[s[2] for s in v["steps"] if not s[1]][-1] for v in every]
    return dict(launches=on_mesh, model_launches=model_launches,
                model_s=[v["e_s"] for v in every],
                rank_launches=[tuple(map(sum, zip(*[s[4] for s in v["steps"]])))
                               for v in every],
                g_ms=g_ms, d_ms=d_ms,
                ar_ms=[[s[3] for s in v["steps"]] for v in every],
                peak=[v["peak"] for v in every], g_err=every[0]["g_err"],
                d_err=every[0]["d_err"], d32_err=every[0]["d32_err"],
                serve_err=err, seconds=secs)



# ----------------------------------------- phase 14: the spatial axis
# configs/fullvol.ini at full width on its own mesh of data 2 x spatial 4:
# eight processes sharing the card over gloo against one process on it
SPATIAL_AXES = (2, 4)
SPATIAL_SEED = 2014
SPATIAL_CFG = os.path.join(REPO, "configs", "fullvol.ini")
SPATIAL_G_TOL = 1e-2      # (a) bf16 G gradients summed over 8 ranks, rel L2
SPATIAL_LOSS_TOL = 1e-3   # (a) the losses, relative
SPATIAL_F32_TOL = 1e-4    # (b) float32 G and D gradients, rel L2
SPATIAL_PHYS_TOL = 1e-5   # (b) the four physics terms, relative
SPATIAL_STENCIL_TOL = 1e-5  # (b) kernels 3 and 4 on a haloed slab vs plain
SPATIAL_SERVE_TOL = 1e-2  # (c) the served batch of 8, rel L2
# (b)'s global batch: one row per data rank keeps float32's activations small
SPATIAL_F32_BATCH = 2
# each leg's two steps, by the state's it before them: the D step (it 50)
# first, so that both start from the seeded weights (a G step first would
# move G by Adam's first steps, where a rounding difference in a near-zero
# gradient moves an entry by ±lr either way, and the D step's fake with it)
SPATIAL_ITS = (49, 48)
PHYSICS_KEYS = ("xy_gradient", "z_gradient", "divergence", "xy_divergence")
# (d): the same eight ranks on all three axes, data 2 x model 2 x spatial
# 2 (the geometry of the JAX package's tests/test_flagship_mesh.py), (b)'s
# float32 steps with kernels 3 and 4, held to (b)'s one-process references
# at (b)'s tolerances
THREE_AXES = (2, 2, 2)


class CollectiveSpy:
    """Stands for ``torch.distributed`` in ``parallel/halo.py`` (or, with
    ``kind``, in ``parallel/model.py``): each all_reduce synchronised on
    both sides and recorded as (what, bytes, ms), 'halo' for the
    exchange's (s, 2, ...) buffers and 'gather' for gather_x's, or
    ``kind`` for every one."""

    def __init__(self, real, kind=None):
        self.real = real
        self.kind = kind
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.real, name)

    def all_reduce(self, t, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.monotonic()
        self.real.all_reduce(t, **kw)
        torch.cuda.synchronize()
        self.calls.append((self.kind or ("halo" if t.dim() == 7
                                         else "gather"),
                           t.numel() * t.element_size(),
                           1e3 * (time.monotonic() - t0)))

    def summary(self):
        out = {}
        for what in ((self.kind,) if self.kind else ("halo", "gather")):
            c = [x for x in self.calls if x[0] == what]
            out[what] = (len(c), sum(x[1] for x in c), sum(x[2] for x in c))
        return out


def spy_grads(gan):
    """Record every Adam step's gradients, flat in float32 on the host, in
    the list returned (G's on a G step, D's on a D step; on a mesh summed
    over it)."""
    import torch

    seen = []
    real = gan._adam_step

    def step(params, grads, *a, **kw):
        seen.append(torch.cat([g.detach().float().flatten()
                               for g in grads]).cpu())
        return real(params, grads, *a, **kw)

    gan._adam_step = step
    return seen


def spatial_configs(tmp):
    """configs/fullvol.ini as committed, and its float32 copy with
    use_pallas_stencil (kernels 3 and 4), written in ``tmp`` → (cfg, cfg32,
    their paths)."""
    from gan_sr_wind_field_tpu_torch.config import load_config

    cfg = load_config(SPATIAL_CFG)
    cfg32 = copy.deepcopy(cfg)
    cfg32.compute_dtype = "float32"
    cfg32.use_pallas_stencil = True
    paths = (os.path.join(tmp, "spatial.ini"),
             os.path.join(tmp, "spatial32.ini"))
    cfg.save(paths[0])
    cfg32.save(paths[1])
    return cfg, cfg32, paths


def spatial_shapes(cfg, n):
    g = cfg.gan_config
    X = 128  # whole volumes, no patch slicing
    return ((n, X // cfg.scale, X // cfg.scale, g.number_of_z_layers,
             cfg.lr_num_channels), (n, X, X, g.number_of_z_layers, 3))


def spatial_rank(rank, tmp):
    """One of phase 14's eight processes on the card, over gloo: rank r is
    data row r // 4 at x slab r % 4. Waits for the parent's go, then (a)
    the committed bf16 config's D step (it 50) and G step (it 49, from the
    same weights) on its rows and slab of the batch of 8, (b) the float32 copy's with kernels 3
    and 4 at a batch of 2 (and the kernels on its haloed slab against
    their plain versions), (c)
    WindFieldSR(mesh=).upscale of 8 volumes. Rank 0 writes what it
    gathered."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.ops.physics import wind_field_gradient
    from gan_sr_wind_field_tpu_torch.ops.stencil import (
        wind_gradient,
        wind_gradient_adjoint,
        wind_gradient_adjoint_reference,
    )
    from gan_sr_wind_field_tpu_torch.parallel import halo as halo_mod
    from gan_sr_wind_field_tpu_torch.parallel import make_mesh, shard_state
    from gan_sr_wind_field_tpu_torch.parallel import model as model_mod
    from gan_sr_wind_field_tpu_torch.train import gan as gan_mod
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # the card only once the parent says it has room (MAIN_CARD_SHARE)
    wait_for(os.path.join(tmp, "mesh_card"))
    t_start = time.monotonic()
    torch.cuda.set_device(dev)
    d, s = SPATIAL_AXES
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/spatial_store", rank=rank,
        world_size=d * s,
        timeout=__import__("datetime").timedelta(seconds=300))
    try:
        mesh = make_mesh(d, 1, s, devices=dev)
        slab = mesh.slab()
        src = torch.load(os.path.join(tmp, "spatial_in.pt"),
                         weights_only=False)
        spy = CollectiveSpy(dist)
        halo_mod.dist = spy
        ar_ms = []
        real_ar = gan_mod.all_reduce_flat

        def timed_ar(tensors, group):
            torch.cuda.synchronize()
            t = time.monotonic()
            real_ar(tensors, group)
            torch.cuda.synchronize()
            ar_ms.append(1e3 * (time.monotonic() - t))

        gan_mod.all_reduce_flat = timed_ar
        cfg, cfg32 = (load_config(p) for p in src["ini"])
        gan = WindFieldGAN(cfg, src["coords"], src["coords"], device=dev,
                           mesh=mesh)
        state = gan.init_state(SPATIAL_SEED, *src["shapes"])
        grads = spy_grads(gan)

        mspy = CollectiveSpy(dist, kind="model")
        model_mod.dist = mspy

        def steps_of(g, st, batches, n, on=mesh):
            rows = on.rows(n)
            out = []
            for it, b in zip(SPATIAL_ITS, batches):
                st.it = it
                b = tuple(t[rows].to(dev) for t in b)
                spy.calls.clear()
                mspy.calls.clear()
                ar_ms.clear()
                reset_counters()
                torch.cuda.synchronize()
                t = time.monotonic()
                st, m = g.train_step(st, *b)
                torch.cuda.synchronize()
                out.append(dict(
                    it=st.it, g_step=bool(m["is_g_step"]),
                    ms=1e3 * (time.monotonic() - t),
                    collectives={**spy.summary(), **mspy.summary()},
                    ar_ms=sum(ar_ms),
                    launches=counters(),
                    losses={k: float(m[k]) for k in (
                        "total", "pix", "adversarial", "D_train_loss",
                        *PHYSICS_KEYS)}))
            return st, out

        # (b)'s trainer and (c)'s server are built before the go too
        gan32 = WindFieldGAN(cfg32, src["coords"], src["coords"],
                             device=dev, mesh=mesh)
        # the same seed draws the same float32 weights in either compute
        # dtype: a copy of (a)'s state spares the host a second draw
        gan32.D = gan32._build_D(src["shapes32"][1])
        st32 = copy_state(state)
        # (d) on all three axes starts from the same state; its mesh,
        # trainer and placed state are built before the go too
        m3 = make_mesh(*THREE_AXES, devices=dev)
        gan3 = WindFieldGAN(cfg32, src["coords"], src["coords"], device=dev,
                            mesh=m3)
        gan3.D = gan3._build_D(src["shapes32"][1])
        whole3 = spy_grads_whole(gan3)
        st3 = shard_state(copy_state(st32), m3)
        grads32 = spy_grads(gan32)
        sr = WindFieldSR(cfg, state.params_G, device=dev, mesh=mesh)
        res = dict(rank=rank, start_s=time.monotonic() - t_start)
        torch.cuda.synchronize()
        open(os.path.join(tmp, f"spatial_ready_{rank}"), "w").close()
        wait_for(os.path.join(tmp, "spatial_go"))
        t_go = time.monotonic()
        torch.cuda.reset_peak_memory_stats(dev)
        # (a) the committed bf16 config
        state, res["a"] = steps_of(gan, state, src["a"], 8)
        res["a_sum"] = state_checksum(state)
        res["a_peak"] = torch.cuda.max_memory_allocated(dev)
        a_grads = grads[:]
        del gan, state, grads
        torch.cuda.empty_cache()
        # (b) the float32 copy with kernels 3 and 4, batch 2
        st32, res["b"] = steps_of(gan32, st32, src["b"], SPATIAL_F32_BATCH)
        res["b_sum"] = state_checksum(st32)
        # kernels 3 and 4 on this rank's haloed slab (the exchange is a
        # collective of the row: every rank takes part) against their
        # plain versions, outside the counted steps
        from gan_sr_wind_field_tpu_torch.parallel.halo import x_window

        _, hr, z = (t[mesh.rows(SPATIAL_F32_BATCH)].to(dev)
                    for t in src["b"][0])
        wide, lo = x_window(slab.cut(hr), slab)
        zw = x_window(slab.cut(z), slab)[0]
        a = slab.index * slab.cut(hr).shape[1] - lo
        xs = gan32.x[a:a + wide.shape[1]]
        got = wind_gradient(wide, xs, gan32.y, zw)
        want = wind_field_gradient(wide, xs, gan32.y, zw)
        g9 = torch.randn(got.shape, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(rank))
        adj = wind_gradient_adjoint(g9, xs, gan32.y, zw)
        adj_want = wind_gradient_adjoint_reference(g9, xs, gan32.y, zw)
        res["stencil"] = (tuple(wide.shape), rel_l2(got, want),
                          rel_l2(adj, adj_want))
        del gan32, st32
        torch.cuda.empty_cache()
        # (c) serving 8 volumes over the eight ranks
        reset_counters()
        torch.cuda.synchronize()
        t = time.monotonic()
        served = sr.upscale(*src["serve"])
        res["c_ms"] = 1e3 * (time.monotonic() - t)
        res["c_launches"] = counters()
        res["c_sum"] = __import__("hashlib").sha256(
            served.tobytes()).hexdigest()
        res["c_s"] = time.monotonic() - t
        del sr
        torch.cuda.empty_cache()
        # (d) all three axes on the same ranks: (b)'s steps from (b)'s
        # seeded state, G's output channels over each model pair
        t = time.monotonic()
        st3, res["d"] = steps_of(gan3, st3, src["b"], SPATIAL_F32_BATCH,
                                 on=m3)
        d_grads = whole3()
        res["d_sum"] = model_checksum(st3, m3)
        res["d_place"] = (m3.rank, m3.model_rank, m3.spatial_rank)
        res["d_s"] = time.monotonic() - t
        del gan3, st3
        res["peak"] = torch.cuda.max_memory_allocated(dev)
        res["go_s"] = time.monotonic() - t_go
        every = [None] * mesh.world
        dist.all_gather_object(every, res, group=mesh.control)
        if rank == 0:
            t = time.monotonic()
            out = os.path.join(tmp, "spatial_out.pt")
            torch.save(dict(ranks=every, served=served, a_grads=a_grads,
                            b_grads=grads32, d_grads=d_grads),
                       out + ".part")
            os.replace(out + ".part", out)  # the parent reads it whole
            log(f"  phase 14's rank 0 wrote its results in "
                f"{time.monotonic() - t:.1f} s")
    finally:
        dist.destroy_process_group()


def three_axes_report(card, every, out, ref):
    """Phase 14 (d) from the eight ranks' results: per rank and step its
    ms, halo exchanges, model-axis collectives and launches; G's
    (gathered) and D's gradients against (b)'s one-process references (<=
    SPATIAL_F32_TOL), the physics terms (<= SPATIAL_PHYS_TOL); each rank
    at JAX's place, kernels 3 and 4 on every rank's G step, kernels 1, 2
    and 5 on none, every rank's whole state equal. → each rank's launches
    in (d)."""
    d, m, s = THREE_AXES
    for r, v in enumerate(every):
        if v["d_place"] != (r // (m * s), r // s % m, r % s):
            fail(f"(d) rank {r} sits at {v['d_place']}: not JAX's row-major "
                 "place")
        for st in v["d"]:
            c = st["collectives"]
            log(f"  (d) data {d} x model {m} x spatial {s}, float32 + "
                f"kernels 3, 4, batch {SPATIAL_F32_BATCH}, rank {r} (row "
                f"{r // (m * s)}, model {r // s % m}, slab {r % s}) it "
                f"{st['it']} ({'G' if st['g_step'] else 'D'} step): "
                f"{st['ms']:.1f} ms host clock; {c['halo'][0]} halo "
                f"exchanges {c['halo'][1] / 1e6:.1f} MB {c['halo'][2]:.1f} "
                f"ms; {c['model'][0]} model-axis collectives "
                f"{c['model'][1] / 1e6:.1f} MB {c['model'][2]:.1f} ms; "
                f"{c['gather'][0]} x gathers; the gradients' all_reduce "
                f"{st['ar_ms']:.1f} ms; launches {LAUNCH_LABELS} "
                f"{st['launches']} ({card})")
            if st["launches"][:2] != (0, 0) or st["launches"][4] != 0 or (
                    st["g_step"] and not (st["launches"][2] >= 2
                                          and st["launches"][3] >= 1)):
                fail(f"(d) rank {r} launched {st['launches']}: kernels 3 "
                     "and 4 on its haloed slab, kernels 1, 2 and 5 off")
    (g_err, d_err), worst = grad_errs(out["d_grads"], ref["b_grads"],
                                      ref["names"], ref["n_G"])
    log("  (d): the worst tensors, G: "
        + ", ".join(f"{n} {e:.2e}" for e, n in worst[0]) + "; D: "
        + ", ".join(f"{n} {e:.2e}" for e, n in worst[1]))
    perr = max(abs(st["losses"][k] - wt["losses"][k])
               / max(abs(wt["losses"][k]), 1e-30)
               for st, wt in zip(every[0]["d"], ref["b"])
               if st["g_step"] for k in PHYSICS_KEYS)
    apart = differing_trees([v["d_sum"] for v in every])
    same = not apart
    log(f"  (d) summed over the eight vs one process: G gradients (gathered "
        f"whole) rel L2 {g_err:.3e}, D gradients {d_err:.3e} (tol "
        f"{SPATIAL_F32_TOL:.0e}); the four physics terms' largest relative "
        f"difference {perr:.3e} (tol {SPATIAL_PHYS_TOL:.0e}); G gathered "
        f"(with its EMA and moments) and the replicated leaves equal on "
        f"every rank after the steps: {same}"
        + (f" (not {apart})" if apart else "") + "; "
        f"{[round(v['d_s'], 1) for v in every]} s a rank ({card})")
    if not (g_err <= SPATIAL_F32_TOL and d_err <= SPATIAL_F32_TOL
            and perr <= SPATIAL_PHYS_TOL and same):
        fail("(d) all three axes disagree with one process")
    return [tuple(map(sum, zip(*[st["launches"] for st in v["d"]])))
            for v in every]


def spatial_inputs(dev, tmp, resident):
    """Phase 14's inputs, at phase 12's start: the configs, the batches
    (cut from phase 11's resident volumes: whole 128x128x10 volumes, LR by
    the strided decimation) and the serving input, in a file for the eight
    processes. → what spatial_reference, spatial_launch and spatial_phase
    need."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.data.device_data import batch_at

    cfg, cfg32, inis = spatial_configs(tmp)
    if resident.full.shape[-1] != cfg.lr_num_channels:
        fail(f"resident volumes carry {resident.full.shape[-1]} channels, "
             f"fullvol's LR {cfg.lr_num_channels}")
    X = resident.full.shape[1]
    coords = np.arange(X, dtype=np.float32) * 150.0
    gen = torch.Generator(device=dev)

    def batch(n, i):
        return tuple(t.cpu() for t in batch_at(
            resident.full, resident.zraw, SPATIAL_SEED, i, gen, batch_size=n,
            patch=X, patch_y=X, cf=cfg.scale, enable_slicing=False))

    src = dict(ini=inis, coords=coords,
               shapes=spatial_shapes(cfg, 8),
               shapes32=spatial_shapes(cfg32, SPATIAL_F32_BATCH),
               a=[batch(8, i) for i in range(2)],
               b=[batch(SPATIAL_F32_BATCH, 2 + i) for i in range(2)],
               serve=sample(np.random.default_rng(SPATIAL_SEED), 8,
                            X // cfg.scale, X,
                            cfg.gan_config.number_of_z_layers,
                            cfg.lr_num_channels))
    torch.save(src, os.path.join(tmp, "spatial_in.pt"))
    return dict(src=src, cfg=cfg, cfg32=cfg32, tmp=tmp)


def spatial_launch(started):
    """Start phase 14's eight processes at phase 12's start, at a lower
    scheduling priority, so that their imports take the host's spare
    cycles beside phase 12. Each takes the card only once the parent
    writes the flag mesh_card (after phase 14's references, at phase 13's
    start), builds its models there beside phase 13's untimed work, says
    when it is ready and waits for its go from spatial_phase. → the
    processes' context, in ``started``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(spatial_rank, args=(started["tmp"],),
                             nprocs=SPATIAL_AXES[0] * SPATIAL_AXES[1],
                             start_method="spawn", join=False)
    CHILDREN.extend(ctx.processes)
    for proc in ctx.processes:
        os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    started["ctx"] = ctx
    started["t_launch"] = time.monotonic()


def spatial_ready(started):
    """Until phase 14's eight processes have started up (their models on
    the card, waiting for their go): phase 13 calls it before its two
    ranks' timed steps, so that no start-up works on the card beside
    them. Fails if a process ended."""
    tmp, ctx = started["tmp"], started["ctx"]
    t = time.monotonic()
    while not all(os.path.exists(os.path.join(tmp, f"spatial_ready_{r}"))
                  for r in range(len(ctx.processes))):
        codes = [proc.exitcode for proc in ctx.processes]
        if any(c is not None for c in codes):
            fail(f"phase 14's ranks ended {codes} during their start-up")
        if time.monotonic() - t > 600:
            fail("phase 14's eight ranks did not start up within 600 s")
        time.sleep(0.05)
    started.setdefault("t_ready", time.monotonic())


def spatial_reference(dev, started):
    """Phase 14's one-process references on the card, at phase 13's start,
    before any process of phases 13 and 14 works on the card (the
    torchrun leg is still starting up on the host): the same steps from
    the same seeded
    state on the whole batches (G and D gradients, losses, host-clock ms,
    launches) and the served batch of 8."""
    import torch

    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.train.gan import WindFieldGAN

    src = started["src"]
    ref = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for key, cfg, shapes in (("a", started["cfg"], src["shapes"]),
                             ("b", started["cfg32"], src["shapes32"])):
        gan = WindFieldGAN(cfg, src["coords"], src["coords"], device=dev)
        st = gan.init_state(SPATIAL_SEED, *shapes)
        if key == "a":
            ref["params0"] = {k: v.clone() for k, v in st.params_G.items()}
        ref["names"] = [(k, v.numel()) for tree in (st.params_G,
                                                     st.params_D)
                        for k, v in tree.items()]
        ref["n_G"] = len(st.params_G)
        grads = spy_grads(gan)
        steps = []
        for it, b in zip(SPATIAL_ITS, src[key]):
            st.it = it
            reset_counters()
            torch.cuda.synchronize()
            t = time.monotonic()
            st, m = gan.train_step(st, *(x.to(dev) for x in b))
            torch.cuda.synchronize()
            steps.append(dict(ms=1e3 * (time.monotonic() - t),
                              launches=counters(), g_step=bool(
                                  m["is_g_step"]),
                              losses={k: float(m[k]) for k in (
                                  "total", "pix", "adversarial",
                                  "D_train_loss", *PHYSICS_KEYS)}))
        ref[key] = steps
        ref[f"{key}_grads"] = grads
        ref[f"{key}_peak"] = torch.cuda.max_memory_allocated(dev)
        del gan, st
        torch.cuda.empty_cache()
    sr = WindFieldSR(started["cfg"], ref["params0"], device=dev)
    torch.cuda.synchronize()
    t = time.monotonic()
    ref["served"] = sr.upscale(*src["serve"])
    ref["c_ms"] = 1e3 * (time.monotonic() - t)
    del sr
    torch.cuda.empty_cache()
    return ref


def spatial_phase(dev, card, tmp, started, ref):
    """Phase 14: configs/fullvol.ini at full width on data 2 x spatial 4,
    eight processes sharing the card over gloo, against one process on it
    from the same state (``ref``, spatial_reference's, made alone on the
    card at phase 13's start): (a) as committed, bf16, batch 8; (b)
    float32 with kernels 3 and 4, batch 2; (c) serving 8 volumes. Phase
    13's processes have ended: the eight get their go here and have the
    card to themselves. Returns the ranks' launches and figures."""
    import numpy as np
    import torch

    t0 = time.monotonic()
    ctx = started["ctx"]
    spatial_ready(started)
    t_go = time.monotonic()
    open(os.path.join(tmp, "spatial_go"), "w").close()
    for key in ("a", "b"):
        for st in ref[key]:
            log(f"  one process, {'bf16 batch 8' if key == 'a' else 'float32 batch 2'}: "
                f"{'G' if st['g_step'] else 'D'} step {st['ms']:.1f} ms host "
                f"clock, launches {LAUNCH_LABELS} {st['launches']}; peak "
                f"{ref[f'{key}_peak'] / 2**30:.2f} GiB ({card})")
    log(f"  one process serves 8 volumes in {ref['c_ms']:.1f} ms host clock "
        f"({card}); these references ran at phase 13's start, with no other "
        f"process working on the card")
    # the results, as soon as rank 0 has written them; the ranks end after
    path = os.path.join(tmp, "spatial_out.pt")
    while not os.path.exists(path):
        codes = [proc.exitcode for proc in ctx.processes]
        # rank 0 writes the file before it ends: look again once all ended
        if any(c not in (None, 0) for c in codes) or (
                None not in codes and not os.path.exists(path)):
            fail(f"phase 14's ranks ended {codes} without their results")
        if time.monotonic() - t_go > 600:
            fail("phase 14's eight ranks gave no results within 600 s")
        time.sleep(0.05)
    ranks_s = time.monotonic() - t_go
    out = torch.load(path, weights_only=False)
    every = out["ranks"]
    d, s = SPATIAL_AXES
    log(f"  eight processes sharing one {card} over gloo (not a multi-card "
        f"figure), data {d} x spatial {s}: their card start-up "
        f"{max(v['start_s'] for v in every):.1f} s beside phase 13's untimed "
        f"work (all ready {started['t_ready'] - started['t_launch']:.1f} s "
        f"after their launch at phase 12's start), {ranks_s:.1f} s from "
        f"their go, at this phase's start, to their results, alone on the "
        f"card")

    for key, label in (("a", "(a) bf16, batch 8"),
                       ("b", "(b) float32 + kernels 3, 4, batch 2")):
        for r, v in enumerate(every):
            for st in v[key]:
                c = st["collectives"]
                log(f"  {label} rank {r} (row {r // s}, slab {r % s}) it "
                    f"{st['it']} ({'G' if st['g_step'] else 'D'} step): "
                    f"{st['ms']:.1f} ms host clock; {c['halo'][0]} halo "
                    f"exchanges, {c['halo'][1] / 1e6:.1f} MB, "
                    f"{c['halo'][2]:.1f} ms; {c['gather'][0]} gathers "
                    f"{c['gather'][1] / 1e6:.1f} MB {c['gather'][2]:.1f} ms; "
                    f"the gradients' all_reduce {st['ar_ms']:.1f} ms; "
                    f"launches {LAUNCH_LABELS} {st['launches']} ({card})")
        (g_err, d_err), worst = grad_errs(out[f"{key}_grads"],
                                          ref[f"{key}_grads"], ref["names"],
                                          ref["n_G"])
        log(f"  {label}: the worst tensors, G: "
            + ", ".join(f"{n} {e:.2e}" for e, n in worst[0]) + "; D: "
            + ", ".join(f"{n} {e:.2e}" for e, n in worst[1]))
        lerr = max(abs(v - w) / max(abs(w), 1e-12)
                   for st, wt in zip(every[0][key], ref[key])
                   for k, w in wt["losses"].items()
                   for v in [st["losses"][k]] if w != 0.0 or v != 0.0)
        log(f"  {label}: summed over the eight vs one process: G gradients "
            f"rel L2 {g_err:.3e}, D gradients {d_err:.3e}; losses' largest "
            f"relative difference {lerr:.3e}")
        same = len({v[f"{key}_sum"] for v in every}) == 1
        log(f"  {label}: every rank's state equal to rank 0's after the "
            f"steps: {same}")
        if not same:
            fail(f"{label}: the ranks' states differ")
        if key == "a":
            if not (g_err <= SPATIAL_G_TOL and lerr <= SPATIAL_LOSS_TOL):
                fail(f"(a) the mesh disagrees with one process (tol "
                     f"{SPATIAL_G_TOL:.0e} / {SPATIAL_LOSS_TOL:.0e})")
        else:
            perr = max(abs(st["losses"][k] - wt["losses"][k])
                       / max(abs(wt["losses"][k]), 1e-30)
                       for st, wt in zip(every[0]["b"], ref["b"])
                       if st["g_step"] for k in PHYSICS_KEYS)
            log(f"  (b) the four physics terms' largest relative difference "
                f"{perr:.3e} (tol {SPATIAL_PHYS_TOL:.0e}); gradients tol "
                f"{SPATIAL_F32_TOL:.0e}")
            if not (g_err <= SPATIAL_F32_TOL and d_err <= SPATIAL_F32_TOL
                    and perr <= SPATIAL_PHYS_TOL):
                fail("(b) the float32 mesh disagrees with one process")
            for r, v in enumerate(every):
                g = [st["launches"] for st in v["b"] if st["g_step"]]
                if not g or g[0][2] < 2 or g[0][3] < 1:
                    fail(f"(b) rank {r}'s G step launched {g}: kernels 3 "
                         f"and 4 did not run on its slab")
    for r, v in enumerate(every):
        shape, e_grad, e_adj = v["stencil"]
        log(f"  (b) kernels 3 and 4 on rank {r}'s haloed slab {shape}: "
            f"gradient rel L2 {e_grad:.3e}, adjoint {e_adj:.3e} against "
            f"their plain versions (tol {SPATIAL_STENCIL_TOL:.0e})")
        if not (e_grad <= SPATIAL_STENCIL_TOL
                and e_adj <= SPATIAL_STENCIL_TOL):
            fail("(b) the stencil kernels disagree on a haloed slab")
    served = torch.from_numpy(out["served"])
    err = rel_l2(served, torch.from_numpy(ref["served"]))
    same = len({v["c_sum"] for v in every}) == 1
    log(f"  (c) WindFieldSR(mesh=).upscale of 8 volumes on the eight ranks: "
        f"rel L2 {err:.3e} against one process (tol "
        f"{SPATIAL_SERVE_TOL:.0e}), the whole batch on every rank "
        f"{same}, {[round(v['c_ms'], 1) for v in every]} ms host clock, "
        f"launches {every[0]['c_launches']} ({card})")
    if not (err <= SPATIAL_SERVE_TOL and same and served.shape == (
            8, 128, 128, 10, 3) and bool(np.isfinite(out["served"]).all())):
        fail("(c) serving on the spatial mesh disagrees")
    d_launches = three_axes_report(card, every, out, ref)
    log(f"  peak memory a rank {[round(v['peak'] / 2**30, 2) for v in every]}"
        f" GiB; seconds from the go to the results, (a) to (d), a rank "
        f"{[round(v['go_s'], 1) for v in every]}, of them (c) "
        f"{[round(v['c_s'], 1) for v in every]} and (d) "
        f"{[round(v['d_s'], 1) for v in every]} ({card})")
    # the ranks end on their own (main's cleanup stops any that has not)
    secs = time.monotonic() - t0
    log(f"  phase 14 took {secs:.1f} s")
    return dict(launches_spatial=[
        [sum(st["launches"][i] for st in v["b"]) for v in every]
        for i in (2, 3)], launches_model=d_launches, seconds=secs,
        g_ms=[[st["ms"] for st in v["a"] if st["g_step"]][0] for v in every],
        d_ms=[[st["ms"] for st in v["a"] if not st["g_step"]][0]
              for v in every])


# phase 15: milestone9k as committed fed from raw HARMONIE-SIMRA files
# instead of --synthetic. The files are written here (netCDF3 classic, the
# port's analytic fields): three days from REAL_START, T00Z and T12Z, 13
# timesteps, the raw extent whose crop is 128 x 128 and 12 raw levels (the
# crop keeps levels 1..10; the real files hold over 40: a cut in depth of
# the raw file only); x_wind_ml packed as int16; one file left out and one
# hour with a fill voxel. The leg is 6000 -> 6004 from the 6k pack.
REAL_START = (2018, 3, 1)
REAL_DAYS = 3
REAL_RAW = (136, 135, 12)          # raw x, y, levels
REAL_PACKED = "x_wind_ml"
REAL_ABSENT = (1, "T12Z.nc")       # (day, simulation) not on disk
REAL_FILL = (0, "T00Z.nc", 5)      # (day, simulation, timestep) filled
REAL_RAW_VARS = ("geopotential_height_ml", "x_wind_ml", "y_wind_ml",
                 "upward_air_velocity_ml", "air_pressure_ml")


class Fetches(Patches):
    """``urllib.request.urlretrieve`` replaced by a counter that raises:
    ``urls`` holds the URLs it was asked for."""

    def __init__(self):
        import urllib.request

        super().__init__()
        self.urls = []
        urls = self.urls

        def refuse(real):
            def refused(url, *a, **kw):
                urls.append(url)
                raise OSError(f"no network in the smoke: {url}")
            return refused

        self.patch(urllib.request, "urlretrieve", refuse)


def plain_raw_hours(path, nz):
    """A raw file by hand, with scipy's reader and no masking or scaling:
    the packed variable's int16 × scale_factor + add_offset in float64,
    its _FillValue as NaN, the others as float64; (t, z, x, y) → (t, x,
    y, z), z reversed, the last timestep dropped, the crop x 4:-4, y 4:-3,
    z 1:1+nz. → ({variable: (12, X, Y, nz)}, (terrain, x, y) cropped)."""
    import numpy as np
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False, maskandscale=False)
    try:
        out = {}
        for name in REAL_RAW_VARS:
            var = f.variables[name]
            a = var.data.astype(np.float64)
            if name == REAL_PACKED:
                a = a * var.scale_factor + var.add_offset
                a[var.data == var._FillValue] = np.nan
            out[name] = np.transpose(a, (0, 2, 3, 1))[:-1, :, :, ::-1][
                :, 4:-4, 4:-3, 1:1 + nz]
        static = (f.variables["surface_altitude"].data.astype(
            np.float64)[4:-4, 4:-3],
            1e5 * f.variables["x"].data.astype(np.float64)[4:-4],
            1e5 * f.variables["y"].data.astype(np.float64)[4:-3])
    finally:
        f.close()
    return out, static


def real_config(tmp, **env):
    """Phase 7's copy of milestone9k (folders in ``tmp``/real, the 6k pack,
    the leg's schedule with the validation at LEG_MID) with the phase's
    own data root, its dates cut to REAL_DAYS days, and ``env``."""
    from datetime import date, timedelta

    cfg, path = leg_config(tmp, "real", val_period=LEG_MID - LEG_FROM)
    cfg.env.data_root = os.path.join(tmp, "real", "data")
    start = date(*REAL_START)
    end = start + timedelta(days=REAL_DAYS - 1)
    cfg.gan_config.start_date = [start.year, start.month, start.day]
    cfg.gan_config.end_date = [end.year, end.month, end.day]
    for k, v in env.items():
        setattr(cfg.env, k, v)
    cfg.save(path)
    return cfg, path


def files_mtimes(root):
    return {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
            for d, _, names in os.walk(root) for n in names}


def real_data_phase(dev, card, tmp):
    """Phase 15: (a) the raw files; (b) run.py --download, then again; (c)
    run.py --train without --synthetic, 6000 -> 6004; (d) run.py --test
    from its ckpt_6004. Returns the launches of (c) and (d) and the
    seconds."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from datetime import date, timedelta

    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch import run
    from gan_sr_wind_field_tpu_torch.data import downloader
    from gan_sr_wind_field_tpu_torch.data import files as dfiles
    from gan_sr_wind_field_tpu_torch.data import preprocess
    from gan_sr_wind_field_tpu_torch.data.device_data import DeviceBatcher
    from gan_sr_wind_field_tpu_torch.data.synthetic import (
        write_raw_simulation,
    )
    from gan_sr_wind_field_tpu_torch.data.transform import reformat_sample

    t = [time.monotonic()]

    def took(part):
        t.append(time.monotonic())
        log(f"  ({part}) took {t[-1] - t[-2]:.1f} s")

    cfg, ini = real_config(tmp)
    g = cfg.gan_config
    nz = g.number_of_z_layers
    root = cfg.env.data_root
    raw_dir = os.path.join(root, "downloaded_raw_bessaker_data")
    os.makedirs(raw_dir)
    days = [date(*REAL_START) + timedelta(days=d) for d in range(REAL_DAYS)]
    sims = [(d, s) for d in range(REAL_DAYS) for s in downloader.SIM_TIMES]
    on_disk = [(d, s) for d, s in sims if (d, s) != REAL_ABSENT]
    nx, ny, nz_raw = REAL_RAW
    log(f"real-data path: {os.path.basename(CFG)} copy, {days[0]} to "
        f"{days[-1]}, raw files {nx}x{ny}x{nz_raw} x 13 timesteps "
        f"(netCDF3, {REAL_PACKED} int16), {len(on_disk)} of {len(sims)} on "
        f"disk, hour {REAL_FILL[2]} of day {REAL_FILL[0]} {REAL_FILL[1]} "
        f"with a fill")

    # (a) the raw files, one thread each
    def write(sim):
        d, s = sim
        fill = ((REAL_FILL[2], REAL_PACKED) if (d, s) == REAL_FILL[:2]
                else None)
        write_raw_simulation(
            os.path.join(raw_dir, downloader.raw_filename(days[d], s)),
            nx, ny, nz_raw, seed=sims.index(sim), packed=(REAL_PACKED,),
            fill=fill)

    with ThreadPoolExecutor(max_workers=len(on_disk)) as pool:
        list(pool.map(write, on_disk))
    raw_mb = sum(os.path.getsize(os.path.join(raw_dir, n))
                 for n in os.listdir(raw_dir)) / 1e6
    log(f"  (a) wrote {len(on_disk)} raw files, {raw_mb:.1f} MB")
    took("a")

    # (b) run.py --download with the network refused, then once more
    absent = downloader.raw_filename(days[REAL_ABSENT[0]], REAL_ABSENT[1])
    filled = downloader._hour_names(days[REAL_FILL[0]], REAL_FILL[1])[
        REAL_FILL[2]]
    gone = {filled, *downloader._hour_names(days[REAL_ABSENT[0]],
                                            REAL_ABSENT[1])}
    want = [n for n in dfiles.filenames_from_dates(days[0], days[-1])
            if n not in gone]
    fetches = Fetches()
    try:
        names = run.main(["--download", "--cfg", ini])
        first_urls = list(fetches.urls)
        folder = dfiles.dataset_folder(root, f"bessaker_z{nz}")
        mtimes = files_mtimes(root)
        again = run.main(["--download", "--cfg", ini])
    finally:
        fetches.close()
    with open(os.path.join(raw_dir, "invalid_files.txt")) as f:
        invalid = f.read().splitlines()
    with open(os.path.join(folder, "filtered_samples.txt")) as f:
        filtered = f.read().splitlines()
    log(f"  (b) --download: {len(names)} hours cached of "
        f"{len(dfiles.filenames_from_dates(days[0], days[-1]))}; fetch "
        f"attempts {first_urls}; invalid_files.txt {invalid}; "
        f"filtered_samples.txt {filtered}")
    if not (names == want and first_urls == [
            downloader.nc_url(days[REAL_ABSENT[0]], REAL_ABSENT[1])]
            and invalid == [absent] and filtered == [filled]
            and not os.path.exists(dfiles.sample_path(folder, filled))):
        fail("(b) the download's hours, fetches or bookkeeping are not "
             "the raw files'")
    terrain = None
    for d, s in on_disk:
        hours, static = plain_raw_hours(
            os.path.join(raw_dir, downloader.raw_filename(days[d], s)), nz)
        if terrain is None:  # the first file that opens
            terrain = static[0]
            got = dfiles.read_static(os.path.join(root,
                                                  "full_dataset_files"))
            if not all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(got, static)):
                fail("(b) the static file is not the first raw file's")
        for h, name in enumerate(downloader._hour_names(days[d], s)):
            if name == filled:
                continue
            z = hours["geopotential_height_ml"][h]
            plain = (z, z - terrain[:, :, None],
                     *(hours[v][h] for v in REAL_RAW_VARS[1:]))
            cached = dfiles.read_sample(folder, name)
            if not all(a.dtype == np.float64 and np.array_equal(a, b)
                       for a, b in zip(cached, plain)):
                fail(f"(b) cached hour {name} is not its raw file's")
    log(f"  (b) every cached hour equal bit for bit to its raw file "
        f"re-read with numpy (unpacked, cropped, transposed, z reversed, "
        f"float64): True; the static file too: True")
    rewritten = [p for p, m in files_mtimes(root).items()
                 if mtimes.get(p) != m]
    log(f"  (b) a second --download: {len(again)} hours, fetch attempts "
        f"{fetches.urls[len(first_urls):]}, files rewritten {rewritten}")
    if again != names or fetches.urls != first_urls or rewritten:
        fail("(b) the second download did work again")
    took("b")

    # (c) the leg through the command line, without --synthetic
    batchers = []

    def keep(real):
        def init(self, *a, **kw):
            real(self, *a, **kw)
            batchers.append(self)
        return init

    probe = LegProbe()
    probe.patch(DeviceBatcher, "__init__", keep)
    reset_counters()
    fetches = Fetches()
    try:
        state = run.main(["--cfg", ini, "--train", "--max_steps",
                          str(LEG_MID)])
    finally:
        fetches.close()
        probe.close()
    torch.cuda.synchronize()
    launches = counters() + (int8_launches(),)
    ds_train, ds_test, ds_val, _, _ = preprocess(cfg, synthetic=False)
    its = range(LEG_FROM + 1, LEG_MID + 1)
    period = cfg.training.d_g_train_period
    g_steps = [(it // period) % (cfg.training.d_g_train_ratio + 1) == 0
               for it in its]
    n_g, n_d = sum(g_steps), len(g_steps) - sum(g_steps)
    val_batches = math.ceil(len(ds_val) / cfg.dataset_val.batch_size)
    predicted = tuple(
        n_g * a + n_d * b + val_batches * c + e
        for a, b, c, e in zip(G_STEP_LAUNCHES, D_STEP_LAUNCHES,
                              VAL_LAUNCHES, GENERATE_LAUNCHES)) + (0,)
    log(f"  (c) --train {LEG_FROM} -> {LEG_MID} on {len(ds_train)} train / "
        f"{len(ds_val)} val / {len(ds_test)} test hours: {n_g} G steps, "
        f"{n_d} D steps, {val_batches} validation batches, "
        f"{probe.calls['generate']} generate calls; launches "
        f"{LAUNCH_LABELS}/conv_int8 {launches}, predicted {predicted}")
    if (not probe.steps or probe.steps[0][3] != LEG_FROM
            or state.it != LEG_MID or fetches.urls
            or [s[1] for s in probe.steps] != g_steps
            or probe.calls != {"val_step": val_batches, "generate": 1}):
        fail(f"(c) the leg ran {[s[0] for s in probe.steps]} to {state.it} "
             f"with calls {probe.calls} and fetches {fetches.urls}")
    if launches != predicted:
        fail(f"(c) the leg launched {launches}, predicted {predicted}")
    with open(os.path.join(tmp, "real", "log", "status.log")) as f:
        status = f.read()
    logged = re.findall(rf"it {LEG_MID} G_total (\S+) D (\S+)", status)
    vals = re.findall(rf"validation it {LEG_MID}: PSNR (\S+) \(trilinear "
                      r"(\S+)\) G_total (\S+)", status)
    log(f"  (c) logged it {LEG_MID} (G_total, D) {logged}; validation "
        f"(PSNR, trilinear, G_total) {vals}")
    if not (len(logged) == len(vals) == 1 and all(
            math.isfinite(float(v)) for v in (*logged[0], *vals[0]))):
        fail("(c) the leg's logged losses are not finite")
    (batcher,) = batchers
    full, zraw = batcher.full.cpu().numpy(), batcher.zraw.cpu().numpy()
    same = full.shape[0] == zraw.shape[0] == len(ds_train)
    for i, name in enumerate(ds_train.filenames if same else ()):
        # the cached hour as the loop's float32 memmap (npcache) holds it
        lr1, _, zt = reformat_sample(
            *(a.astype(np.float32) for a in dfiles.read_sample(folder, name)),
            ds_train.stats,
            coarseness_factor=1, include_pressure=g.include_pressure,
            include_z_channel=g.include_z_channel,
            include_above_ground_channel=g.include_above_ground_channel)
        same = same and np.array_equal(full[i], lr1) and np.array_equal(
            zraw[i], zt)
    log(f"  (c) the resident volumes {full.shape} equal to the cached "
        f"hours (as float32, the npcache's) after reformat_sample: {same}")
    if not same:
        fail("(c) the resident volumes are not the cached hours")
    del batcher, batchers, full, zraw, state
    torch.cuda.empty_cache()
    (ckpt_path,) = [os.path.join(d, f"ckpt_{LEG_MID}") for d, _, _ in
                    os.walk(os.path.join(tmp, "real", "runs"))
                    if os.path.isdir(os.path.join(d, f"ckpt_{LEG_MID}"))]
    took("c")

    # (d) --test from ckpt_6004 on the held-out split
    _, test_ini = real_config(tmp, generator_load_path=ckpt_path)
    cwd = os.path.join(tmp, "real", "cwd")
    os.makedirs(cwd)
    old = os.getcwd()
    gen_probe = GenerateProbe()
    reset_counters()
    try:
        os.chdir(cwd)
        avgs = run.main(["--cfg", test_ini, "--test"])
        torch.cuda.synchronize()
    finally:
        os.chdir(old)
        gen_probe.close()
    test_launches = counters() + (int8_launches(),)
    out = os.path.join(cwd, "test_output")
    header, psnr = read_metrics(os.path.join(out,
                                             f"{cfg.name}____metrics.csv"))
    with open(os.path.join(out, "averages.csv")) as f:
        avg_rows = f.read().splitlines()[1:]
    n_test = len(ds_test)
    log(f"  (d) --test from ckpt_{LEG_MID}: {len(psnr)} rows for "
        f"{n_test} test hours, PSNR {min(psnr.values()):.3f} to "
        f"{max(psnr.values()):.3f} dB, average {avgs['PSNR']:.3f} "
        f"(trilinear {avgs['PSNR_trilinear']:.3f}); averages rows "
        f"{[r.split(',')[0] for r in avg_rows]}; {len(gen_probe.outputs)} "
        f"generate calls, launches {LAUNCH_LABELS}/conv_int8 "
        f"{test_launches}")
    if not (sorted(psnr) == sorted(n[:-4] for n in ds_test.filenames)
            and len(avg_rows) == 1 and all(math.isfinite(v) for v in
                                           psnr.values())
            and math.isfinite(avgs["PSNR"])
            and len(gen_probe.outputs) == n_test
            and test_launches == (n_test, 0, 0, 0, n_test, 0)):
        fail("(d) the test pass's rows, PSNRs or launches are off")
    took("d")
    shutil.rmtree(os.path.join(tmp, "real"))
    secs = t[-1] - t[0]
    log(f"  phase 15 took {secs:.1f} s ({card})")
    return dict(launches=tuple(a + b for a, b in zip(launches,
                                                       test_launches)),
                seconds=secs, parts=[b - a for a, b in zip(t, t[1:])])

# phase 16: milestone9k's leg under the port's supervisor, leg 0 stopped
# with SIGTERM once it has saved ckpt_6004, leg 1 resumed by the supervisor.
# Its three processes (the two legs and the export) start at phase 15's
# start and import torch and the port beside it on the host; each then
# waits for its request (OUT/NAME.go)
SUPERVISED_RESTARTS = 2
WARM = ("leg0", "leg1", "export")
WARM_TIMEOUT_S = 900.0


def _put(path, obj):
    """Writes ``obj`` as JSON to ``path`` whole (a reader never sees a
    part)."""
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".part", path)


def _alive(pid):
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _wait_json(path, pid=None, timeout=WARM_TIMEOUT_S):
    """The JSON in ``path`` once it is written; None if process ``pid``
    ended first or ``timeout`` passed."""
    t = time.monotonic()
    while not os.path.exists(path):
        if (pid is not None and not _alive(pid)
                or time.monotonic() - t > timeout):
            return None
        time.sleep(0.01)
    with open(path) as f:
        return json.load(f)


def start_warm(out):
    """Starts phase 16's three processes (``chip_smoke.py --warm OUT
    NAME``) with ``out`` their folder."""
    os.makedirs(out)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *filter(None, [env.get("PYTHONPATH")])])
    for name in WARM:
        CHILDREN.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--warm", out, name],
            cwd=REPO, env=env))


def warm_process(out, name):
    """One of phase 16's processes: imports torch and the port, creates
    its CUDA context (and does no other card work), writes OUT/NAME.ready,
    waits for OUT/NAME.go and runs what it asks: a leg
    (supervised_leg), or a module as ``python -m`` runs it (runpy, as
    __main__, its output into OUT/NAME.log); exits with its code, written
    to OUT/NAME.rc first."""
    import runpy
    import traceback

    t0 = time.time()
    import torch

    sys.path.insert(0, REPO)
    from gan_sr_wind_field_tpu_torch import run  # noqa: F401

    torch.zeros(1, device="cuda")  # the process's CUDA context
    _put(os.path.join(out, f"{name}.ready"),
         {"pid": os.getpid(), "start": t0, "ready": time.time()})
    req = _wait_json(os.path.join(out, f"{name}.go"))
    rc = 1
    try:
        if req is None:
            raise RuntimeError(f"{name}: no request in {WARM_TIMEOUT_S} s")
        if req["mode"] == "leg":
            supervised_leg(out, req["argv"])
        else:
            with open(os.path.join(out, f"{name}.log"), "w") as f:
                os.dup2(f.fileno(), 1)
                os.dup2(f.fileno(), 2)
            sys.argv = [req["module"], *req["argv"]]
            runpy.run_module(req["module"], run_name="__main__",
                             alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception:
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    _put(os.path.join(out, f"{name}.rc"), rc)
    sys.exit(rc)


def supervised_runner(out, argv):
    """The supervisor's runner in phase 16 (``chip_smoke.py
    --supervised-leg OUT --cfg INI ...``): hands the leg to the first of
    phase 16's leg processes that no leg has taken yet, waits for it and
    exits with its code; with none left, runs the leg itself."""
    for name in WARM[:2]:
        try:
            os.close(os.open(os.path.join(out, f"{name}.claim"),
                             os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        ready = _wait_json(os.path.join(out, f"{name}.ready"))
        if ready is None:
            fail(f"phase 16's process {name} never got ready")
        _put(os.path.join(out, f"{name}.go"), {"mode": "leg", "argv": argv})
        rc = _wait_json(os.path.join(out, f"{name}.rc"), ready["pid"])
        sys.exit(1 if rc is None else rc)
    supervised_leg(out, argv)


def supervised_leg(out, argv):
    """One leg of phase 16: writes its pid to OUT/pids, runs
    ``run.main(["--train", *argv])`` with the launch counters from 0 and
    the main process's TF32 settings, and appends its launches, its steps
    (it, G step, wall clock) and its validation and generate calls to
    OUT/legs.jsonl."""
    t_go = time.time()
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from gan_sr_wind_field_tpu_torch import run

    with open(os.path.join(out, "pids"), "a") as f:
        f.write(f"{os.getpid()}\n")
    probe = LegProbe()
    reset_counters()
    t_main = time.time()
    try:
        state = run.main(["--train", *argv])
    finally:
        probe.close()
    torch.cuda.synchronize()
    rec = {"pid": os.getpid(), "it": state.it,
           "t": {"go": t_go, "main": t_main, "end": time.time()},
           "launches": list(counters()) + [int8_launches()],
           "steps": [[s[0], bool(s[1]), s[4]] for s in probe.steps],
           "calls": probe.calls,
           "saves": [[secs, nbytes] for secs, nbytes in probe.saves]}
    with open(os.path.join(out, "legs.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def checkpoint_trees(path, dev):
    """A checkpoint's state.pt on ``dev`` as tree_diffs reads a state."""
    import types

    import torch

    blob = torch.load(os.path.join(path, "state.pt"), map_location=dev,
                      weights_only=True)
    for opt in ("opt_state_G", "opt_state_D"):
        blob[opt] = types.SimpleNamespace(**blob[opt])
    return types.SimpleNamespace(**blob)


def leg_prediction(its, cfg, val_batches, generates):
    """Kernels 1 to 5's launches of a leg's iterations ``its`` with its
    validation batches and generate calls, and its steps' kinds."""
    period = cfg.training.d_g_train_period
    kinds = [(it // period) % (cfg.training.d_g_train_ratio + 1) == 0
             for it in its]
    n_g = sum(kinds)
    n_d = len(kinds) - n_g
    return kinds, tuple(
        n_g * a + n_d * b + val_batches * c + generates * e
        for a, b, c, e in zip(G_STEP_LAUNCHES, D_STEP_LAUNCHES,
                              VAL_LAUNCHES, GENERATE_LAUNCHES))


def supervised_phase(dev, card, tmp, out):
    """Phase 16: ``supervise()`` of the port's supervisor
    (scripts/supervise_train.py) on a copy of milestone9k with niter 6008,
    in phase 7's temporary directory on its data, each leg a process of
    its own running run.main (``out``: the folder of the processes
    start_warm started); leg 0 gets SIGTERM once its ckpt_6004 is
    written, leg 1 resumes from the checkpoint leg 0 leaves. Then leg 1's
    ckpt_6008 against phase 7's, the port's export_continuation on leg 1's
    run folder (its own process, on the card) against phase 8's pack, and
    summarize() on that folder. → each leg's launches."""
    import configparser
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.scripts import supervise_train as sup
    from gan_sr_wind_field_tpu_torch.scripts.summarize_longrun import (
        summarize,
    )
    from gan_sr_wind_field_tpu_torch.train.continuation import (
        bf16_bits_to_f32,
    )

    t_phase = time.monotonic()
    t_wall = time.time()
    cfg, ini = leg_config(tmp, "supervised", logger=True)
    name, _, runs_dir = sup.read_run_meta(ini)
    ready = {}
    for proc in WARM:
        ready[proc] = _wait_json(os.path.join(out, f"{proc}.ready"))
        if ready[proc] is None:
            fail(f"phase 16's process {proc} did not get ready")
    log("  its three processes, started at phase 15's start: torch and "
        "the port imported in " + ", ".join(
            f"{p} {r['ready'] - r['start']:.1f} s" for p, r in ready.items())
        + f"; ready {t_wall - max(r['ready'] for r in ready.values()):.1f} s"
        " before this phase")
    launched = []

    def slog(msg):
        if msg.startswith("[supervisor] leg ") and ": " in msg:
            launched.append(time.time())
        log(f"  {msg}")

    # (a, b) the supervisor in a thread; this thread stops leg 0
    runner = [sys.executable, os.path.abspath(__file__), "--supervised-leg",
              out]
    log(f"  (a) supervise({os.path.basename(ini)}: milestone9k with niter "
        f"{LEG_TO}, schedule {LEG_SCHEDULE}, max_restarts "
        f"{SUPERVISED_RESTARTS}, backoff_s 0), each leg run.main(['--train', "
        f"'--synthetic', {', '.join(repr(a) for a in LEG_DATA)}, "
        f"'--cfg', ...]) in a process of its own (the runner hands it to "
        f"one of the processes above)")
    pool = ThreadPoolExecutor(max_workers=1)
    run = pool.submit(sup.supervise, ini, ["--synthetic", *LEG_DATA],
                      max_restarts=SUPERVISED_RESTARTS, backoff_s=0,
                      runner=runner, log=slog)
    pool.shutdown(wait=False)
    mid = None
    while mid is None:
        if run.done():
            fail(f"(b) the supervisor returned {run.result()} before leg 0 "
                 f"saved ckpt_{LEG_MID}")
        for folder in os.listdir(runs_dir) if os.path.isdir(runs_dir) else ():
            path = os.path.join(runs_dir, folder, f"ckpt_{LEG_MID}",
                                "state.pt")
            if os.path.isfile(path):
                mid = path
        time.sleep(0.01)
    with open(os.path.join(out, "pids")) as f:
        pid0 = int(f.readline())
    try:
        os.kill(pid0, signal.SIGTERM)
    except ProcessLookupError:
        fail("(b) leg 0 had ended before its SIGTERM")
    t_kill = time.time()
    log(f"  (b) ckpt_{LEG_MID}/state.pt written; SIGTERM sent to leg 0 "
        f"(pid {pid0})")
    legs = run.result(timeout=900)
    with open(os.path.join(out, "legs.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(tmp, "supervised", "log", "status.log")) as f:
        status = f.read()
    log(f"  (b) the supervisor's legs {legs}")
    if len(legs) != 2 or len(recs) != 2:
        fail(f"(b) {len(legs)} legs ran, {len(recs)} recorded; 2 asked")
    k = recs[0]["it"]
    stopped = re.findall(r"SIGTERM at it (\d+)", status)
    resume_ini = os.path.join(runs_dir, f"{name}_resume_leg1.ini")
    resume = configparser.ConfigParser()
    resume.read(resume_ini)
    ckpt_k = resume.get("ENV", "state_load_path", fallback="")
    log(f"  (b) leg 0: exit {legs[0]['rc']}, SIGTERM answered at it "
        f"{stopped}, its newest checkpoint it {legs[0]['reached_it']}; "
        f"{os.path.basename(resume_ini)}: state_load_path "
        f"{os.path.relpath(ckpt_k, tmp)}, resume_training_from_save "
        f"{resume.get('TRAINING', 'resume_training_from_save')}")
    if not (legs[0]["rc"] == 0 and stopped == [str(k)]
            and LEG_MID <= k < LEG_TO and legs[0]["reached_it"] == k
            and ckpt_k.endswith(f"ckpt_{k}")
            and resume.getboolean("TRAINING", "resume_training_from_save")
            and resume.getboolean("DEFAULT", "load_model_from_save")):
        fail("(b) leg 0 did not stop cleanly with a checkpoint in "
             f"[{LEG_MID}, {LEG_TO})")
    resumed = re.findall(r"resumed from (\S+) at it=(\d+)", status)
    log(f"  (b) leg 1: exit {legs[1]['rc']}, resumed {resumed}, reached it "
        f"{legs[1]['reached_it']}")
    if not (legs[1]["rc"] == 0 and legs[1]["reached_it"] == LEG_TO
            and resumed == [(ckpt_k, str(k))] and recs[1]["it"] == LEG_TO):
        fail("(b) leg 1 did not resume at the leg 0's checkpoint and end "
             f"at {LEG_TO}")

    # (c) each leg's launches as its own steps and calls predict
    n_val = int(re.search(r"datasets: train \d+ / test \d+ / val (\d+)",
                          status).group(1))
    val_batches = math.ceil(n_val / cfg.dataset_val.batch_size)
    spans = (range(LEG_FROM + 1, k + 1), range(k + 1, LEG_TO + 1))
    wants = ({"val_step": 0, "generate": 0},
             {"val_step": val_batches, "generate": 1})
    per_leg = []
    for i, (rec, its, calls) in enumerate(zip(recs, spans, wants)):
        kinds, predicted = leg_prediction(its, cfg, calls["val_step"],
                                          calls["generate"])
        got = tuple(rec["launches"])
        t = rec["t"]
        first = rec["steps"][0][2] if rec["steps"] else float("nan")
        start_s = first - launched[i]
        parts = (f"the runner's launch to the leg's go "
                 f"{t['go'] - launched[i]:.1f} s, run.main to its first "
                 f"step {first - t['main']:.1f} s, its first step to the "
                 f"leg's exit {launched[i] + legs[i]['wall_s'] - first:.1f}"
                 " s")
        log(f"  (c) leg {i}: it {its.start - 1} -> {its.stop - 1}, "
            f"{sum(kinds)} G steps, {len(kinds) - sum(kinds)} D steps, "
            f"{calls['val_step']} validation batches, {calls['generate']} "
            f"generate calls; launches {LAUNCH_LABELS}/conv_int8 {got}, "
            f"predicted {predicted + (0,)}; wall {legs[i]['wall_s']} s, "
            f"start-up to its first step {start_s:.1f} s ({parts}); saves "
            f"{[round(s, 3) for s, _ in rec['saves']]} s ({card})")
        if ([s[0] for s in rec["steps"]] != list(its)
                or [s[1] for s in rec["steps"]] != kinds
                or rec["calls"] != calls):
            fail(f"(c) leg {i} ran {rec['steps']} with calls "
                 f"{rec['calls']}, not the schedule's")
        if got != predicted + (0,):
            fail(f"(c) leg {i} launched {got}, predicted {predicted}")
        per_leg.append(got)
    log(f"  (b) SIGTERM {t_kill - launched[0]:.1f} s after leg 0's launch")

    # (d) the export in a process of its own, on the card, beside (c)'s
    # comparison and (e)
    (folder1,) = re.findall(rf"saved checkpoint (\S+)/ckpt_{LEG_TO}$",
                            status, re.M)
    pack = os.path.join(tmp, "supervised_export.npz")
    module = "gan_sr_wind_field_tpu_torch.scripts.export_continuation"
    t_export = time.monotonic()
    _put(os.path.join(out, "export.go"),
         {"mode": "module", "module": module, "argv": [folder1, "--out",
                                                      pack]})

    # (c) leg 1's ckpt_6008 against phase 7's uninterrupted one
    a = checkpoint_trees(os.path.join(folder1, f"ckpt_{LEG_TO}"), dev)
    b = checkpoint_trees(os.path.join(cfg_run_folder(tmp, "leg"),
                                      f"ckpt_{LEG_TO}"), dev)
    diffs = tree_diffs(a, b)
    exact = all(v[2] for v in diffs.values()) and torch.equal(
        a.rng_state, b.rng_state) and a.it == b.it == LEG_TO
    for tname, (mx, rel, bits) in diffs.items():
        log(f"  (c) leg 1's ckpt_{LEG_TO} vs phase 7's {tname:<18} max abs "
            f"{mx:.3e}, rel L2 {rel:.3e}, bit-exact {bits}")
    log(f"  (c) SIGTERM at {k}, resumed by the supervisor, against phase "
        f"7's uninterrupted leg: it {a.it}, generator state equal "
        f"{torch.equal(a.rng_state, b.rng_state)}, bit-exact {exact}")
    if a.it != LEG_TO or (not exact and not all(
            v[1] <= RESUME_TOL for v in diffs.values())):
        fail(f"(c) the supervised run is off by more than {RESUME_TOL:.0e}")
    del a, b
    torch.cuda.empty_cache()

    # (e) the summary of leg 1's run folder
    summary, _ = summarize(folder1)
    tails = [summary[t] for t in ("val_PSNR_tail", "G_total_train_tail",
                                  "G_val_total_tail", "D_val_loss_tail")]
    log(f"  (e) summarize(leg 1's run folder): last_it {summary['last_it']}, "
        f"checkpoints {summary['checkpoints']}, val_PSNR_tail "
        f"{summary['val_PSNR_tail']}, G_total_train_tail "
        f"{summary['G_total_train_tail']}")
    if (summary["last_it"] != LEG_TO
            or summary["checkpoints"] != [f"ckpt_{LEG_TO}"]
            or any(t is None or not all(math.isfinite(v) for v in t.values())
                   for t in tails)):
        fail(f"(e) the summary: {summary}")

    # (d) the export's pack against phase 8's pack of phase 7's live state
    with np.load(os.path.join(tmp, "pack_bfloat16.npz")) as z:
        want = {k: z[k] for k in z.files}
    rc = _wait_json(os.path.join(out, "export.rc"),
                    ready["export"]["pid"], timeout=600)
    export_s = time.monotonic() - t_export
    with open(os.path.join(out, "export.log")) as f:
        text = f.read()
    log("  (d) " + "\n  (d) ".join(text.strip().splitlines()[-3:]))
    if rc != 0:
        fail(f"(d) export_continuation exited {rc}:\n{text}")
    with np.load(pack) as z:
        got = {k: z[k] for k in z.files}
    meta, meta_want = (json.loads(str(z.pop("__meta__"))) for z in (got, want))
    keys = sorted(got)
    # bit for bit after a bit-exact resume, else within (c)'s tolerance
    equal = {k: k in want and got[k].dtype == want[k].dtype
             and np.array_equal(got[k], want[k]) for k in keys}
    same = keys == sorted(want) and all(equal.values())
    worst = max([0.0] + [rel_l2(*(torch.from_numpy(bf16_bits_to_f32(z[k]))
                                  for z in (got, want)))
                         for k in keys if not equal[k] and k in want])
    log(f"  (d) python -m gan_sr_wind_field_tpu_torch.scripts."
        f"export_continuation (its own process, on the card, run as "
        f"python -m runs it: runpy, as __main__): "
        f"{os.path.getsize(pack)} bytes in {export_s:.1f} s; {len(keys)} "
        f"arrays against phase 8's bf16 pack of phase 7's live state: "
        f"equal bit for bit {same}, largest rel L2 {worst:.3e}; meta it "
        f"{meta['it']}, name {meta.get('name')}, source "
        f"{os.path.relpath(meta['source_ckpt'], tmp)}")
    if (not (same if exact else worst <= RESUME_TOL) or meta["it"] != LEG_TO
            or meta["trees"] != meta_want["trees"]):
        fail("(d) the exported pack is not phase 8's")
    took = time.monotonic() - t_phase
    log(f"  phase 16 took {took:.1f} s")
    return {"launches": per_leg, "seconds": took}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, REPO)
    from gan_sr_wind_field_tpu_torch.ops.kernels import build

    # ------------------------------------------------------------ 1. card
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    phase_start(2)
    t = time.monotonic()
    built = build.build()
    for name, (path, secs, report) in built.items():
        log(f"built {name}: {os.path.relpath(path, REPO)} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build total {time.monotonic() - t:.1f} s")
    # every library's SASS at once (cuobjdump takes seconds each)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(built)) as pool:
        list(pool.map(sass_mma_counts, [v[0] for v in built.values()]))
    log("bf16 kernels on the tensor cores:")
    mma_counts = report_tc_kernels(built)

    # phase 7's data feed on the host, in a thread beside phases 3 to 5
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="windsr_leg_")
    data_pool = ThreadPoolExecutor(max_workers=1)
    leg_data = data_pool.submit(prepare_leg_data, tmp)
    try:
        return _main_after_build(dev, card, built, mma_counts, tmp, leg_data)
    finally:
        for proc in CHILDREN:
            if isinstance(proc, subprocess.Popen):
                if proc.poll() is None:
                    # torchrun's workers are in its process group
                    os.killpg(proc.pid, 9) if os.getpgid(proc.pid) == proc.pid \
                        else proc.kill()
                    proc.wait()
            elif proc.is_alive():
                proc.kill()
                proc.join()
        data_pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)


def _main_after_build(dev, card, built, mma_counts, tmp, leg_data):
    """Phases 3 to 16 and the result lines, with phase 7's temporary
    directory ``tmp`` and the future of its data feed ``leg_data``."""
    import numpy as np
    import torch

    from gan_sr_wind_field_tpu_torch.config import load_config
    from gan_sr_wind_field_tpu_torch.eval.serve import WindFieldSR
    from gan_sr_wind_field_tpu_torch.eval.server import serve
    from gan_sr_wind_field_tpu_torch.models.blocks import RRDB
    from gan_sr_wind_field_tpu_torch.models.fused_apply import (
        generator_forward,
    )
    from gan_sr_wind_field_tpu_torch.models.generator import (
        generator_from_config,
    )
    from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import (
        rrdb_trunk,
        rrdb_trunk_reference,
    )

    # ------------------------------------------- 3. kernels vs plain versions
    phase_start(3)
    cfg = load_config(CFG)
    g = cfg.generator
    nf, gc, nconv = g.num_features, g.RDB_growth_chan, g.num_RDB_convs
    geom = dict(gc=gc, num_convs=nconv, rdb_scale=g.RDB_res_scaling,
                rrdb_scale=g.RRDB_res_scaling, negative_slope=0.2)
    lr_xy = cfg.gan_config.slice_size // cfg.scale
    zl = cfg.gan_config.number_of_z_layers
    gen = torch.Generator().manual_seed(2001)
    rrdbs = [RRDB(nf, gc, num_convs=nconv, init_scale=1.0, generator=gen)
             for _ in range(g.num_RRDB)]
    for r in rrdbs:
        for rdb in r.rdbs:  # non-zero LFF bias, so its path is checked
            rdb.lff.bias.data.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    d_out = torch.randn(2, lr_xy, lr_xy, zl, nf, generator=gen).to(dev)
    max_abs16, max_abs_bwd = check_trunk_kernels(rrdbs, x, d_out, geom, nf,
                                                 gc, nconv, dev)
    err_grad, err_adj = check_stencil_kernels(dev)
    hr_xy = lr_xy * cfg.scale
    tc = g.terrain_number_of_features
    head_dims = (hr_xy, zl, nf, tc, nf + tc, g.hr_kern_size)
    err_head = check_head_kernel(dev, *head_dims)
    check_head_bf16(dev, *head_inputs(dev, 32, *head_dims, 2005),
                    head_dims[-1], "batch 32")
    torch.cuda.synchronize()
    del rrdbs, x, d_out

    # ------------------------------------------------------------ 4. serve
    phase_start(4)
    G0 = generator_from_config(cfg, device=dev, seed=2001)
    params = G0.state_dict()
    # as committed (the head kernel), and the module head beside it
    sr_h = WindFieldSR(cfg, params, device=dev)
    sr = module_head(WindFieldSR(cfg, params, device=dev))
    del G0
    if sr_h.packed is None:
        fail("milestone9k geometry does not take the trunk kernel")
    if sr_h.head_packed is None:
        fail("milestone9k as committed does not take the head kernel in "
             "serving")
    rng = np.random.default_rng(2001)
    C = cfg.lr_num_channels

    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    outs = []
    reset_counters()
    srv = serve(sr_h, host="127.0.0.1", port=0, max_batch=8,
                max_wait_ms=20.0)
    pool = ThreadPoolExecutor(max_workers=6)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/upscale"
        for n in (None, None, None, None, 8):
            lr, z = sample(rng, 1 if n is None else n, lr_xy, hr_xy, zl, C)
            if n is None:
                lr, z = lr[0], z[0]
            buf = io.BytesIO()
            np.savez(buf, lr=lr, z=z)
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
                if resp.status != 200:
                    fail(f"HTTP {resp.status}")
                out = np.load(io.BytesIO(resp.read()))["sr"]
            outs.extend([out] if n is None else list(out))
        lr, z = sample(rng, 6, lr_xy, hr_xy, zl, C)
        futs = [pool.submit(srv.batcher.submit, lr[i], z[i], TIMEOUT_S)
                for i in range(6)]
        outs.extend(f.result(timeout=TIMEOUT_S + 30) for f in futs)
        stats = srv.batcher.stats_snapshot()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        srv.close()
    serve_launches, head_launches = counters()[0], counters()[4]
    log(f"served {len(outs)} samples in {stats['batches']} batches "
        f"(max batch {stats['max_batch_seen']}, errors {stats['errors']}); "
        f"trunk kernel launches {serve_launches}, head kernel launches "
        f"{head_launches}")
    if head_launches != serve_launches:
        fail("milestone9k as committed did not launch the head kernel once "
             "a served batch")
    for o in outs:
        if o.shape != (hr_xy, hr_xy, zl, 3) or not np.isfinite(o).all():
            fail(f"bad output: shape {o.shape}, "
                 f"finite {bool(np.isfinite(o).all())}")
    if len(outs) != 18 or serve_launches < 1 or stats["errors"]:
        fail(f"{len(outs)} outputs, {serve_launches} kernel launches, "
             f"{stats['errors']} batch errors")

    lr, z = sample(rng, 8, lr_xy, hr_xy, zl, C)
    lr_d, z_d = torch.from_numpy(lr).to(dev), torch.from_numpy(z).to(dev)
    got = torch.from_numpy(sr.upscale(lr, z))
    with torch.inference_mode():
        want = generator_forward(
            sr.G, lr_d, z_d,
            lambda f: rrdb_trunk_reference(sr.packed, f.contiguous(), **geom),
        ).cpu()
    err_srv = rel_l2(got, want)
    log(f"serving output, kernel trunk vs plain trunk: rel L2 {err_srv:.3e} "
        f"(tol 3e-2)")
    if not err_srv <= 3e-2:
        fail(f"served output disagrees with the plain trunk: {err_srv:.3e}")

    # the head path as committed, one batch of 8 against the module head
    lr, z = sample(np.random.default_rng(2002), 8, lr_xy, hr_xy, zl, C)
    reset_counters()
    got = sr_h.upscale(lr, z)
    head_serve = counters()
    log(f"head path: served 8 samples; launches {LAUNCH_LABELS} "
        f"{head_serve}")
    if head_serve != (1, 0, 0, 0, 1):
        fail(f"the head path's serving launched {head_serve}")
    if got.shape != (8, hr_xy, hr_xy, zl, 3) or not np.isfinite(got).all():
        fail(f"bad head-path output: shape {got.shape}")
    err_head_srv = rel_l2(torch.from_numpy(got),
                          torch.from_numpy(sr.upscale(lr, z)))
    check("served output, head kernel vs module head", err_head_srv, 3e-2)

    # ------------------------------------------------------------ 5. train
    phase_start(5)
    gan, state, batch, train_launches, p5_steps = train_phase(
        copy.deepcopy(cfg), dev, rng, card)
    done("the G-step comparison and four steps")
    head_train_phase(cfg, gan, state, batch, dev, card)
    # the head path is the committed one
    gan_h, state_h, head_train = gan, state, train_launches

    # ------------------------------------------------------------ 6. times
    phase_start(6)
    xb = torch.randn(8, lr_xy, lr_xy, zl, nf, generator=gen).to(
        dev, torch.bfloat16)
    kw = dict(geom)
    plain_ms = cuda_ms(lambda: rrdb_trunk_reference(sr.packed, xb, **kw))
    lib_w = []
    for r in sr.G.rrdbs:
        for rdb in r.rdbs:
            lib_w.append((
                [c.weight.detach().to(torch.bfloat16) for c in rdb.convs],
                rdb.lff.weight.detach().to(torch.bfloat16),
                rdb.lff.bias.detach().to(torch.bfloat16),
            ))
    with torch.inference_mode():
        turns = alternate(lambda: rrdb_trunk(sr.packed, xb, **kw),
                          lambda: cudnn_trunk(lib_w, xb))
        fwd_ms = cuda_ms(lambda: sr._generate(lr_d, z_d))
    log_turns("trunk kernel at batch 8 vs its bf16 cuDNN chain", turns, card)
    ms, lib_ms = turns[:2]
    with torch.inference_mode():
        kernel_split("trunk kernel at batch 8, by kernel",
                     lambda: rrdb_trunk(sr.packed, xb, **kw), card)
    vox = 8 * hr_xy * hr_xy * zl
    log(f"trunk kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN bf16 "
        f"chain {lib_ms:.3f} ms per batch-8 forward ({card})")
    log(f"serving forward {fwd_ms:.3f} ms per batch of 8, "
        f"{vox / (fwd_ms / 1e3):.4e} HR voxels/s ({card})")
    for name, stage_ms in serving_stages(sr, lr_d, z_d, geom):
        log(f"  stage {name:<13} {stage_ms:9.3f} ms "
            f"{100 * stage_ms / fwd_ms:5.1f} % of the forward")
    rows = xb.shape[0] * lr_xy * lr_xy * zl
    J = 3 * g.num_RRDB
    K = nconv - 1
    # input and output once, the bf16 weights once
    nbytes = 2 * (2 * xb.numel()
                  + sum(t.numel() for t in sr.packed.values()))
    b1 = bound(2 * trunk_macs(rows, J, nf, gc, K), nbytes, H100_BF16_FLOPS)
    del lib_w
    log(f"trunk bound at batch 8: {b1[0]:.4f} ms by {b1[1]} (ops "
        f"{b1[2]:.4f} ms, bytes {b1[3]:.4f} ms); the kernel at "
        f"{100 * b1[0] / ms:.2f} % of it, "
        f"{H100_BF16_FLOPS * b1[2] / ms / 1e12:.1f} TFLOP/s")
    done("serving times")
    tt = time_training(gan, state, batch, geom, nf, gc, nconv, dev, card)
    done("training times")
    th = time_head(sr, sr_h, gan_h, state_h, batch, lr_d, z_d, head_dims,
                   dev, card)
    del sr, sr_h
    if not all(math.isfinite(v) for v in (ms, plain_ms, lib_ms, fwd_ms)):
        fail("a timing is not finite")

    # ------------------------------------------------------------- 7. loop
    phase_start(7)
    del gan, state, gan_h, state_h, batch
    torch.cuda.empty_cache()
    t = time.monotonic()
    leg_data.result()
    waited = time.monotonic() - t
    procs = start_clis(tmp)
    packs = PackMemo()
    ll, state, ckpt_path, leg_ms = loop_phase(dev, card, tt, tmp, leg_data,
                                              waited)
    # ----------------------------------------------------- 8. test, use, serve
    phase_start(8)
    ev = eval_phase(dev, card, tmp, state, ckpt_path, packs)
    del state
    torch.cuda.empty_cache()
    # ------------------------------------- 9. chunks, host path, tiled SR
    phase_start(9)
    ch = chunk_phase(dev, card, tmp, leg_ms, ev.pop("field"))
    # ---------------------------- 10. int8 serving, export, interpolation
    phase_start(10)
    dp = deploy_phase(dev, card, tmp, built, procs)
    # ----------------- 11. .pth files, 8x and 16x, the search, bf16 Adam
    phase_start(11)
    rf = reference_phase(dev, card, tmp, tt["g_ms"])
    # ------------------ 12. conv_mode horizontal_3D, D's instance norm
    phase_start(12)
    resident = rf.pop("resident")
    # phase 13's processes start here, their start-up beside phase 12; from
    # here on several processes share the card, and this one keeps to its
    # share of it (the others' card work waits for flags from it)
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(MAIN_CARD_SHARE, dev)
    started = mesh_start(dev, card, tmp, resident)
    started_sp = spatial_inputs(dev, tmp, resident)
    spatial_launch(started_sp)
    hz = horizontal_phase(dev, card, tmp, resident,
                          dict(g_ms=tt["g_ms"], d_ms=tt["d_ms"],
                               fwd_ms=fwd_ms))
    # ------------------------------------------------- 13. the data mesh
    phase_start(13)
    # phase 14's one-process references first, alone on the card; then
    # the two and the eight processes take the card, their models built
    # beside phase 13's untimed work, and phase 13's timed steps wait for
    # the eight to be ready
    ref_sp = spatial_reference(dev, started_sp)
    done("phase 14's one-process references")
    ref_model = model_reference(dev, started, p5_steps)
    done("phase 13 (e)'s one-process references")
    open(os.path.join(tmp, "mesh_card"), "w").close()
    mp_ = mesh_phase(dev, card, tmp, started, p5_steps, ref_model,
                     settle=lambda: spatial_ready(started_sp))
    del resident, started
    # --------------------------------------- 14. the spatial axis, fullvol
    phase_start(14)
    sp = spatial_phase(dev, card, tmp, started_sp, ref_sp)
    # ------------------------- 15. raw HARMONIE-SIMRA files, no --synthetic
    # once phase 14's ranks have ended, alone on the card
    for proc in started_sp["ctx"].processes:
        proc.join(120)
        if proc.exitcode != 0:
            fail(f"a rank of phase 14 ended {proc.exitcode}")
    del started_sp, ref_sp
    phase_start(15)
    # phase 16's processes import torch and the port beside phase 15
    warm = os.path.join(tmp, "supervised_legs")
    start_warm(warm)
    rd = real_data_phase(dev, card, tmp)
    packs.close()
    log(f"the 6k pack read from disk {len(packs.reads)} time(s) in phases 7 "
        f"to 15")
    if len(packs.reads) != 1:
        fail("the 6k pack was read from disk more than once")
    # --------------------------- 16. the supervised long run, SIGTERM, resume
    phase_start(16)
    sv = supervised_phase(dev, card, tmp, warm)

    def row(name, src, replaces, launches, err, t, lib, **extra):
        return {"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
                "replaces": f"{TPU}/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2][0], "bound_by": t[2][1], "library_ms": lib,
                **extra}

    tl = train_launches
    # phase 9's launches: the chunked leg (replays counted), the host data
    # path leg and the tiled SR
    cl = tuple(a + b + c for a, b, c in zip(ch["chunk"], ch["host"],
                                            ch["tiled"]))
    # phase 11's launches: the .pth files served at 8x and 16x, --test and
    # --train at 8x, the search, the bf16-moment legs
    rl = rf["total"]
    # phase 12's launches: the horizontal steps and validation, and its
    # chunk of two steps
    hl = tuple(a + b for a, b in zip(hz["steps"], hz["chunk"]))
    # phase 13's launches in this process: (b)'s steps and val_step on the
    # mesh of one; (a)'s torchrun process and (c)'s two ranks count their
    # own
    ml = mp_["launches"]
    # phase 15's launches: the leg on the raw files' cache and its --test
    # (kernels 1 to 5, then conv_int8's, which stays 0)
    fl = rd["launches"]
    # phase 16's launches, in each supervised leg's own process
    sl = sv["launches"]

    def mesh_keys(i):
        # launches_model: the model-mesh ranks' own counts, phase 13 (e)'s
        # two and phase 14 (d)'s eight (kernels 1, 2 and 5 off there)
        return dict(launches_supervised_legs=[leg[i] for leg in sl],
                    launches_mesh=ml[i], launches_mesh_ranks=[
            r[i] for r in mp_["rank_launches"]], launches_model={
                "phase13e_ranks": [r[i] for r in mp_["model_launches"]],
                "phase14d_ranks": [r[i] for r in sp["launches_model"]]})
    table = {"kernels": [
        row("rrdb_trunk", "rdb_trunk.cu", "rdb_trunk.py:178",
            serve_launches + tl[0] + ll[0] + ev["trunk"] + cl[0] + rl[0]
            + ml[0] + fl[0], max_abs16, (ms, plain_ms, b1), lib_ms,
            **mesh_keys(0), launches_real_data=fl[0],
            launches_serve=serve_launches, launches_reference=rl[0],
            max_abs_err_reference=rf["max_abs_err"][0],
            serving_8x_b8_ms=rf["fwd_ms"][8],
            serving_16x_b1_ms=rf["fwd_ms"][16],
            g_step_8x_b8_ms=rf["g8_ms"], search_trial_s=rf["trial_s"],
            g_step_bf16_moments_ms=rf["sr_g_ms"],
            launches_train=tl[0], launches_loop=ll[0],
            launches_test=ev["trunk"], launches_chunks=ch["chunk"][0],
            launches_host_path=ch["host"][0], launches_tiled=ch["tiled"][0],
            generate_field_ms=ev["ms_module_head"],
            tiled_512_ms=ch["tiled_ms"],
            residual_ms=tt["k1r"][0], residual_plain_ms=tt["k1r"][1],
            residual_bound_ms=tt["k1r"][2][0],
            residual_library_ms=tt["k1r_lib"], mma=TC_MMA["rdb_trunk"],
            sass_mma_count=mma_counts["rdb_trunk"]),
        row("rrdb_trunk_bwd", "rdb_trunk_bwd.cu", "rdb_trunk.py:429",
            tl[1] + ll[1] + cl[1] + rl[1] + ml[1] + fl[1], max_abs_bwd,
            tt["k2"][:3], tt["k2"][3], **mesh_keys(1),
            launches_real_data=fl[1], launches_train=tl[1],
            launches_loop=ll[1],
            launches_reference=rl[1],
            max_abs_err_reference=rf["max_abs_err"][1],
            launches_chunks=ch["chunk"][1], launches_host_path=ch["host"][1],
            mma=TC_MMA["rdb_trunk_bwd"],
            sass_mma_count=mma_counts["rdb_trunk_bwd"]),
        *(row(name, "stencil.cu", replaces,
              tl[i] + ll[i] + cl[i] + rl[i] + hl[i] + ml[i] + fl[i],
              err, (k["ms"], k["plain_ms"], k["bound"]), None, **mesh_keys(i),
              launches_real_data=fl[i],
              launches_train=tl[i], launches_loop=ll[i],
              launches_reference=rl[i], launches_horizontal=hl[i],
              horizontal_g_step_ms=hz["g_ms"],
              horizontal_d_step_ms=hz["d_ms"],
              max_abs_err_reference=rf["max_abs_err"][i],
              launches_chunks=ch["chunk"][i],
              launches_host_path=ch["host"][i],
              launches_spatial=sp["launches_spatial"][i - 2],
              device_ms=k["device_ms"], device_ms_cold=k["device_ms_cold"])
          for name, replaces, i, err, k in (
              ("wind_gradient", "stencil.py:78", 2, err_grad, tt["k3"]),
              ("wind_gradient_adjoint", "stencil.py:166", 3, err_adj,
               tt["k4"]))),
        row("hr_head", "hr_head.cu", "hr_head.py:122",
            head_launches + head_serve[4] + head_train[4] + ll[4]
            + ev["head"] + cl[4] + rl[4] + ml[4] + fl[4], err_head,
            th[8][:3], th[8][3], **mesh_keys(4), launches_real_data=fl[4],
            launches_serve=head_launches + head_serve[4],
            launches_reference=rl[4],
            launches_train=head_train[4], launches_loop=ll[4],
            launches_test=ev["head"], launches_tiled=ch["tiled"][4],
            generate_field_ms=ev["ms_head_kernel"],
            tiled_512_ms=ch["tiled_head_ms"],
            ms_b32=th[32][0], plain_ms_b32=th[32][1],
            bound_ms_b32=th[32][2][0], library_ms_b32=th[32][3],
            library_ms_benchmark_off=th[8][4],
            library_ms_benchmark_on=th[8][5],
            library_ms_b32_benchmark_off=th[32][4],
            library_ms_b32_benchmark_on=th[32][5],
            backward_library_ms_b32=th["vjp"], mma=TC_MMA["hr_head"],
            sass_mma_count=mma_counts["hr_head"]),
        # the port's own kernels: the JAX package's int8 convs are XLA
        *(int8_row(name, dp, replaces, launches_real_data=fl[5],
                   launches_supervised_legs=[leg[5] for leg in sl], **extra)
          for name, replaces, extra in (
            ("conv_int8_head_pair", "quant.py:87", dict(
                library="bf16 cuDNN hr_conv0_x, the conv the pair replaces",
                ms_b32=dp["kernels"]["pair_b32"][0],
                plain_ms_b32=dp["kernels"]["pair_b32"][1],
                bound_ms_b32=dp["kernels"]["pair_b32"][2][0],
                library_ms_b32=dp["kernels"]["pair_b32"][3],
                kernel5_ms=dp["kernels"]["k5"],
                kernel5_ms_b32=dp["kernels"]["pair_b32"][4],
                serving_ms={f"{name} b{n}": ms for (name, n), ms
                            in dp["serve_ms"].items()},
                artifact_ms=dp["artifact_ms"],
                kernel_path_ms=dp["kernel_path_ms"])),
            ("conv_int8_requant", "quant_trunk.py:78", {}),
            ("conv_int8", "quant_trunk.py:78", dict(
                library="torch._int_mm (cuBLASLt int8 GEMM, int32 out) on "
                        "the LFF's operands")))),
    ]}
    log(f"total {time.monotonic() - T0:.1f} s")
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--stencils-of":
        stencils_of(sys.argv[2])
    elif len(sys.argv) > 3 and sys.argv[1] == "--supervised-leg":
        supervised_runner(sys.argv[2], sys.argv[3:])
    elif len(sys.argv) == 4 and sys.argv[1] == "--warm":
        warm_process(sys.argv[2], sys.argv[3])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--stencils-of ROOT]")
    else:
        main()
