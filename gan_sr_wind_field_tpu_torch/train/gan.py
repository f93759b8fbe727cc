"""WindFieldGAN — the 3D ESRGAN trainer core, one training step at a time.

Counterpart of ``gan_sr_wind_field_tpu/train/gan.py``:

- the G/D alternation ``(it // d_g_train_period) % (ratio + 1) == 0``,
  label ramps, annealed instance noise, the physics losses with their
  global-max normalisation, Adam with the multistep schedule and the
  skip-update-on-non-finite-loss guard of the G step;
- relativistic-average BCE losses with the ``-0.1985`` D-loss bias when
  the one-sided-smoothed labels are exactly 0.9; physics terms dropped
  from the total on NaN/Inf; the signed-max z-gradient factor; instance
  noise σ=2 for the G step's D forwards and σ=1 for the D step's;
- an EMA of G with the warmup decay ``min(d, (1+n)/(10+n))`` over the
  G-step count n.

Parameters are held outside the modules: ``GANTrainState`` keeps plain
dicts of float32 tensors (and the discriminator's running statistics), and
the models run on them through ``torch.func.functional_call``. Unlike the
JAX package, whose arrays are immutable, ``train_step`` and ``val_step``
update the state's tensors in place and return the same state. Randomness
(augmentation, dropout masks, instance noise, noisy labels) comes from the
state's ``torch.Generator``; it differs from JAX's draws for the same seed.

A step is host work (``_begin_step``: the iteration's schedules written
into 0-d device tensors, the feature-D refresh) and device work
(``_step``): tensor ops only, every state update in place, no host sync,
so that ``train_chunk`` can capture it as a CUDA graph
(``train/step_graphs.py``) and replay it. A non-finite G loss selects the
old parameters, Adam moments and count with ``torch.where``, as the JAX
step does.

With ``use_fused_trunk`` (and a LeakyReLU slope > 0) the G step's trunk
runs as the trunk kernel with residuals and the backward kernel
(``models/fused_train.py``), and the D step's G forward as the trunk
kernel. hr_conv0 runs as the HR-head kernel (``ops/hr_head.py``) where
``models/generator.py:choose_head`` says: on the card in bf16 in every G
forward wherever its tensor-core tile fits, on the CPU and in float32 as
the head flags say (``use_pallas_head`` every G forward,
``use_pallas_head_nograd`` those without a gradient: the D step,
validation, ``generate``). The port has no rematerialisation:
``use_remat`` is read but changes nothing here. With
``use_pallas_stencil`` the physics gradients run as the stencil kernel
and its adjoint (``ops/stencil.py``). On a CUDA device the constructor
builds the kernels the configuration needs.

On a data mesh (``parallel/mesh.py``, ``WindFieldGAN(mesh=)``) every
step method takes this rank's rows of the global batch. Each loss term is
this rank's share of the batch's mean (its rows' terms over the global
count), so the gradients summed over the group (one flat all_reduce per
model a step) are the global loss's. The relativistic-average means of
D's logits, the physics factors' maxima and D's batch statistics in train
mode are group-wide (``parallel/collectives.py``), and every batch-shaped
draw is made at the global batch's shape and cut to the rows, so the step
is the one-process step on the global batch. The metrics are the
batch's, the same on every rank. The kernels run on each rank's rows.

On a mesh with a spatial axis every step method still takes this rank's
rows, whole in x: the step augments them (rot90 mixes x and y, so it
cannot run on a slab) and then cuts this rank's x slab. G runs on slabs,
every conv with its x halo (``parallel/halo.py``); D runs on slabs until
they stop halving evenly and then on the gathered copy
(``models/discriminator.py``); the physics gradients run on slabs widened
by one plane (``ops/physics.py:gradient_on_slab``). Every loss share is the
rank's sum over the local count times the mesh's ranks: per-voxel terms
then sum to the volume's mean, and the per-sample terms after D's gather,
which each rank of a data row holds a copy of, to the batch's, each rank
carrying 1/s of its rows' share (``gather_x``'s backward returns each slab
the whole cotangent). The relativistic-average means are over the data
group (the ranks of one slab), the gradients, maxima, batch statistics and
metrics over the mesh, and instance noise is drawn at the global batch's
whole shape and cut to the rows and the slab. As JAX's ``dp_only`` rule
says, the trunk and HR-head kernels stay off there whatever the flags say
(a halo per conv cannot enter one fused launch); the stencil kernels run
on the widened slabs.

On a mesh with a model axis (``parallel/model.py``) the state's G
parameters, EMA and Adam moments hold this rank's output channels of each
leaf JAX shards (``shard_state``; ``state.sharded`` names them), and every
sharded conv gathers its output over the model group, so D, the physics
and the loss run whole and replicated on every model rank: a model rank
is a replica of its model index's loss, not a share of it. The sharded
leaves' gradients are summed over the model index's ranks (data ×
spatial); the replicated leaves' (D, hr_conv1) over the whole mesh and
divided by the model axis's size, so that they stay equal bit for bit on
every rank (each model rank computes them from the same bits, but cuDNN's
float32 backward of D is not reproducible from one process to another
on the card). The global gradient norm (clipping, ``G_grad_norm``) sums
the sharded leaves' squares over the model group and counts the others once,
and a stochastically rounded moment draws its bits at the whole leaf's
shape and keeps its channels, so the step is the one-process step. The
trunk and HR-head kernels stay off there too, as ``dp_only`` says; the
stencil kernels run on every model rank.

``conv_mode = "horizontal_3D"`` (both models, from ``[GAN]``, as in the
JAX package) runs G on its modules: the trunk and head kernels need "3D"
(``trunk_fusable``), so ``use_fused_trunk`` and the head flags fall off,
and the stencil kernels stay under ``use_pallas_stencil``. A D with
instance norm has no running statistics but its slicing head's, and none
at all without slicing: ``batch_stats_D`` is then empty.

A step's phases are spans (``utils/spans.py``; off unless enabled or a
profiler runs): ``train.step`` (attribute ``kind``, G or D) around
``train.begin``, ``train.augment`` and, on a G step, ``G.losses``,
``G.grad``, ``G.adam`` and ``G.ema``, on a D step ``D.forward_G``,
``D.losses``, ``D.grad`` and ``D.adam``.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from gan_sr_wind_field_tpu_torch.data.augment import (
    augment_batch_with,
    augment_draws,
)
from gan_sr_wind_field_tpu_torch.data.device_data import batch_at
from gan_sr_wind_field_tpu_torch.device import resolve_device
from gan_sr_wind_field_tpu_torch.models.blocks import _draw_keep
from gan_sr_wind_field_tpu_torch.models.discriminator import Discriminator3D
from gan_sr_wind_field_tpu_torch.models.generator import (
    _act_slope,
    build_generator,
    choose_head,
    empty_generator,
)
from gan_sr_wind_field_tpu_torch.ops import sr_cast
from gan_sr_wind_field_tpu_torch.ops.kernels import build
from gan_sr_wind_field_tpu_torch.ops.metrics import psnr_from_mse
from gan_sr_wind_field_tpu_torch.ops.physics import (
    divergence_3d,
    divergence_xy,
    gradient_norm_factors,
    gradient_on_slab,
    wind_field_gradient,
)
from gan_sr_wind_field_tpu_torch.ops.rdb_trunk import trunk_fusable
from gan_sr_wind_field_tpu_torch.ops.resize import upsample_trilinear_xy
from gan_sr_wind_field_tpu_torch.ops.stencil import WindFieldGradient
from gan_sr_wind_field_tpu_torch.parallel.collectives import (
    all_reduce_flat,
    group_mean,
)
from gan_sr_wind_field_tpu_torch.parallel.halo import gather_x, x_window
from gan_sr_wind_field_tpu_torch.parallel.model import (
    sharded_keys,
    sharded_sq_norm,
)
from gan_sr_wind_field_tpu_torch.train import tricks
from gan_sr_wind_field_tpu_torch.train.schedule import (
    label_values,
    multistep_lr,
)
from gan_sr_wind_field_tpu_torch.utils import spans
from gan_sr_wind_field_tpu_torch.utils.jax_params import (
    d_params_from_jax,
    params_from_jax,
)

Params = Dict[str, torch.Tensor]

_LOSS_KEYS = ("total", "adversarial", "pix", "xy_gradient", "z_gradient",
              "divergence", "xy_divergence", "feature_D")


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mean=torch.mean):
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss);
    ``mean`` takes the mean (a rank's share of it on a mesh)."""
    return mean(torch.clamp_min(logits, 0.0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))


@dataclass
class AdamState:
    """optax ``scale_by_adam`` state: the step count (a 0-d int32 tensor on
    the parameters' device, updated in place) and both moments."""
    count: torch.Tensor
    mu: Params
    nu: Params


@dataclass
class GANTrainState:
    params_G: Params
    params_D: Params
    batch_stats_D: Params
    params_D_frozen: Params  # frozen feature extractor ({} if unused)
    opt_state_G: AdamState
    opt_state_D: AdamState
    it: int  # completed iterations
    rng: torch.Generator
    params_G_ema: Optional[Params] = None
    # the keys of params_G whose leaves (and EMA and Adam moments) hold
    # this rank's output channels only (shard_state on a model axis)
    sharded: frozenset = frozenset()


def _clone(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


def _adam_init(params: Params, dtype: torch.dtype = torch.float32
               ) -> AdamState:
    """Adam's count at 0 and both moments at zero in ``dtype`` (float32,
    or bfloat16 under ``optimizer_state_dtype = "bfloat16_sr"``)."""
    dev = next(iter(params.values())).device if params else None
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=dev),
        {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()},
        {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()})


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _round_bf16(m: torch.Tensor, gen, channels=None) -> torch.Tensor:
    """``m`` stochastically rounded to bf16 with draws from ``gen``; with
    ``channels`` (m holds this rank's output channels of a leaf) the bits
    are drawn at the whole leaf's shape and cut, as one process draws
    them."""
    if channels is None:
        return sr_cast.stochastic_round_bf16(m, gen)
    shape = list(m.shape)
    shape[0] *= channels.size
    bits = sr_cast.draw_bits16(m, gen, shape=shape)
    return sr_cast.stochastic_round_bf16_with(m, channels.cut(bits))


class WindFieldGAN:
    """Builds the models from a Config and runs the training steps.

        gan = WindFieldGAN(cfg, x, y)                # on the card
        state = gan.init_state(seed, lr_shape, hr_shape)
        state, metrics = gan.train_step(state, lr, hr, z)
        metrics, batch_stats = gan.val_step(state, lr, hr, z)
        sr = gan.generate(state, lr, z)

    ``x`` and ``y`` are the HR grid's coordinate vectors; lr, hr and z are
    channels-last (N, X, Y, Zl, C) tensors or arrays. With ``mesh``
    (``parallel.make_mesh``; not an idle rank's) they are this rank's rows
    of the global batch, whose size is the rows times the data axis's,
    whole in x also on a spatial axis (the step cuts the slab). The LR x
    extent, ``len(x) / scale``, must divide over a spatial axis.
    """

    def __init__(self, cfg, x, y, device=None, mesh=None):
        if mesh is not None and mesh.idle:
            raise ValueError("an idle rank of the mesh runs no step")
        self.mesh = mesh
        t = cfg.training
        g = cfg.gan_config
        moments = getattr(t, "optimizer_state_dtype", "float32")
        if moments not in ("float32", "bfloat16_sr"):
            raise ValueError(f"unknown optimizer_state_dtype {moments!r}")
        # bfloat16_sr: both Adam states' moments held in bf16, cast back
        # after each update by stochastic rounding (ops/sr_cast.py)
        self.moment_dtype = (torch.bfloat16 if moments == "bfloat16_sr"
                             else torch.float32)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        # the module whose forward every G step runs on a state's weights
        # (functional_call): its own are never drawn
        self.G = empty_generator(cfg, self.device)
        # D is built by init_state / state_from_jax, which know the HR shape
        self.D = None
        self.x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        self.niter = float(t.niter)
        spatial = 1 if mesh is None else mesh.spatial
        model = 1 if mesh is None else mesh.model
        if len(self.x) // cfg.scale % spatial:
            raise ValueError(
                f"an LR x extent of {len(self.x) // cfg.scale} does not "
                f"divide over a spatial axis of {spatial} (GSPMD would pad; "
                "the port does not)")

        self.gan_type = t.gan_type
        self.d_g_train_ratio = t.d_g_train_ratio
        self.d_g_train_period = t.d_g_train_period
        self.pixel_criterion = (t.pixel_criterion or "none").lower()
        self.use_instance_noise = t.use_instance_noise
        self.use_noisy_labels = t.use_noisy_labels
        self.use_one_sided_label_smoothing = t.use_one_sided_label_smoothing
        self.flip_labels = t.flip_labels
        self.use_feature_D = g.use_D_feature_extractor_cost
        self.feature_D_update_period = t.feature_D_update_period
        self.w_adv = t.adversarial_loss_weight
        self.w_feat = t.feature_D_loss_weight
        self.default_weights = {
            "pix": t.pixel_loss_weight, "gxy": t.gradient_xy_loss_weight,
            "gz": t.gradient_z_loss_weight, "div": t.divergence_loss_weight,
            "xydiv": t.xy_divergence_loss_weight,
        }
        self.use_adv = (self.w_adv != 0.0) or (t.d_g_train_ratio > 0)

        # the trunk kernels need a slope > 0 (the backward reads the sign
        # from the growths) and a geometry the kernels cover
        G = self.G
        # on a model axis the convs whose leaves JAX shards run on this
        # rank's output channels and gather the rest
        self._sharded = (sharded_keys(dict(G.named_parameters()), model)
                         if model > 1 else frozenset())
        G.shard_channels(None if mesh is None else mesh.channels(),
                         self._sharded)
        # JAX's dp_only: on a model or spatial axis the trunk and head
        # kernels stay off (a halo or a channel gather per conv cannot
        # enter one fused launch)
        if spatial > 1 or model > 1:
            logging.getLogger("status").info(
                f"model axis of {model}, spatial axis of {spatial}: the "
                "trunk kernels and the HR-head kernel are off whatever "
                "use_fused_trunk and the head flags say; the stencil "
                "kernels run on every rank"
                + (" on haloed slabs" if spatial > 1 else ""))
        self.use_fused_trunk = (
            spatial == 1 and model == 1
            and getattr(cfg, "use_fused_trunk", False)
            and G.negative_slope > 0
            and trunk_fusable(G.num_rdb_convs, G.lff_kern_size, g.conv_mode)
        )
        self._trunk = "kernel" if self.use_fused_trunk else "modules"
        head = choose_head(cfg, self.device, mesh)
        self._head_train, self._head_nograd = head.train, head.nograd
        logging.getLogger("status").info(head.status())
        fused = self.use_fused_trunk
        use_stencil = getattr(cfg, "use_pallas_stencil", False)
        self._wind_gradient = (WindFieldGradient.apply if use_stencil
                               else wind_field_gradient)
        if self.device.type == "cuda":  # the first step pays no build
            build.warm(
                (["rdb_trunk", "rdb_trunk_bwd"] if fused else [])
                + (["stencil"] if use_stencil else [])
                + (["hr_head"] if self._head_nograd == "kernel" else []))

        if self.gan_type not in ("relativistic", "relativisticavg"):
            raise NotImplementedError(
                f"Only relativistic and relativisticavg GAN are implemented, "
                f"not {self.gan_type}")
        if self.pixel_criterion not in ("l1", "l2", "none"):
            raise NotImplementedError(
                f"Only l1 and l2 pixel losses are implemented, "
                f"not {self.pixel_criterion}")

        self.clip_norm = (cfg.generator.max_norm
                          if getattr(t, "use_grad_clipping", False) else None)
        self.ema_decay = float(getattr(t, "g_ema_decay", 0.0))
        self.opt_G = (t.adam_beta1_g, t.adam_weight_decay_g)
        self.opt_D = (t.adam_beta1_d, t.adam_weight_decay_d)
        if t.multistep_lr and t.multistep_lr_steps:
            self.lr_G = multistep_lr(t.learning_rate_g, t.multistep_lr_steps,
                                     t.lr_gamma, t.d_g_train_period)
            self.lr_D = multistep_lr(t.learning_rate_d, t.multistep_lr_steps,
                                     t.lr_gamma, t.d_g_train_period)
        else:
            self.lr_G = lambda it: float(np.float32(t.learning_rate_g))
            self.lr_D = lambda it: float(np.float32(t.learning_rate_d))
        # the schedules' values at the step's iteration, written on the
        # host before each step (_set_iteration); a graph reads them
        self._sc = {k: torch.zeros((), device=self.device) for k in
                    ("lr_G", "lr_D", "real_label", "fake_label", "noise_G",
                     "noise_D", "ema")}
        self._graphs = None  # train_chunk's CUDA graphs (step_graphs.py)

    # ------------------------------------------------------------ state
    def _build_D(self, hr_shape, seed: int = 0) -> Discriminator3D:
        cfg, d = self.cfg, self.cfg.discriminator
        D = Discriminator3D(
            in_channels=d.in_num_ch, base_features=d.num_features,
            feat_kern_size=d.feat_kern_size, norm=d.norm_type,
            number_of_z_layers=cfg.gan_config.number_of_z_layers,
            enable_slicing=cfg.gan_config.enable_slicing,
            dropout_probability=d.dropout_probability,
            init_scale=d.weight_init_scale, dtype=self.dtype,
            conv_mode=cfg.gan_config.conv_mode,
            negative_slope=_act_slope(d.act_type),
            spatial=tuple(hr_shape[1:3]),
            generator=torch.Generator().manual_seed(seed),
        ).to(self.device)
        if self.mesh is not None:
            D.sync_batch_norm(self.mesh.group)
        return D

    def _new_state(self, params_G: Params, D: Discriminator3D, it: int,
                   seed: int, params_G_ema: Optional[Params] = None
                   ) -> GANTrainState:
        self.D = D
        params_D = _clone(dict(D.named_parameters()))
        return GANTrainState(
            params_G=params_G,
            params_D=params_D,
            batch_stats_D=_clone(dict(D.named_buffers())),
            params_D_frozen=_clone(params_D) if self.use_feature_D else {},
            opt_state_G=_adam_init(params_G, self.moment_dtype),
            opt_state_D=_adam_init(params_D, self.moment_dtype),
            it=it,
            rng=torch.Generator(device=self.device).manual_seed(seed),
            params_G_ema=(params_G_ema if params_G_ema is not None
                          else _clone(params_G) if self.ema_decay > 0.0
                          else None),
        )

    def init_state(self, seed: int, lr_shape, hr_shape) -> GANTrainState:
        """Fresh parameters and optimizer state, drawn from ``seed``; the
        shapes are (N, x, y, z, C) of an LR and an HR batch."""
        G = build_generator(self.cfg, seed).to(self.device)
        return self._new_state(_clone(dict(G.named_parameters())),
                               self._build_D(hr_shape, seed + 1), 0, seed + 2)

    def state_from_jax(self, jax_state, hr_shape, seed: int = 0
                       ) -> GANTrainState:
        """A state from the JAX package's ``GANTrainState``: G and D
        parameters, D's batch statistics, the EMA and the frozen feature
        extractor where present, and ``it``. The Adam moments start at
        zero."""
        def to_dev(sd):
            return {k: v.to(self.device) for k, v in sd.items()}

        D = self._build_D(hr_shape)
        D.load_state_dict(d_params_from_jax(jax_state.params_D,
                                            jax_state.batch_stats_D))
        ema = getattr(jax_state, "params_G_ema", None)
        state = self._new_state(
            to_dev(params_from_jax(jax_state.params_G)), D,
            int(np.asarray(jax_state.it)), seed,
            None if ema is None else to_dev(params_from_jax(ema)))
        if self.use_feature_D and jax_state.params_D_frozen:
            state.params_D_frozen = to_dev(d_params_from_jax(
                jax_state.params_D_frozen))
        return state

    # ----------------------------------------------------------- models
    def _as_input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _g_apply(self, params: Params, lr, z, **kw) -> torch.Tensor:
        return functional_call(self.G, params, (lr, z),
                               dict(kw, slab=self._slab))

    def _d_apply(self, params: Params, stats: Params, x, **kw):
        return functional_call(self.D, {**params, **stats}, (x,),
                               dict(kw, slab=self._slab))

    def _g_forward_nograd(self, params_G: Params, lr, z) -> torch.Tensor:
        """Eval-mode G forward, no gradient: the trunk kernel if enabled,
        the HR-head kernel where ``choose_head`` puts it."""
        with torch.no_grad():
            return self._g_apply(params_G, lr, z, trunk=self._trunk,
                                 head=self._head_nograd)

    def _g_forward_train(self, params_G: Params, lr, z, train: bool,
                         gen: torch.Generator, dropout_mask=None):
        head = (self._head_train if torch.is_grad_enabled()
                else self._head_nograd)
        p = self.G.dropout_probability
        if (self.mesh is not None and train and p > 0.0
                and dropout_mask is None):
            dropout_mask = self._keep_rows(lr.shape[0], self.G.hr_features,
                                           p, gen)
        return self._g_apply(
            params_G, lr, z, train=train, trunk=self._trunk, head=head,
            dropout_mask=dropout_mask, generator=gen)

    def generate(self, state: GANTrainState, lr, z) -> torch.Tensor:
        """SR of an LR batch with the state's G: float32 (N, X, Y, Zl, 3).
        On a spatial axis G runs on this rank's slab and every rank of the
        data row gets its rows whole; on a model axis every model rank gets
        them whole."""
        self._placed(state)
        lr, z = self._cut(self._as_input(lr), self._as_input(z))
        sr = self._g_forward_nograd(state.params_G, lr, z)
        return sr if self._slab is None else gather_x(sr, self._slab)

    def generate_quantized(self, params_G: Params, qhead, lr, z,
                           qtrunk=None) -> torch.Tensor:
        """Serving forward of ``params_G`` with the calibrated int8 HR head
        (``ops/quant.py``) and/or int8 trunk (``ops/quant_trunk.py``), as
        ``WindFieldSR.quantize[_trunk]`` make them. Needs the trunk-kernel
        path (``use_fused_trunk`` and a geometry the kernel takes), as JAX
        ``_generate_q`` does; raises ValueError otherwise."""
        if not self.use_fused_trunk:
            raise ValueError(
                "quantized serving needs the single-device fused-trunk "
                "path (use_fused_trunk=True, a geometry the trunk kernel "
                "takes)")
        with torch.no_grad():
            return self._g_apply(params_G, self._as_input(lr),
                                 self._as_input(z), trunk=self._trunk,
                                 qhead=qhead, qtrunk=qtrunk)

    # ------------------------------------------------------------ mesh
    @property
    def _slab(self):
        """This rank's place on the spatial axis (None without one, and
        inside ``one_process``)."""
        return None if self.mesh is None else self.mesh.slab()

    @property
    def _channels(self):
        """This rank's place on the model axis (None without one, and
        inside ``one_process``)."""
        return None if self.mesh is None else self.mesh.channels()

    def _placed(self, state: GANTrainState) -> None:
        """Raise unless ``state``'s G is cut as this trainer's mesh cuts
        it: whole without a model axis, ``shard_state``'s on one."""
        want = self._sharded if self._channels is not None else frozenset()
        if state.sharded != want:
            raise ValueError(
                "the state's G is " + ("sharded" if state.sharded else
                                       "whole")
                + " and this trainer's "
                + ("model axis shards it: shard_state(state, mesh) first"
                   if want else "G is whole: gather_state(state, mesh) "
                   "first"))

    def _cut(self, *ts):
        """This rank's x slab of each of ``ts`` (the rows whole in x)."""
        slab = self._slab
        return ts if slab is None else tuple(slab.cut(t) for t in ts)

    def _gradient(self, uvw, z, z_window):
        """The 9-channel wind gradient of ``uvw`` on the heights ``z``; on
        a spatial axis of this rank's slab, with the heights widened by
        one plane (``z_window``)."""
        if self._slab is None:
            return self._wind_gradient(uvw, self.x, self.y, z)
        return gradient_on_slab(self._wind_gradient, uvw, self.x, self.y,
                                z_window, self._slab)

    @contextlib.contextmanager
    def one_process(self):
        """Inside, the steps run on this process's batch alone, with no
        collective, as without a mesh (the loop's validation on the first
        rank), on a whole state (``gather_state``'s on a model axis)."""
        mesh, self.mesh = self.mesh, None
        if mesh is not None and self.D is not None:
            self.D.sync_batch_norm(None)
        self.G.shard_channels(None)
        try:
            yield self
        finally:
            self.mesh = mesh
            if mesh is not None:
                self.G.shard_channels(mesh.channels(), self._sharded)
                if self.D is not None:
                    self.D.sync_batch_norm(mesh.group)

    def _n(self, rows: int) -> int:
        """The global batch of ``rows`` rows on each rank."""
        return rows if self.mesh is None else rows * self.mesh.size

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, drawn at the global batch's shape."""
        return t if self.mesh is None else t[self.mesh.rows(t.shape[0])]

    def _keep_rows(self, rows: int, channels: int, p: float,
                   gen: torch.Generator) -> torch.Tensor:
        """This rank's rows of a channel-dropout keep mask drawn for the
        global batch, as a module draws it for a batch of that size."""
        keep = _draw_keep((self._n(rows), 1, 1, 1, channels), p, gen,
                          self.device)
        return self._rows(keep)

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        """The batch mean of ``t`` (this rank's rows, and slab on a spatial
        axis): on a mesh this rank's share of it, its sum over the local
        count times the mesh's ranks. For a per-sample tensor that every
        rank of a data row holds a copy of (D's logits), each carries 1/s
        of its rows' share."""
        if self.mesh is None:
            return t.mean()
        return t.sum() / (t.numel() * self.mesh.world)

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The batch mean of a per-sample ``t`` (this rank's rows), the
        same value on every rank, over the data group; its gradient reaches
        every rank's rows."""
        if self.mesh is None:
            return t.mean()
        return group_mean(t, self.mesh.data_group, self._n(t.shape[0]))

    def _reduce(self, shares: dict) -> dict:
        """The ranks' shares summed (no gradient): the batch's values."""
        if self.mesh is None:
            return shares
        keys = list(shares)
        vec = torch.stack([shares[k].detach().float().reshape(())
                           for k in keys])
        torch.distributed.all_reduce(vec, group=self.mesh.group)
        return dict(zip(keys, vec.unbind()))

    # -------------------------------------------------------- schedules
    def _set_iteration(self, it: int) -> None:
        """Write the schedules' values at iteration ``it`` (learning
        rates, labels, instance-noise scales, the EMA weight) into the
        step's 0-d device tensors: ``fill_`` launches, no host sync."""
        real, fake, _, _ = label_values(
            it, self.niter, self.use_one_sided_label_smoothing,
            self.flip_labels)
        values = {"lr_G": self.lr_G(it), "lr_D": self.lr_D(it),
                  "real_label": real, "fake_label": fake,
                  "noise_G": tricks.instance_noise_scale(2.0, it, self.niter),
                  "noise_D": tricks.instance_noise_scale(1.0, it, self.niter),
                  "ema": self._ema_weight(it)}
        for k, v in values.items():
            self._sc[k].fill_(v)

    def _ema_weight(self, it: int) -> float:
        """1 − min(decay, (1 + n)/(10 + n)) over the G-step count n, in
        float32."""
        n = np.float32(max(self._n_g_steps(it), 1))
        d_eff = min(np.float32(self.ema_decay),
                    (np.float32(1.0) + n) / (np.float32(10.0) + n))
        return float(np.float32(1.0) - d_eff)

    # ----------------------------------------------------------- losses
    def _make_labels(self, batch: int, gen: torch.Generator):
        """The real and fake label vectors of a (global) batch."""
        pred_real, pred_fake = not self.flip_labels, self.flip_labels
        std = 0.05 if self.use_noisy_labels else 0.0
        kw = dict(noise_stddev=std, true_label_val=self._sc["real_label"],
                  false_label_val=self._sc["fake_label"], device=self.device,
                  generator=gen)
        return (tricks.noisy_labels(pred_real, batch, **kw),
                tricks.noisy_labels(pred_fake, batch, **kw))

    def _noisy_d_input(self, x, sigma: float, gen):
        """x plus instance noise of σ = 2 (G step) or 1 (D step) at the
        iteration ``_set_iteration`` last wrote."""
        if not self.use_instance_noise:
            return x
        scale = self._sc["noise_G" if sigma == 2.0 else "noise_D"]
        slab = self._slab
        shape = (self._n(x.shape[0]),
                 x.shape[1] * (1 if slab is None else slab.size),
                 *x.shape[2:])
        return x + self._cut(self._rows(tricks.instance_noise(
            scale, shape, device=self.device, generator=gen)))[0]

    def _g_losses(self, params_G: Params, state: GANTrainState, lr, hr, z,
                  it: Optional[int], gen: torch.Generator, train: bool,
                  w: Optional[dict] = None, dropout_mask=None):
        """Weighted G losses at iteration ``it`` (None: the one last
        written by ``_set_iteration``): (total, (losses dict, fake HR))."""
        if it is not None:
            self._set_iteration(it)
        w = w or self.default_weights
        fake = self._g_forward_train(params_G, lr, z, train, gen,
                                     dropout_mask)
        hr3 = hr[..., :3]
        zero = torch.zeros((), device=self.device)
        losses = {k: zero for k in _LOSS_KEYS}

        mean = self._mean
        if self.use_adv:
            hr_labels, fake_labels = (self._rows(v) for v in self._make_labels(
                self._n(hr.shape[0]), gen))
            # D eval-mode forwards with σ=2 instance noise
            real_in = self._noisy_d_input(hr3, 2.0, gen)
            fake_in = self._noisy_d_input(fake, 2.0, gen)
            with torch.no_grad():
                y_pred = self._d_apply(state.params_D, state.batch_stats_D,
                                       real_in, train=False)
            fake_y_pred = self._d_apply(state.params_D, state.batch_stats_D,
                                        fake_in, train=False)
            if self.gan_type == "relativistic":
                adv = bce_with_logits(fake_y_pred - y_pred, hr_labels, mean)
            else:
                adv = (bce_with_logits(fake_y_pred - self._batch_mean(y_pred),
                                       hr_labels, mean)
                       + bce_with_logits(y_pred - self._batch_mean(fake_y_pred),
                                         fake_labels, mean)) / 2.0
            losses["adversarial"] = adv * self.w_adv

        if self.use_feature_D:
            frozen = (state.params_D_frozen, state.batch_stats_D)
            with torch.no_grad():
                feats_hr = self._d_apply(*frozen, hr3, train=False,
                                         features_only=True)
            feats_fake = self._d_apply(*frozen, fake, train=False,
                                       features_only=True)
            losses["feature_D"] = (mean((feats_hr - feats_fake) ** 2)
                                   * self.w_feat)

        if self.pixel_criterion == "l1":
            losses["pix"] = mean((hr3 - fake).abs()) * w["pix"]
        elif self.pixel_criterion == "l2":
            losses["pix"] = mean((hr3 - fake) ** 2) * w["pix"]

        z_window = None if self._slab is None else x_window(z, self._slab)[0]
        hr_grad = self._gradient(hr3, z, z_window)
        sr_grad = self._gradient(fake, z, z_window)
        f_xy, f_z, f_div, f_xydiv = gradient_norm_factors(
            hr_grad, sr_grad, None if self.mesh is None else self.mesh.group)
        losses["xy_gradient"] = mean((sr_grad[..., :6] / f_xy
                                      - hr_grad[..., :6] / f_xy) ** 2
                                     ) * w["gxy"]
        losses["z_gradient"] = mean((sr_grad[..., 6:] / f_z
                                     - hr_grad[..., 6:] / f_z) ** 2
                                    ) * w["gz"]
        losses["divergence"] = mean((divergence_3d(hr_grad) / f_div
                                     - divergence_3d(sr_grad) / f_div) ** 2
                                    ) * w["div"]
        losses["xy_divergence"] = mean((divergence_xy(hr_grad) / f_xydiv
                                        - divergence_xy(sr_grad) / f_xydiv)
                                       ** 2) * w["xydiv"]
        def physics_of(terms):
            return (terms["xy_gradient"] + terms["z_gradient"]
                    + terms["divergence"] + terms["xy_divergence"])

        physics = physics_of(losses)
        # the batch's terms (on a mesh: the shares summed over the group)
        values = self._reduce(losses)
        physics_all = physics_of(values)
        # NaN/Inf guard: physics terms leave the total
        finite = torch.isfinite(physics_all)
        total = (losses["adversarial"] + losses["pix"] + losses["feature_D"]
                 + torch.where(finite, physics, zero))
        losses["total"] = total
        if self.mesh is not None:
            values["total"] = (values["adversarial"] + values["pix"]
                               + values["feature_D"]
                               + torch.where(finite, physics_all, zero))
        return total, (values, fake)

    def _d_loss(self, params_D: Params, stats: Params, hr3, fake,
                it: Optional[int], gen: torch.Generator, update_stats: bool):
        """D loss on train-mode forwards (σ=1 instance noise, batch
        statistics, dropout) at iteration ``it`` (None: the one last
        written); with ``update_stats`` the running statistics in
        ``stats`` move, real batch first. Returns (loss, y_pred,
        fake_y_pred); on a mesh the loss is this rank's share."""
        if it is not None:
            self._set_iteration(it)
        n = self._n(hr3.shape[0])
        hr_all, fake_all = self._make_labels(n, gen)
        hr_labels, fake_labels = self._rows(hr_all), self._rows(fake_all)
        real_in = self._noisy_d_input(hr3, 1.0, gen)
        fake_in = self._noisy_d_input(fake.detach(), 1.0, gen)
        kw = dict(train=True, update_stats=update_stats, generator=gen)
        p = self.D.dropout_probability

        def keep():  # on a mesh, this rank's rows of D's global mask
            if self.mesh is None or p == 0.0:
                return None
            return self._keep_rows(hr3.shape[0], self.D.feature_shape[-1],
                                   p, gen)

        y_pred = self._d_apply(params_D, stats, real_in, **kw,
                               dropout_mask=keep())
        fake_y_pred = self._d_apply(params_D, stats, fake_in, **kw,
                                    dropout_mask=keep())
        mean = self._mean
        if self.gan_type == "relativistic":
            loss = bce_with_logits(y_pred - fake_y_pred, hr_labels, mean)
        else:
            loss = (bce_with_logits(y_pred - self._batch_mean(fake_y_pred),
                                    hr_labels, mean)
                    + bce_with_logits(fake_y_pred - self._batch_mean(y_pred),
                                      fake_labels, mean)) / 2.0
            # bias when the one-sided-smoothed labels are exactly 0.9 (a
            # share of it on each rank of a mesh)
            ranks = 1 if self.mesh is None else self.mesh.world
            loss = torch.where(torch.all(hr_all == 0.9),
                               loss - 0.1985 / ranks, loss)
        return loss, y_pred, fake_y_pred

    # -------------------------------------------------------- optimizer
    def _adam_step(self, params: Params, grads, opt: AdamState, lr_t,
                   beta1: float, wd: float, finite=None,
                   gen: Optional[torch.Generator] = None,
                   sharded: frozenset = frozenset()):
        """optax chain (clip_by_global_norm, add_decayed_weights,
        scale_by_adam(b2=0.999, eps=1e-8), scale(-1)), then p += u · lr_t
        (a float or a 0-d tensor), in place, Adam's count included. With
        ``finite`` (a 0-d bool tensor) the parameters, moments and count
        keep their old values where it is false. Moments held in bf16
        (``bfloat16_sr``) are updated in float32, as JAX
        ``bf16_sr_optimizer_state`` upcasts them, and stored back by
        stochastic rounding with draws from ``gen``, first moments then
        second, each in the parameters' order. ``sharded`` names the
        parameters that hold this rank's output channels on a model axis:
        the norm sums their squares over the model group, and their
        rounding bits are drawn whole and cut. Returns the pre-clip global
        gradient norm. No host sync."""
        channels = self._channels if sharded else None
        if channels is None:
            norm = _global_norm(grads)
        else:
            norm = torch.sqrt(sharded_sq_norm(
                grads, [k in sharded for k in params], channels))
        if self.clip_norm is not None:
            grads = [torch.where(norm < self.clip_norm, g,
                                 g / norm * self.clip_norm) for g in grads]
        ps = list(params.values())
        if wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(ps, wd))
        mu, nu = list(opt.mu.values()), list(opt.nu.values())
        sr = self.moment_dtype == torch.bfloat16
        with torch.no_grad():
            count = opt.count + 1
            bc1 = 1.0 - torch.pow(beta1, count.float())
            bc2 = 1.0 - torch.pow(0.999, count.float())
            mu32 = [m.float() for m in mu] if sr else mu
            nu32 = [m.float() for m in nu] if sr else nu
            new_mu = torch._foreach_mul(mu32, beta1)
            torch._foreach_add_(new_mu, torch._foreach_mul(grads, 1 - beta1))
            new_nu = torch._foreach_mul(nu32, 0.999)
            torch._foreach_add_(new_nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - 0.999))
            u = torch._foreach_div(new_mu, bc1)
            den = torch._foreach_div(new_nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, 1e-8)
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, lr_t)
            new_p = torch._foreach_sub(ps, u)
            if sr:
                cuts = [channels if k in sharded else None for k in params]
                new_mu = [_round_bf16(m, gen, c)
                          for m, c in zip(new_mu, cuts)]
                new_nu = [_round_bf16(m, gen, c)
                          for m, c in zip(new_nu, cuts)]
            olds = [*ps, *mu, *nu, opt.count]
            news = [*new_p, *new_mu, *new_nu, count]
            if finite is not None:
                news = [torch.where(finite, n, o) for n, o in zip(news, olds)]
            torch._foreach_copy_(olds, news)
        return norm

    def _grads(self, loss, params: Params, sharded: frozenset = frozenset()):
        """The gradients of ``loss`` w.r.t. ``params``; on a mesh summed
        over the group (one flat all_reduce), the global loss's. On a model
        axis only the ``sharded`` leaves (this rank's channels) are summed
        so; the others, whole and computed on every model rank, are
        averaged over the whole mesh (a sum over its ranks over the model
        axis's size), so that they stay equal bit for bit."""
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params.values())]
        mesh = self.mesh
        if mesh is not None and mesh.model > 1:
            all_reduce_flat([g for k, g in zip(params, grads)
                             if k in sharded], mesh.group)
            whole = [g for k, g in zip(params, grads) if k not in sharded]
            all_reduce_flat(whole, mesh.world_group)
            torch._foreach_div_(whole, float(mesh.model))
        elif mesh is not None:
            all_reduce_flat(grads, mesh.group)
        return grads

    # ----------------------------------------------------------- steps
    def g_grads(self, state: GANTrainState, lr, hr, z, it: int,
                generator: torch.Generator, weights=None, dropout_mask=None):
        """The losses of a G step at iteration ``it`` and the gradients of
        its total w.r.t. ``state.params_G`` (a list in the dict's order),
        without the update: (total, losses, grads); on a mesh the batch's
        losses and the gradients summed over the group."""
        self._placed(state)
        self._set_iteration(it)
        return self._g_grads(state, *self._cut(lr, hr, z), generator,
                             weights, dropout_mask)

    def _g_grads(self, state, lr, hr, z, generator, weights=None,
                 dropout_mask=None):
        params = {k: v.detach().requires_grad_() for k, v in
                  state.params_G.items()}
        with spans.span("G.losses"):
            loss, (losses, _) = self._g_losses(params, state, lr, hr, z,
                                               None, generator, True,
                                               weights, dropout_mask)
        with spans.span("G.grad"):
            grads = self._grads(loss, params, state.sharded)
        return (losses["total"].detach(),
                {k: v.detach() for k, v in losses.items()}, grads)

    def _g_branch(self, state: GANTrainState, lr, hr, z, w):
        loss, metrics, grads = self._g_grads(state, lr, hr, z, state.rng, w)
        # a non-finite loss skips the whole optimizer step, Adam's count
        # included
        with spans.span("G.adam"):
            norm = self._adam_step(state.params_G, grads, state.opt_state_G,
                                   self._sc["lr_G"], *self.opt_G,
                                   finite=torch.isfinite(loss),
                                   gen=state.rng, sharded=state.sharded)
        metrics["D_train_loss"] = torch.zeros((), device=self.device)
        if self.clip_norm is not None:
            metrics["G_grad_norm"] = norm
        return metrics

    def _d_branch(self, state: GANTrainState, lr, hr, z):
        # G eval, no dropout, no gradient: the trunk kernel if enabled
        with spans.span("D.forward_G"):
            fake = self._g_forward_nograd(state.params_G, lr, z)
        params = {k: v.detach().requires_grad_() for k, v in
                  state.params_D.items()}
        with spans.span("D.losses"):
            loss_D, _, _ = self._d_loss(params, state.batch_stats_D,
                                        hr[..., :3], fake, None, state.rng,
                                        True)
        with spans.span("D.grad"):
            grads = self._grads(loss_D, params)
        with spans.span("D.adam"):
            self._adam_step(state.params_D, grads, state.opt_state_D,
                            self._sc["lr_D"], *self.opt_D, gen=state.rng)
        zero = torch.zeros((), device=self.device)
        metrics = {k: zero for k in _LOSS_KEYS}
        metrics["D_train_loss"] = self._reduce({"D": loss_D})["D"].detach()
        if self.clip_norm is not None:
            metrics["G_grad_norm"] = zero
        return metrics

    def _n_g_steps(self, it: int) -> int:
        """G steps among iterations 1..it under the block alternation."""
        if self.d_g_train_ratio == 0:
            return it
        r1 = self.d_g_train_ratio + 1
        p = self.d_g_train_period
        blk, pos = divmod(it, p)
        return (blk + r1 - 1) // r1 * p + (pos + 1 if blk % r1 == 0 else 0) - 1

    def is_g_step(self, it: int) -> bool:
        """Whether iteration ``it`` (counted from 1) is a G step."""
        if self.d_g_train_ratio == 0:
            return True
        return (it // self.d_g_train_period) % (self.d_g_train_ratio + 1) == 0

    def train_step(self, state: GANTrainState, lr, hr, z,
                   augment: bool = False, weights=None):
        """One iteration, G or D by the alternation; updates ``state`` in
        place and returns ``(state, metrics)``. With ``augment`` the batch
        is first rotated and mirrored per sample (``data/augment.py``),
        with draws from ``state.rng`` before any other of the step's. On a
        mesh, ``lr``, ``hr`` and ``z`` are this rank's rows."""
        with spans.span("train.step") as step:
            lr, hr, z = (self._as_input(a) for a in (lr, hr, z))
            it = self._begin_step(state)
            g_step = self.is_g_step(it)
            step.set(kind="G" if g_step else "D")
            metrics = self._step(state, lr, hr, z, augment, g_step, weights)
        state.it = it
        return state, metrics

    def _begin_step(self, state: GANTrainState) -> int:
        """The host's part of iteration ``state.it + 1``, before its device
        work: the schedules' values, and the frozen feature extractor's
        refresh (copied in place). Returns the iteration."""
        with spans.span("train.begin"):
            self._placed(state)
            it = state.it + 1
            self._set_iteration(it)
            if self.use_feature_D:
                frozen = state.params_D_frozen
                if frozen.keys() != state.params_D.keys():
                    state.params_D_frozen = _clone(state.params_D)
                elif it % self.feature_D_update_period == 0:
                    with torch.no_grad():
                        for k, v in state.params_D.items():
                            frozen[k].copy_(v)
        return it

    def _step(self, state: GANTrainState, lr, hr, z, augment: bool,
              g_step: bool, weights=None):
        """The device work of one iteration, G or D as ``g_step`` says, on
        the schedules ``_begin_step`` wrote: tensor ops only, every update
        of ``state`` in place, no host sync, so a CUDA graph can capture
        it. Returns the metrics."""
        if augment:
            with spans.span("train.augment"):
                draws = augment_draws(self._n(lr.shape[0]), state.rng,
                                      lr.device)
                lr, hr, z = augment_batch_with(
                    lr, hr, z, *(self._rows(d) for d in draws))
        # on a spatial axis the slab is cut last, after augmentation
        lr, hr, z = self._cut(lr, hr, z)
        w = weights or self.default_weights
        if g_step:
            metrics = self._g_branch(state, lr, hr, z, w)
        else:
            metrics = self._d_branch(state, lr, hr, z)
        # the EMA moves on G steps only (params_G is unchanged on D steps)
        if g_step and self.ema_decay > 0.0 and state.params_G_ema is not None:
            with spans.span("G.ema"), torch.no_grad():
                ema = list(state.params_G_ema.values())
                step = torch._foreach_sub(
                    [state.params_G[k] for k in state.params_G_ema], ema)
                torch._foreach_mul_(step, self._sc["ema"])
                torch._foreach_add_(ema, step)
        metrics["is_g_step"] = torch.full((), float(g_step),
                                          device=self.device)
        metrics["lr_G"] = self._sc["lr_G"].clone()
        return metrics

    def train_chunk(self, state: GANTrainState, full, zraw, seed: int, *,
                    n_steps: int, batch_size: int, patch: int, patch_y: int,
                    cf: int, enable_slicing: bool, augment: bool = False):
        """``n_steps`` iterations, each on the batch of its own iteration
        cut on the device from the resident volumes ``full`` and ``zraw``
        (``data/device_data.py:batch_at`` of the stream ``seed``: the
        batch ``DeviceBatcher`` hands the per-step loop for that
        iteration, so chunked and per-step legs, and a resume, draw the
        same stream whatever the chunk boundaries). On a CUDA device each
        step kind runs as a CUDA graph of the step (``step_graphs.py``),
        captured on its first use and replayed; a failed capture or replay
        raises. On the CPU the same steps run eagerly. On a mesh
        ``batch_size`` is the global batch's and each rank cuts its rows;
        the graphs capture the step's collectives, which NCCL allows and
        gloo does not (``step_graphs.capturable``): on a card with a gloo
        group this raises ValueError. Returns ``(state, the last step's
        metrics)``."""
        from gan_sr_wind_field_tpu_torch.train.step_graphs import (
            StepGraphs,
            capturable,
        )

        if self.device.type == "cuda" and not capturable(self.mesh):
            raise ValueError(
                "train_chunk captures the step's collectives in CUDA "
                "graphs, which a gloo group cannot be: train on NCCL, or "
                "with steps_per_dispatch = 1")
        kw = dict(batch_size=batch_size, patch=patch, patch_y=patch_y, cf=cf,
                  enable_slicing=enable_slicing,
                  rows=None if self.mesh is None
                  else self.mesh.rows(batch_size))
        gen = torch.Generator(device=full.device)
        if self.device.type != "cuda":
            for _ in range(n_steps):
                batch = batch_at(full, zraw, seed, state.it, gen, **kw)
                state, metrics = self.train_step(state, *batch,
                                                 augment=augment)
            return state, metrics
        batch = batch_at(full, zraw, seed, state.it, gen, **kw)
        if self._graphs is None or not self._graphs.fits(state, batch,
                                                         augment):
            self._graphs = StepGraphs(self, state, batch, augment)
        for i in range(n_steps):
            if i:
                batch = batch_at(full, zraw, seed, state.it, gen, **kw)
            metrics = self._graphs.step(state, batch)
        return state, {k: v.clone() for k, v in metrics.items()}

    def val_step(self, state: GANTrainState, lr, hr, z,
                 generator: Optional[torch.Generator] = None, weights=None):
        """Validation losses and metrics. As the reference does, the D
        forwards run in train mode and move D's running statistics; they
        are written into ``state.batch_stats_D``, which is returned beside
        the metrics. On a mesh, ``lr``, ``hr`` and ``z`` are this rank's
        rows, and the metrics are the batch's."""
        self._placed(state)
        lr, hr, z = self._cut(*(self._as_input(a) for a in (lr, hr, z)))
        gen = state.rng if generator is None else generator
        w = weights or self.default_weights
        hr3 = hr[..., :3]
        with torch.no_grad():
            _, (losses, fake) = self._g_losses(state.params_G, state, lr, hr,
                                               z, state.it, gen, False, w)
            metrics = {f"G_val_{k}": v for k, v in losses.items()}
            zero = torch.zeros((), device=self.device)
            shares = dict(D_val_loss=zero, D_pred_HR=zero, D_pred_SR=zero)
            if self.use_adv:
                loss_D, y_pred, fake_y_pred = self._d_loss(
                    state.params_D, state.batch_stats_D, hr3, fake, None,
                    gen, update_stats=True)
                shares.update(D_val_loss=loss_D,
                              D_pred_HR=self._mean(torch.sigmoid(y_pred)),
                              D_pred_SR=self._mean(torch.sigmoid(
                                  fake_y_pred)))
            trilinear = upsample_trilinear_xy(lr[..., :3], self.cfg.scale,
                                              self._slab)
            voxels = hr3[..., 0].numel() * (1 if self.mesh is None
                                            else self.mesh.world)
            # psnr's MSE: the squared error over the batch's voxels
            shares["val_PSNR"] = ((hr3 - fake) ** 2).sum() / voxels
            shares["Trilinear_PSNR"] = ((hr3 - trilinear) ** 2).sum() / voxels
            if self.pixel_criterion == "l2":
                shares["trilinear_pix_loss"] = self._mean(
                    (hr3 - trilinear) ** 2)
            else:
                shares["trilinear_pix_loss"] = self._mean(
                    (hr3 - trilinear).abs())
            metrics.update(self._reduce(shares))
            for k in ("val_PSNR", "Trilinear_PSNR"):
                metrics[k] = psnr_from_mse(metrics[k])
            # the weight may be a 0-d tensor (the search's): no host sync
            w_pix = torch.as_tensor(w["pix"], dtype=torch.float32,
                                    device=self.device)
            metrics["pix_loss_unscaled"] = torch.where(
                w_pix != 0.0, losses["pix"] / torch.clamp_min(w_pix, 1e-30),
                losses["pix"])
        return metrics, state.batch_stats_D
