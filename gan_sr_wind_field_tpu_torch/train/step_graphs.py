"""CUDA graphs of ``WindFieldGAN``'s training step, for ``train_chunk``.

The JAX package runs K steps as one compiled ``lax.scan`` dispatch
(``gan_sr_wind_field_tpu/train/gan.py:_train_chunk``). Its counterpart on
the card is a CUDA graph of the step, replayed: the host launches one graph
per step instead of the step's thousands of kernels.

- One graph per step kind (G step, D step), captured at the batch's shapes
  on its first use, both in one memory pool. Before its capture the step
  runs once eagerly on a side stream, as PyTorch requires; that warm-up is
  a real iteration of the leg.
- The graphs read the batch from static input buffers, the schedules from
  the step's 0-d tensors (``WindFieldGAN._set_iteration``) and write every
  state update in place, so per step the host cuts the batch into the
  buffers, writes the schedules and replays. The branch, G or D, is chosen
  on the host.
- ``state.rng`` is registered with each graph, so dropout, labels, instance
  noise and the augmentation draws advance as they do eagerly.
- The kernels' launch counters count while a graph is captured, not when
  it replays: the launches a capture counted are taken back and kept with
  the graph, and added once per replay.

A failed capture or replay raises; nothing falls back to eager steps.

On a data mesh the graphs hold the step's collectives too. NCCL's
all_reduce can be captured and replayed (checked on an H100 with NCCL
2.28.9: a captured all_reduce replays with the right sum); gloo's runs on
the host and cannot (its capture fails with
``cudaErrorStreamCaptureInvalidated``). ``capturable`` is that rule.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gan_sr_wind_field_tpu_torch.ops import hr_head, rdb_trunk, stencil

# the kernels' launch counters, in the order trunk / trunk backward /
# gradient / adjoint / head
_COUNTERS = ((rdb_trunk, "launches"), (rdb_trunk, "bwd_launches"),
             (stencil, "launches"), (stencil, "adjoint_launches"),
             (hr_head, "launches"))


def launch_counts() -> tuple:
    """The kernels' launch counters (trunk, trunk backward, gradient,
    adjoint, head)."""
    return tuple(getattr(m, n) for m, n in _COUNTERS)


def add_launches(counts) -> None:
    """Add ``counts`` (as ``launch_counts`` orders them) to the counters."""
    for (m, n), c in zip(_COUNTERS, counts):
        setattr(m, n, getattr(m, n) + c)


def capturable(mesh) -> bool:
    """Whether the step on ``mesh`` (None: one process) can be captured in
    a CUDA graph: its collectives must be NCCL's."""
    return mesh is None or dist.get_backend(mesh.group) == "nccl"


def _state_key(state) -> tuple:
    """What a graph holds of the state: its generator and the address of
    every tensor it reads or updates."""
    trees = [state.params_G, state.params_D, state.batch_stats_D,
             state.params_D_frozen, state.params_G_ema or {}]
    for opt in (state.opt_state_G, state.opt_state_D):
        trees += [opt.mu, opt.nu, {"count": opt.count}]
    return (id(state.rng),) + tuple(t.data_ptr() for tree in trees
                                    for t in tree.values())


class StepGraphs:
    """The G-step and D-step graphs of one state, one batch shape and one
    augmentation setting.

        graphs = StepGraphs(gan, state, batch, augment)
        metrics = graphs.step(state, batch)   # iteration state.it + 1

    ``capture_s`` sums the seconds of the captures, ``replays`` counts the
    replays and ``pool_bytes`` the device memory the captures reserved
    (the shared pool)."""

    def __init__(self, gan, state, batch, augment: bool):
        self.gan = gan
        self.augment = bool(augment)
        self.key = _state_key(state)
        self.inputs = tuple(torch.empty_like(t) for t in batch)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}  # g_step -> (graph, its metrics, its launches)
        self.capture_s = 0.0
        self.replays = 0
        self.pool_bytes = 0

    def fits(self, state, batch, augment: bool) -> bool:
        """Whether these graphs run ``state`` on batches like ``batch``."""
        return (bool(augment) == self.augment
                and [t.shape for t in batch] == [t.shape for t in self.inputs]
                and _state_key(state) == self.key)

    def step(self, state, batch) -> dict:
        """Iteration ``state.it + 1`` on ``batch``: the graph of its kind
        replayed, or, on the kind's first use, the step run eagerly and
        then captured. Returns the step's metrics (a replay's are the
        graph's own tensors, overwritten by its next replay)."""
        gan = self.gan
        for dst, src in zip(self.inputs, batch):
            dst.copy_(src)
        it = gan._begin_step(state)
        g_step = gan.is_g_step(it)
        entry = self.graphs.get(g_step)
        if entry is None:
            metrics = self._warm_up(state, g_step)
            self.graphs[g_step] = self._capture(state, g_step)
        else:
            graph, metrics, launches = entry
            graph.replay()
            add_launches(launches)
            self.replays += 1
        state.it = it
        return metrics

    def _warm_up(self, state, g_step: bool) -> dict:
        dev = self.gan.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            metrics = self.gan._step(state, *self.inputs, self.augment,
                                     g_step)
        torch.cuda.current_stream(dev).wait_stream(side)
        return metrics

    def _capture(self, state, g_step: bool):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.rng)
        dev = self.gan.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does first
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        t = time.monotonic()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            metrics = self.gan._step(state, *self.inputs, self.augment,
                                     g_step)
        self.capture_s += time.monotonic() - t
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        launches = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launches([-n for n in launches])
        return graph, metrics, launches
