"""Stochastic rounding float32 → bfloat16, for Adam moments held in bf16.

Counterpart of ``gan_sr_wind_field_tpu/ops/sr_cast.py``. Round-to-nearest
bf16 moments stall once an update is under half an ulp of the moment;
stochastic rounding is unbiased (E[sr(x)] = x), so with
``optimizer_state_dtype = "bfloat16_sr"`` the moments live in bf16, half
the bytes of float32, and follow the float32 trajectory in expectation.

The method is the JAX package's bit arithmetic: add 16 uniform random bits
to the float32 bit pattern and clear its low 16 bits. Bit patterns are
ordered and evenly spaced within an exponent, and the carry out of the
mantissa steps the exponent, so x rounds up with probability equal to its
distance from the bf16 value below, in ulps. It is plain tensor ops: the
JAX package keeps it out of any Pallas kernel so that XLA fuses it into
the optimizer update, and here it is a handful of elementwise launches on
tensors the Adam step already holds.

The draws come from a ``torch.Generator`` (the training state's), so a
step that casts stays free of host syncs and a CUDA graph of it replays
fresh draws; JAX draws from ``fold_in(key(seed), count)``, another stream
of the same distribution. ``stochastic_round_bf16_with`` takes the draws
instead, so that tests can feed the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import torch

_HIGH_HALF = -(1 << 16)  # 0xFFFF0000 as an int32


def draw_bits16(x: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    """Uniform 16-bit draws, one per element of ``x`` (int32 in
    [0, 65536)), on ``x``'s device from ``generator``."""
    return torch.randint(0, 1 << 16, x.shape, generator=generator,
                         dtype=torch.int32, device=x.device)


def stochastic_round_bf16_with(x: torch.Tensor, bits16: torch.Tensor
                               ) -> torch.Tensor:
    """float32 ``x`` → bfloat16, rounded by the draws ``bits16`` (integers
    in [0, 65536), one per element; JAX ``jax.random.bits(key) & 0xFFFF``
    gives the same result bit for bit). Other dtypes pass through."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    # int32 addition wraps as JAX's uint32 addition does, bit for bit
    out = (bits + bits16.to(torch.int32)) & _HIGH_HALF
    return out.view(torch.float32).to(torch.bfloat16)  # exact


def stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator
                          ) -> torch.Tensor:
    """Unbiased float32 → bfloat16 cast with draws from ``generator``."""
    if x.dtype != torch.float32:
        return x
    return stochastic_round_bf16_with(x, draw_bits16(x, generator))


def tree_stochastic_round_bf16(tree: Dict[str, torch.Tensor],
                               generator: torch.Generator
                               ) -> Dict[str, torch.Tensor]:
    """Every float32 tensor of ``tree`` cast by ``stochastic_round_bf16``,
    in the tree's order, each with draws of its own; others unchanged."""
    return {k: stochastic_round_bf16(v, generator) for k, v in tree.items()}

