"""Micro-batcher: real fields over the fields of its batches, padding
included (its ``batched_samples`` and ``padded_samples`` counters)."""

from windbench import readers


def read(trace):
    return readers.batch_fill_pct(trace)
