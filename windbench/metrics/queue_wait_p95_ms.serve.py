"""Micro-batcher: the 95th percentile of the window's queue waits, each
job's ``batcher.queue`` span (its enqueue to the start of its batch),
from the program's own spans."""

from windbench import program_spans


def read(trace):
    return program_spans.queue_wait_p95_ms(trace)
