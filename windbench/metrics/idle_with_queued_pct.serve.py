"""Device: the share of the traced window in which no operation ran on
the card while a job waited in the micro-batcher's queue (its
``batcher.queue`` span open): the idle time that is the program's doing,
not the traffic's."""

from windbench import program_spans


def read(trace):
    return program_spans.idle_with_queued_pct(trace)
