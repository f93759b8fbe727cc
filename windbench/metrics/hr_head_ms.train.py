"""HR head: the median over the window's G steps of the step's
``G.hr_head`` device time (CUDA events around hr_conv0 and around its
backward), forward plus backward. A step replayed as a CUDA graph
(``train/step_graphs.py``) records no span and no event, so a cell whose
steps are all replays reads None."""

from windbench import program_spans


def read(trace):
    return program_spans.hr_head_ms_train(trace)
