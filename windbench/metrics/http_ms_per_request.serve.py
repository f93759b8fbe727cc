"""HTTP front end: the median over the window's requests of the handler's
``http.decode`` (body read, npz load, shape checks) plus its
``http.encode`` (npz save, headers, write), from the program's own
spans."""

from windbench import program_spans


def read(trace):
    return program_spans.http_ms_per_request(trace)
