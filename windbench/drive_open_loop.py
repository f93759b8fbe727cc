"""Traffic kind ``open_loop``: the serving path, ``drive_serve``."""

from windbench.drive_serve import run  # noqa: F401
