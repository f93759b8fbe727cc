"""Step-progress stall watchdog (the port's own copy of
``gan_sr_wind_field_tpu/train/watchdog.py``; pure Python and signals).

A step that never returns (a hung device call, a wedged data producer) can
only be ended from outside the blocked call: a POSIX signal with a
registered Python handler interrupts the wait, and the train loop's
SIGTERM path then checkpoints and exits cleanly (``train/loop.py``). When
even that cannot complete, the only safe move is a hard exit: the last
periodic checkpoint stands and a supervisor relaunches.

``StallWatchdog`` runs that escalation from a daemon thread:

- the hot loop calls :meth:`beat` once per completed iteration;
- the watchdog arms on the first beat (the kernels' build and the data
  upload before step 1 must not trip it);
- if no beat lands for ``threshold_s``, it sends ``SIGTERM`` to its own
  process (graceful checkpoint and exit through the loop's handler);
- if the stall persists through ``max_fires`` thresholds, it hard-exits
  with :data:`STALL_EXIT_CODE`, so a supervisor can tell watchdog death
  (relaunch from the checkpoint) from real errors.

Enable with ``[TRAINING] stall_watchdog_s = <seconds>`` (0 = off, the
default). Pick a threshold well above one validation sweep plus one
checkpoint save.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time

STALL_EXIT_CODE = 86


class StallWatchdog:
    """Fire escalating recovery actions when step progress stops.

    Parameters
    ----------
    threshold_s : float
        Seconds without a :meth:`beat` before firing. The clock only
        starts at the FIRST beat (the start-up does not count).
    max_fires : int
        Graceful attempts (SIGTERM to self) before the hard exit.
    action : callable, optional
        Replaces the SIGTERM-to-self graceful action (tests).
    hard_action : callable, optional
        Replaces ``os._exit(STALL_EXIT_CODE)`` (tests).
    poll_s : float, optional
        Check interval; default ``threshold_s / 4``.
    startup_deadline_s : float, optional
        Seconds allowed from :meth:`start` to the FIRST beat before the
        same escalation fires: a leg that hangs before its first step
        never beats, and without this deadline the watchdog never arms.
        Set it well above the kernels' build and the data upload;
        0/None disables (default).
    """

    def __init__(self, threshold_s: float, max_fires: int = 2,
                 action=None, hard_action=None, poll_s: float = None,
                 startup_deadline_s: float = None):
        self.threshold_s = float(threshold_s)
        self.max_fires = int(max_fires)
        self.startup_deadline_s = float(startup_deadline_s or 0)
        self._action = action or self._sigterm_self
        self._hard_action = hard_action or self._hard_exit
        self._poll_s = poll_s if poll_s is not None else self.threshold_s / 4
        self._last_beat = None  # None = not armed yet
        self._grace_until = 0.0
        self._t_start = None
        self._fires = 0
        self._stop = threading.Event()
        self._thread = None
        self._log = logging.getLogger("status")

    # -- actions ----------------------------------------------------------
    @staticmethod
    def _sigterm_self():
        os.kill(os.getpid(), signal.SIGTERM)

    @staticmethod
    def _hard_exit():
        os._exit(STALL_EXIT_CODE)

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self.threshold_s <= 0:
            return self
        self._t_start = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, name="stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self):
        """Mark progress (call once per completed iteration)."""
        self._last_beat = time.monotonic()
        self._fires = 0

    def grace(self, seconds):
        """Defer firing until ``seconds`` from now (monotonic).

        Call immediately BEFORE a known-long host-blocking phase that
        does not beat: a validation sweep, a checkpoint save at large
        geometry. Beats resume normal cadence once the phase completes;
        if the phase itself hangs past the grace window, the watchdog
        still fires."""
        until = time.monotonic() + float(seconds)
        self._grace_until = max(self._grace_until, until)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll_s + 1)

    # -- the watch loop ---------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self._poll_s):
            last = self._last_beat
            if last is None:  # not armed: still compiling / warming up
                if not self.startup_deadline_s:
                    continue
                waited = time.monotonic() - self._t_start
                if waited < self.startup_deadline_s * (self._fires + 1):
                    continue
                stalled_for = waited  # never reached the first step
            else:
                now = time.monotonic()
                if now < self._grace_until:
                    continue
                stalled_for = now - max(last, self._grace_until)
                if stalled_for < self.threshold_s * (self._fires + 1):
                    continue
            self._fires += 1
            if self._fires <= self.max_fires:
                self._log.critical(
                    "stall watchdog: no step progress for %.0f s — "
                    "sending SIGTERM to self (graceful checkpoint+exit), "
                    "attempt %d/%d",
                    stalled_for, self._fires, self.max_fires,
                )
                self._action()
            else:
                self._log.critical(
                    "stall watchdog: still no progress %.0f s after %d "
                    "SIGTERM attempts — hard exit %d (resume from the "
                    "last checkpoint)",
                    stalled_for, self.max_fires, STALL_EXIT_CODE,
                )
                self._hard_action()
                return
