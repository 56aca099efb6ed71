"""Cooperative preemption handling for long training runs (a copy of
`muse_maskgit_pytorch_tpu/training/preemption.py`).

A preemptible machine gets SIGTERM and a grace window before SIGKILL.
`PreemptionGuard` turns the first SIGTERM or SIGINT into a flag that the
training loop checks between steps, so the trainer saves its exact state and
exits cleanly; a restart with `auto_resume=True` continues from that step. A
second signal restores the previous handler's behaviour (default: die), so a
stuck checkpoint write can always be interrupted by hand.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional, Tuple


class PreemptionGuard:
    """Context manager: SIGTERM / SIGINT -> the `requested` flag.

        with PreemptionGuard() as guard:
            while step < total and not guard.requested:
                train_step()
            if guard.requested:
                save_checkpoint()

    Signal handlers can only be installed from the main thread; from any
    other thread the guard is inert (`armed` False)."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self._prev: dict = {}
        self.armed = False
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        self.signum = signum
        self._event.set()
        # one graceful shot: a second signal meets the previous handlers
        self._restore()

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
            self.armed = True
        except ValueError:  # not the main thread
            self._restore()
        return self

    def __exit__(self, *exc) -> None:
        self._restore()

    def _restore(self) -> None:
        for s, h in list(self._prev.items()):
            try:
                signal.signal(s, h)
            except ValueError:
                pass
            del self._prev[s]
        self.armed = False
