"""The measured window: all stacks completed over all its seconds.

The window opens at a completion (the last warm-up stack's) and closes at
the first completion at or after `open + seconds`. Its rate is the stacks
completed inside it over its length, so a stall anywhere in it lowers the
rate; nothing is a median of stacks.
"""

from __future__ import annotations

from typing import List, Optional


class Window:
    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.done: List[float] = []  # completion times inside the window

    def open(self, t: float) -> None:
        self.t_open = t

    def complete(self, t: float) -> bool:
        """Record a completion at `t`; True when it closes the window."""
        if self.t_open is None or self.t_close is not None:
            raise RuntimeError("a completion outside the window")
        self.done.append(t)
        if t - self.t_open >= self.seconds:
            self.t_close = t
            return True
        return False

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    @property
    def rate(self) -> float:
        """Stacks completed per second over the whole window."""
        return len(self.done) / self.length


class PoolExhausted(RuntimeError):
    """The pool ran out before the window closed: a stack is never served
    twice, so the pool has to outlast the window."""

    def __init__(self, n: int):
        super().__init__(f"the pool ran out after {n} stacks before the window closed: "
                         "raise pool_stacks in the traffic file")
