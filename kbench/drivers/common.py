"""What the drivers hand back: one record per request of the window."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Served:
    request: object                  # traffic.Request; due_s < 0 in a closed loop
    sent_s: float                    # when it reached the program
    first_s: Optional[float] = None  # when its first token reached the client
    done_s: Optional[float] = None   # when it finished; None if it never did
    tokens: list = dataclasses.field(default_factory=list)
    error: Optional[str] = None

    @property
    def latency_s(self) -> Optional[float]:
        """From when it was due (open loop) or sent (closed loop) to done."""
        if self.done_s is None:
            return None
        due = self.request.due_s
        return self.done_s - (due if due >= 0 else self.sent_s)


@dataclasses.dataclass
class Window:
    served: list                     # Served, in the order sent
    seconds: float                   # the nominal window
    end_s: float                     # when the last request of the window ended
    counters: dict                   # the program's counters over the window
    spans: list                      # (name, start_s, end_s) of the harness
