"""One file's passage through the program in a run."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    name: str            # the traffic item's name
    nbytes: int          # input bytes
    start: float         # seconds from the window's start (host clock)
    end: float           # when its container was complete in host memory
    ok: bool             # False: the call raised, or no container came
    output: bytes | None = None
    info: dict = field(default_factory=dict)  # the call's host-clock phases, if any
    path: str | None = None   # where a pool wrote the container
