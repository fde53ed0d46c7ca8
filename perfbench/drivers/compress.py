"""Driver: avrecode_tpu_torch.device.compress, one client in a closed loop.

Each file's time runs from the call until it returns its container, whose
bytes are then in host memory (the call downloads every chunk's lane blob
and packs on the host before it returns).
"""
from __future__ import annotations

import sys
import time
import traceback

from harness.record import Record

INFO_KEYS = ("open_s", "fetch_s", "fetch_wait_s", "parse_s", "stage_s", "launch_s",
             "compact_s", "dispatch_s", "emit_s", "pack_s", "wire_bytes", "n_chunks")


class Driver:
    def __init__(self, config: dict, device: str, workdir: str):
        from avrecode_tpu_torch import device as td
        self.td = td
        self.config = config
        self.device = device

    def _call(self, data: bytes, info: dict | None = None) -> bytes:
        c = self.config
        out, _ = self.td.compress(data, c["lanes"], c["chunk_mode"], c["batch_size"],
                                  c["model_profile"], info=info, device=self.device)
        return out

    def warm(self, items) -> None:
        for it in items:
            self._call(it.data)

    def run(self, stream, seconds: float, span) -> list[Record]:
        recs = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            it = next(stream)
            info: dict = {}
            s = time.perf_counter()
            try:
                with span(f"compress {it.name}"):
                    out, ok = self._call(it.data, info), True
            except Exception:  # a failed file is counted, and the run goes on
                print(f"compress: {it.name} failed:", file=sys.stderr, flush=True)
                traceback.print_exc()
                out, ok = None, False
            e = time.perf_counter()
            recs.append(Record(it.name, len(it.data), s - t0, e - t0, ok, out,
                               {k: info[k] for k in INFO_KEYS if k in info}))
        return recs

    def collect(self, records) -> None:
        """Outputs are already in memory."""
