"""Driver: avrecode_tpu_torch.device.compress_mesh on a 1x1 (gop, lane) grid
of the run's device, one client in a closed loop.

The grid is made once; the call builds its step itself, as the program
does on every call. Each file's time runs from the call until it returns
its container, whose bytes are then in host memory (the call downloads the
step's lane outputs and packs on the host before it returns). The call
passes only the arguments that every version of compress_mesh takes.
"""
from __future__ import annotations

import sys
import time
import traceback

from harness.record import Record


class Driver:
    def __init__(self, config: dict, device: str, workdir: str):
        from avrecode_tpu_torch import device as td
        from avrecode_tpu_torch.parallel import mesh
        self.td = td
        self.config = config
        n_gop, n_lane = config["mesh"]
        self.mesh = mesh.make_mesh(n_gop, n_lane, devices=[device] * (n_gop * n_lane))

    def _call(self, data: bytes) -> bytes:
        c = self.config
        out, _ = self.td.compress_mesh(data, self.mesh, lanes=c["lanes"],
                                       chunk_mode=c["chunk_mode"], batch_size=c["batch_size"],
                                       sup=c["sup"])
        return out

    def warm(self, items) -> None:
        for it in items:
            self._call(it.data)

    def run(self, stream, seconds: float, span) -> list[Record]:
        recs = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            it = next(stream)
            s = time.perf_counter()
            try:
                with span(f"compress_mesh {it.name}"):
                    out, ok = self._call(it.data), True
            except Exception:  # a failed file is counted, and the run goes on
                print(f"compress_mesh: {it.name} failed:", file=sys.stderr, flush=True)
                traceback.print_exc()
                out, ok = None, False
            e = time.perf_counter()
            recs.append(Record(it.name, len(it.data), s - t0, e - t0, ok, out))
        return recs

    def collect(self, records) -> None:
        """Outputs are already in memory."""
