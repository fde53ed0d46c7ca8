"""The (gop, lane) device grid of the mesh steps.

Counterpart of avrecode_tpu/parallel/mesh.py. The JAX package shards one
jitted program over a jax.sharding.Mesh; the port runs one controller
process that drives every cell of the grid itself, so its mesh is just the
grid of `torch.device`s:
  - 'gop':  rows own whole chunks (independent IDR-delimited GOPs, each with
            its own estimator tables), so this axis needs no communication;
  - 'lane': the cells of a row own slices of the rANS lanes, which are
            independent streams.
The step's only cross-cell result, the payload-word total, is summed by the
controller (parallel/pipeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """devices[g][l] runs cell (g, l); cells may share a device (a grid on
    one card), and each still computes its own share."""
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"gop": len(self.devices), "lane": len(self.devices[0])}


def make_mesh(n_gop: int | None = None, n_lane: int = 1, devices=None) -> Mesh:
    """An (n_gop, n_lane) grid over `devices` (default: every CUDA device;
    raises if there is none) in row-major order; n_gop defaults to the
    device count // n_lane. A list may repeat a device, e.g. ["cuda:0"] * 4
    for a 2 x 2 grid on one card, or ["cpu"] * 8 for the plain versions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices explicitly "
                               "(e.g. ['cpu'] * 8 for the plain versions)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_gop is None:
        n_gop = len(devices) // n_lane
    if n_gop < 1 or n_lane < 1 or n_gop * n_lane > len(devices):
        raise ValueError(f"mesh {n_gop}x{n_lane} needs {n_gop * n_lane} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(tuple(devices[g * n_lane:(g + 1) * n_lane]) for g in range(n_gop)))
