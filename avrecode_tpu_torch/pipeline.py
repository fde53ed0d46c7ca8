"""Top-level compress / decompress / roundtrip over the native host engine.

Counterpart of avrecode_tpu/pipeline.py, over the port's own bindings
(host.py): the C++ engine end to end, with the same defaults (16 lanes,
chunk mode 0, batch 1, profile 0). Like the JAX module it touches no
device; the device path is device.compress. roundtrip must reproduce the
input byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import host


@dataclass
class RoundtripReport:
    ok: bool
    input_bytes: int
    compressed_bytes: int
    ratio: float  # compressed / original
    container_overhead: float  # fraction of compressed not literal/recoded payload
    stats: host.Stats


def container_overhead(compressed_bytes: int, st: host.Stats) -> float:
    """The share of a container that is neither literal nor recoded payload
    (0.0 for an empty container)."""
    payload = st.literal_bytes + st.recoded_bytes
    return 1.0 - payload / compressed_bytes if compressed_bytes else 0.0


def compress(data: bytes, lanes: int = 16, chunk_mode: int = 0,
             batch_size: int = 1, model_profile: int = 0) -> tuple[bytes, host.Stats]:
    return host.compress(data, lanes=lanes, chunk_mode=chunk_mode, batch_size=batch_size,
                         model_profile=model_profile)


def decompress(data: bytes) -> tuple[bytes, host.Stats]:
    return host.decompress(data)


def roundtrip(data: bytes, lanes: int = 16, chunk_mode: int = 0,
              batch_size: int = 1, model_profile: int = 0) -> RoundtripReport:
    comp, st = compress(data, lanes=lanes, chunk_mode=chunk_mode, batch_size=batch_size,
                        model_profile=model_profile)
    dec, _ = decompress(comp)
    return RoundtripReport(
        ok=dec == data,
        input_bytes=len(data),
        compressed_bytes=len(comp),
        ratio=len(comp) / len(data) if data else 0.0,
        container_overhead=container_overhead(len(comp), st),
        stats=st,
    )
