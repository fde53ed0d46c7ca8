"""A compress call's own streams on one card, and its transfers through
pinned memory.

The JAX package's main path is asynchronous: `device_put` and the jitted
calls return at once, so the host walk, the transfers and the device work
of different chunks overlap, and a readback waits only for the buffer it
reads. `CallStreams` is that behaviour written out for PyTorch: each
`device.compress(device="cuda")` and `device.compress_mesh` call has a
compute stream of its own, on which all of its kernels run, and a copy
stream of its own, on which its uploads and downloads run from and into
pinned host tensors. `call_streams(device)` lends a call its pair for the
call's duration: no two calls in flight share one, and a later call
reuses a returned pair, because PyTorch's caching allocator keeps the
blocks a stream freed for that stream (a new pair for every call would
send every allocation of every call to cudaMalloc).

  - `pinned`: host tensors from PyTorch's caching host
    allocator, which hands a block out again only once the copies recorded
    on it have ended, so a buffer is never refilled under a copy;
  - `upload`: a pinned tensor's copy on the copy stream; `uploaded` makes
    the compute stream wait (on the card, not the host) for every upload
    issued so far; `upload_staged` fills and uploads the pair's own
    pinned staging buffer, which it keeps across calls (profile 0's
    chunk blobs);
  - `download`: copies device tensors into fresh pinned tensors on the copy
    stream once the compute stream reaches the point it is given (an event)
    or the present, and returns them with the event that ends the copies.

Every device tensor that one stream writes and the other reads is handed to
the caching allocator with `record_stream`, so its memory is not reused
while the other stream may still read it. The CPU takes none of this: a
call on "cpu" runs on the plain versions with no streams and no pinning.
"""
from __future__ import annotations

import contextlib
import threading

import torch


def pinned(shape, dtype) -> torch.Tensor:
    """An uninitialised host tensor in pinned memory (raises where no card
    is present: pinning needs the CUDA runtime)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class CallStreams:
    """One call's compute stream and copy stream on `device` (a CUDA
    device); the call runs its kernels under `with torch.cuda.stream(
    s.compute)`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.compute = torch.cuda.Stream(device)
        self.copy = torch.cuda.Stream(device)
        self._staging = None  # upload_staged's pinned bytes, kept across calls
        self._staged = None   # the copy stream's event after their last upload

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """`host` (pinned) on the card, copied on the copy stream without
        blocking; read it on the compute stream only after `uploaded()`."""
        with torch.cuda.stream(self.copy):
            t = host.to(self.device, non_blocking=True)
        t.record_stream(self.compute)
        return t

    def upload_staged(self, nbytes: int, fill) -> torch.Tensor:
        """`fill(buf)` writes `nbytes` into buf (a numpy uint8 view of this
        pair's pinned staging bytes), which are then uploaded as upload()
        does. The staging bytes are one buffer, grown to a power of two at
        least the largest `nbytes` asked for and kept with the pair across
        calls, so a call fills pages that are already pinned and touched;
        the fill first waits for the buffer's previous upload to end."""
        if self._staged is not None:
            self._staged.synchronize()
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = None  # the old block goes back before the larger one is taken
            self._staging = pinned(1 << max(nbytes - 1, 0).bit_length(), torch.uint8)
        host = self._staging[:nbytes]
        fill(host.numpy())
        t = self.upload(host)
        self._staged = self.copy.record_event()
        return t

    def uploaded(self) -> None:
        """Makes the compute stream wait (on the card) for every upload
        issued so far."""
        self.compute.wait_event(self.copy.record_event())

    def download(self, tensors, after: torch.cuda.Event | None = None, *,
                 timing: bool = False) -> tuple[list[torch.Tensor], torch.cuda.Event]:
        """Copies `tensors` (on the card) into new pinned host tensors on the
        copy stream, once the compute stream has passed `after` (default: all
        it has been given so far); returns the host tensors and the copy
        stream's event after the copies. The host tensors hold their data
        only once that event has completed."""
        if after is None:
            after = self.compute.record_event()
        self.copy.wait_event(after)
        hosts = []
        with torch.cuda.stream(self.copy):
            for t in tensors:
                h = pinned(t.shape, t.dtype)
                h.copy_(t, non_blocking=True)
                t.record_stream(self.copy)
                hosts.append(h)
            done = torch.cuda.Event(enable_timing=timing)
            done.record(self.copy)
        return hosts, done


# device -> the pairs no call holds now; the lock guards the lists.
_FREE: dict = {}
_FREE_LOCK = threading.Lock()


@contextlib.contextmanager
def call_streams(device: torch.device):
    """A CallStreams on `device` that no other call holds until this one
    returns it: a returned pair where there is one, else a new one."""
    with _FREE_LOCK:
        free = _FREE.setdefault(device, [])
        s = free.pop() if free else CallStreams(device)
    try:
        yield s
    finally:
        with _FREE_LOCK:
            free.append(s)


def for_call(device: torch.device):
    """call_streams(device) on a card; on the CPU a context that yields
    None (no streams)."""
    return call_streams(device) if device.type == "cuda" else contextlib.nullcontext()


def to_host(tensors, streams: CallStreams | None) -> list:
    """numpy copies of `tensors`: through pinned memory on the call's copy
    stream with one wait where the call has streams, else by `.cpu()` (the
    CPU path, and callers outside a compress call)."""
    if streams is None:
        return [t.cpu().numpy() for t in tensors]
    hosts, done = streams.download(tensors)
    done.synchronize()
    return [h.numpy() for h in hosts]
