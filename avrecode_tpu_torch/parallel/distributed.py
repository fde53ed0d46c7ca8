"""Corpus-scale recompression over several processes (torch.distributed).

Counterpart of avrecode_tpu/parallel/distributed.py:
  - files (independent work units) are dealt round-robin to the processes;
  - within a process, files run on a thread pool: the C++ analysis releases
    the interpreter lock, so one file's host walk overlaps another's device
    work;
  - the scalar stats merge across processes with one all-reduce of a
    4-entry int64 vector, the only collective.

init_distributed reads the same JAX_COORDINATOR / JAX_NUM_PROCESSES /
JAX_PROCESS_ID variables as the JAX package's CLI, so one launch script
drives both; the process group is gloo over TCP (the stats vector is a host
tensor).
"""
from __future__ import annotations

import concurrent.futures as _fut
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .. import _native, host, trace
from .. import device as dev


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Joins the process group when a multi-process run is configured
    (`coordinator` "host:port", or JAX_COORDINATOR); returns (process index,
    process count). With no coordinator it does nothing and returns (0, 1):
    the local path needs no cluster set-up."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR", "")
    if coordinator and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            rank=process_id if process_id is not None
            else int(os.environ.get("JAX_PROCESS_ID", "0")))
    return _process()


def _process() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class CorpusReport:
    files: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    failures: int = 0
    wall_s: float = 0.0
    per_file: list = field(default_factory=list)  # (path, in, out, seconds)

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 1.0


def _compress_one(path: str, out_dir: str, use_device: bool, chunk_mode: int,
                  batch_size: int, verify: bool, device: str | torch.device = "cuda",
                  submitted_ns: int = 0) -> tuple[str, int, int, float]:
    """One file on a worker thread: read, compress, verify, write. Its root
    span `corpus.file` (trace.py) holds `corpus.queued` from
    `submitted_ns` (when the recorder is on), `corpus.read`, the `call`
    tree of device.compress, `corpus.verify` and `corpus.write`."""
    with trace.root("corpus.file") as sc:
        if submitted_ns:
            sc.add("corpus.queued", submitted_ns, sc.root.start_ns)
        with sc.span("corpus.read"):
            with open(path, "rb") as f:
                data = f.read()
        sc.root.count = len(data)
        t0 = time.time()
        if use_device:
            comp, _ = dev.compress(data, chunk_mode=chunk_mode, batch_size=batch_size,
                                   device=device)
        else:
            comp, _ = host.compress(data, chunk_mode=chunk_mode, batch_size=batch_size)
        if verify:
            with sc.span("corpus.verify"):
                back, _ = host.decompress(comp)
            if back != data:
                raise RuntimeError(f"roundtrip mismatch for {path}")
        out_path = os.path.join(out_dir, os.path.basename(path) + ".atrc")
        # Atomic write: an output that exists is complete, so a resumed run can
        # trust existence (an interrupted write leaves only the .tmp).
        tmp_path = out_path + ".tmp"
        with sc.span("corpus.write"):
            with open(tmp_path, "wb") as f:
                f.write(comp)
            os.replace(tmp_path, out_path)
        return out_path, len(data), len(comp), time.time() - t0


def _resume_done(path: str, out_dir: str) -> tuple[str, int, int, float] | None:
    """The completed-file record if `path` was already recompressed: the
    output exists (outputs are written atomically) and carries the ATRC
    magic and the current container version (an older container would no
    longer decompress, so it is redone, not skipped)."""
    out_path = os.path.join(out_dir, os.path.basename(path) + ".atrc")
    try:
        with open(out_path, "rb") as f:
            hdr = f.read(5)
        if hdr[:4] != b"ATRC" or len(hdr) < 5 or hdr[4] != host.container_version():
            return None
        return out_path, os.path.getsize(path), os.path.getsize(out_path), 0.0
    except OSError:
        return None


def corpus_compress(paths: list[str], out_dir: str, *, use_device: bool = False,
                    chunk_mode: int = 1, batch_size: int = 4096, verify: bool = True,
                    host_workers: int = 2, resume: bool = False,
                    device: str | torch.device = "cuda") -> CorpusReport:
    """Recompresses a corpus, dealt across the processes of the group.

    Each process takes every process_count-th file of the sorted list from
    its index on; use_device runs the port's compress on `device` (the
    kernels on "cuda", their plain versions on "cpu"), otherwise the host
    engine. Files run on `host_workers` threads. The merged report (all
    files) comes back on every process through one all-reduce."""
    pidx, pcount = _process()
    os.makedirs(out_dir, exist_ok=True)
    if use_device:
        # Build and bind both libraries once, before the pool starts: the
        # threads would otherwise race to build them.
        host.lib()
        if torch.device(device).type == "cuda":
            _native.load()
    mine = [p for i, p in enumerate(sorted(paths)) if i % pcount == pidx]
    rep = CorpusReport()
    t0 = time.time()
    if resume:
        remaining = []
        for p in mine:
            done = _resume_done(p, out_dir)
            if done is not None:
                rep.files += 1
                rep.input_bytes += done[1]
                rep.output_bytes += done[2]
                rep.per_file.append(done)
            else:
                remaining.append(p)
        mine = remaining
    with trace.root("corpus.pool", count=len(mine)) as sc, \
            _fut.ThreadPoolExecutor(max_workers=max(1, host_workers)) as ex:
        futs = {ex.submit(_compress_one, p, out_dir, use_device, chunk_mode, batch_size,
                          verify, device, time.monotonic_ns() if sc.recording else 0): p
                for p in mine}
        for fu in _fut.as_completed(futs):
            try:
                out_path, n_in, n_out, secs = fu.result()
            except Exception:  # a failed file is counted, and the run goes on
                print(f"corpus: {futs[fu]} failed:", file=sys.stderr, flush=True)
                traceback.print_exc()
                rep.failures += 1
                continue
            rep.files += 1
            rep.input_bytes += n_in
            rep.output_bytes += n_out
            rep.per_file.append((out_path, n_in, n_out, secs))
    rep.wall_s = time.time() - t0

    if pcount > 1:
        local = torch.tensor([rep.files, rep.input_bytes, rep.output_bytes, rep.failures],
                             dtype=torch.int64)
        total = _psum_across_processes(local)
        rep.files, rep.input_bytes, rep.output_bytes, rep.failures = (int(v) for v in total)
    return rep


calls = {"_psum_across_processes": 0}  # collectives this process has issued


def _psum_across_processes(x: torch.Tensor) -> torch.Tensor:
    """Sums a small int64 host vector over every process of the group (one
    all-reduce; each process contributes its value once). The JAX package
    needs a shard_map psum over a device mesh for this; here it is the
    process group's collective."""
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    calls["_psum_across_processes"] += 1
    return total
