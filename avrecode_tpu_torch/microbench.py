"""The device chain of one chunk, timed on the card: counterpart of
tools/dev_microbench.py.

    python -m avrecode_tpu_torch.microbench [clip] [--reps N] [--device cuda]
        [--batch-size 4096]

Analyzes the clip (default benchdata/bench.mp4) under profile 2 with the
host model's probabilities, stages every chunk with device.to_torch_staged
(shared tables uploaded once), and checks every chunk's device probs
(device._exec_v4) against the host model's (the differential). Then, on the
largest chunk with its inputs resident, it times:

  expand_ms        ops.model_pass.wire_expand4_blob
  expand_model_ms  device._exec_v4: the expand and model_pass_v4
  chain_ms         the expand, the model pass and the lane scan
                   (ops.lanes.encode_interleaved_start)
  dense_chain_ms   model_pass_v4 and the lane scan on clones of the expand's
                   outputs: the chain without the wire expand
  dense_upload_ms  the upload of those dense planes from pinned host
                   memory on a copy stream, as device.compress uploads
                   (dense_mb of them), the cost of shipping them instead of
                   the wire
  wire_upload_ms   the upload of the same chunk's wire (the fused blob and
                   its scalars, wire_chunk_mb), the same way; the shared
                   dual0 / sig0 tables, which both forms need, are in
                   neither

Each is the best and the median (`<key>_median`) of --reps runs after a
warm-up, timed with torch.cuda.Event pairs around one run that starts on an
idle card, on one set of call streams (streams.CallStreams) whose copy
stream the end event waits for; on --device cpu, with time.perf_counter
around the plain versions. chain_mbins_s and dense_chain_mbins_s are the
chunk's padded bins (m) over the best times; wire_mb is every chunk's
staged bytes. The pair
dense_chain_ms + dense_upload_ms against chain_ms + wire_upload_ms says
whether the wire expand pays for itself on this card's link.

Prints one JSON line, with the card's name and power limit as nvidia-smi
gives them ("cpu" on the CPU), and exits 1, with an `error` key and no
times, when the differential fails. bench.py calls `measure` and
`probs_mismatch` rather than repeating them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import device as td
from . import streams as cs
from .ops import lanes as lx
from .ops import model_pass as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CLIP = os.path.join(REPO, "benchdata", "bench.mp4")


def card(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them; "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    return lines[dev.index or 0]


def one_ms(fn, dev: torch.device, streams: cs.CallStreams | None = None) -> float:
    """Milliseconds of one fn() that starts on an idle card: CUDA events on
    the current stream (the end waits for every kernel and copy fn
    enqueued there, and for `streams`' copy stream), the host clock on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    if streams is not None:
        torch.cuda.current_stream(dev).wait_stream(streams.copy)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def best_median(runs: list[float]) -> tuple[float, float]:
    return min(runs), statistics.median(runs)


def timed(fn, dev: torch.device, reps: int, streams: cs.CallStreams | None = None
          ) -> tuple[float, float]:
    """(best, median) ms of `reps` runs of fn after one warm-up run."""
    fn()
    return best_median([one_ms(fn, dev, streams) for _ in range(reps)])


def stage_all(an, dev: torch.device, streams: cs.CallStreams | None = None) -> list:
    """Every chunk staged on dev, the shared tables uploaded once (through
    `streams` as device.compress stages, where given)."""
    cache: dict = {}
    return [td.to_torch_staged(an, c, dev, cache, streams) for c in an.chunks]


def _uploads(hosts, dev: torch.device, streams: cs.CallStreams | None) -> list:
    """Host tensors on dev: on the copy stream (the compute stream waiting
    for them) where there are streams."""
    if streams is None:
        return [t.to(dev) for t in hosts]
    out = [streams.upload(t) for t in hosts]
    streams.uploaded()
    return out


def probs_mismatch(an, staged) -> str | None:
    """The differential: each chunk's device probs against the host model's
    (exported with the analysis); the first mismatch, or None."""
    for i, (c, st) in enumerate(zip(an.chunks, staged)):
        probs, _ = td._exec_v4(st)
        got = probs[:c.n].cpu().numpy().astype(np.uint16)
        if not np.array_equal(got, c.host_probs):
            bad = int(np.flatnonzero(got != c.host_probs)[0])
            return f"device/host probs mismatch on chunk {i} (first at bin {bad})"
    return None


def measure(an, staged, dev: torch.device, reps: int) -> dict:
    """The timings of the module docstring on the largest staged chunk."""
    big = max(range(len(staged)), key=lambda i: staged[i].n)
    st, c = staged[big], an.chunks[big]
    K = td.pick_lanes(st.n)
    model = st.statics["model"]

    def expand():
        return mp.wire_expand4_blob(st.blob, st.sc, **st.statics["expand"])

    def chain():
        probs, bits = td._exec_v4(st)
        return lx.encode_interleaved_start(bits, probs, st.n, K)

    ex = expand()
    dense = [t.clone() for t in ex]  # bit, kind, slot, prior, deltas, dk_d, dk_s

    def dense_chain():
        bit, kind, slot, prior, deltas, dk_d, dk_s = dense
        probs, bits = mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                       sig0_idx=st.s_idx, sig0_val=st.s_val, **model)
        return lx.encode_interleaved_start(bits, probs, st.n, K)

    dense_host = [t.cpu() for t in dense]
    blob, sc = td._build_blob4(an, c, td._chunk_layout(c))
    wire_host = [td._wire(blob), td._wire(sc)]
    if dev.type == "cuda":
        dense_host, wire_host = ([cs.pinned(t.shape, t.dtype).copy_(t) for t in hosts]
                                 for hosts in (dense_host, wire_host))
    out = {"chunk": big, "chunk_bins": st.n, "m": st.m, "lanes": K, "reps": reps}
    with cs.for_call(dev) as streams, torch.cuda.stream(streams and streams.compute):
        for key, fn in (("expand_ms", expand), ("expand_model_ms", lambda: td._exec_v4(st)),
                        ("chain_ms", chain), ("dense_chain_ms", dense_chain),
                        ("dense_upload_ms", lambda: _uploads(dense_host, dev, streams)),
                        ("wire_upload_ms", lambda: _uploads(wire_host, dev, streams))):
            out[key], out[key + "_median"] = timed(fn, dev, reps, streams)
    out["chain_mbins_s"] = st.m / out["chain_ms"] / 1e3
    out["dense_chain_mbins_s"] = st.m / out["dense_chain_ms"] / 1e3
    out["dense_mb"] = sum(t.nbytes for t in dense_host) / 1e6
    out["wire_chunk_mb"] = sum(t.nbytes for t in wire_host) / 1e6
    out["wire_mb"] = sum(s.wire_nbytes for s in staged) / 1e6
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode_tpu_torch.microbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("clip", nargs="?", default=DEFAULT_CLIP)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their plain versions")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="bins per model batch (small clips may need 512-1024)")
    args = p.parse_args(argv)
    dev = td._device(args.device)
    with open(args.clip, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    an = td.analyze(data, batch_size=args.batch_size, model_profile=2, want_probs=True)
    print(f"microbench: analyze {time.perf_counter() - t0:.2f} s ({len(an.chunks)} chunks)",
          file=sys.stderr, flush=True)
    staged = stage_all(an, dev)
    report = {"clip": os.path.basename(args.clip), "card": card(dev),
              "batch_size": args.batch_size}
    err = probs_mismatch(an, staged)
    report["differential_ok"] = err is None
    if err is not None:
        print(json.dumps({**report, "error": err}))
        return 1
    report.update(measure(an, staged, dev, args.reps))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
