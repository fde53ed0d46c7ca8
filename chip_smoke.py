#!/usr/bin/env python3
"""Proof that the PyTorch + CUDA port (avrecode_tpu_torch) runs on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases; any failure ends the script with a nonzero exit code:

1. build: the port's CUDA kernels (one nvcc per source under
   avrecode_tpu_torch/csrc, sm_90a) and the port's own host library (g++
   over its copy of the C++ engine, avrecode_tpu_torch/native, into
   avrecode_tpu_torch/build/libartc_host.so), all at once, after a line
   that names the host compiler (`g++ --version`) and its flags;
2. kernels: every kernel against its plain PyTorch version on the same
   inputs, timed with CUDA events, with its bound (bytes or operations over
   the card's peak rates, and for the two lane scans their serial chain:
   the longest lane's valid steps x the 5 dependent instructions of the
   recurrence's step (fewer if the consumer's block in the built kernel's
   SASS, read with cuobjdump, has a shorter chain) x 4 cycles at the card's
   max SM clock; for the two per-batch passes the batch chain: the batches
   x an L2 round trip and four dependent instructions): at the full shapes
   of benchdata/bench.mp4's chunks
   (profile 2: every chunk; profile 0: chunk 0 at batch 4096, sup 128), on
   random lane streams (K in {16, 128}, the probability extremes, valid
   masks that are not a prefix; K in {1, 7, 33}, whose 32-lane groups are
   ragged, dense and over a chunk axis with a ragged mask), and at the
   mesh-uniform shapes of benchdata/multigop720.mp4 (chunk mode 1): the
   mesh-mode expand on every chunk, the model pass over the chunk axis on
   all chunks at once, the lane-sliced masked scan on one chunk; then both
   mesh steps, each against the same step on a grid of CPU devices (the
   plain versions), and the product step's device time on a 1x1, a 2x2 and
   a 4x2 grid of this one card (cells on their own streams), the 4x2 grid
   of both steps held exact too.
   The dual0 expand (row 2) takes the dictionary at its wire widths, as
   staged; it is also held against its plain version on synthetic
   dictionaries (avrecode_tpu_torch/testing.py: no escapes, escapes at row
   0 and row n_dual - 1, blocks with only padding escapes, a short
   dictionary, a block of escapes only, 70,000 escapes; n_dual never a
   multiple of the block), and its launch floor (an empty kernel through
   the same wrapper path) is timed beside it.
   The expand is also held against its plain version on synthetic blobs
   (avrecode_tpu_torch/testing.py: live COO entries past the runs, slots
   past their row, no escapes, m and U not multiples of 4, U = 16,384, no
   COO entry at all) and the compaction at K in {1, 7, 33, 128} with ragged
   tiles, silent lanes and maxW below a lane's count; the expand's launches
   a call are printed for one mesh chunk and for all of them, and must not
   grow with the chunks.
   The two per-batch passes (model_pass_dict, model_pass) are also held
   against their plain versions on rows far over their windows, kind-3 and
   pad bins on the scratch key, 1, 3 and 70 batches, batches of 512, 4096
   and 12288 and a chunk axis of 3, with their pre-pass and their chain
   timed apart and the launches a call makes printed.
   The v2 fallback: bench.mp4's profile-0 chunk 0 without the native v2
   tables, which device_probs builds on the host, equals the host model
   and run_chunk_v2_tables.
   Profile 0's card route (ops/dense.py): dense_expand and dense_lanes
   against their plain versions and the host route's staging
   (v2_tables_inputs, interleaved_planes) on every profile-0 chunk of
   both clips, timed with the staging both ways (the host route's
   pageable uploads and probs download against the pack into pinned
   memory and its one upload) on perfbench/clips/camera1080.mp4's largest
   chunk, the cell p0_v2.archive's.
   All values are integers, so the tolerance is 0;
3. main paths, each with the launch counters set to 0 just before it and
   read just after:
   - compress(device="cuda") under profile 2 on bench.mp4 and
     multigop720.mp4 (one warm-up, best of 3): probs == host model, lane
     blobs == C++ encoder, exact roundtrip, and `wire_bytes` == the nbytes
     of the arrays the staging builds (printed beside it; the comparison
     with the JAX package's count is tests/test_torch_wire.py's);
   - compress(model_profile=0) with ARTC_MODEL_IMPL=v2 on both clips (one
     warm-up, best of 3), dict, sort and mm once each on bench.mp4: the same
     checks, and the containers identical across impls;
   - compress_mesh on multigop720.mp4 (chunk mode 1, batch 4096, sup 128,
     16 lanes) on a 1x1, a 2x2 (four cells on cuda:0, or four cards where
     there are four) and a 4x2 grid (eight cells on cuda:0; one warm-up,
     best of 3): each container == the single-device container, exact
     roundtrip;
   - sharded_recompress_step (the pre-ANL5 mesh step) on a 2x2 grid: probs
     == the single-device model_pass of each chunk;
   - the modules a user calls besides compress, on bench.mp4 (the
     profile-2 kernels must launch here too): the CLI with --device cuda
     (compress, whose container must equal compress(device="cuda")'s;
     info on it; decompress back to the input; roundtrip --bill),
     pipeline.roundtrip, format_bill's table, MODEL_FAMILIES["refprior"]
     against the analysis header and ops/intmath.py, the microbench
     (--reps 5) and the bench (--reps 3 --host-reps 3) with their gates
     passing; their JSON lines are printed, with the phase's seconds;
   - the transfers (each call's own compute and copy streams, pinned host
     memory): a torch.profiler pass over one compress on bench.mp4 and one
     compress_mesh on multigop720.mp4 (1x1) prints every memcpy kind with
     its count and bytes, and fails on a pageable one or on a mesh
     download other than 3 bytes a (step, lane) slot (plus the final states
     and the total); chunk i-1's counts readback must end before chunk i's
     lane scan does (CUDA events); two compress calls at once from two
     threads must each equal the call alone, and multigop720.mp4 at chunk
     mode 1, three times, the single-device container;
   - the corpus: two processes joined over gloo, each `cli corpus --device
     cuda --chunk-mode 1` over benchdata/*.mp4: both report the same merged stats, no
     failures, and every output roundtrips;
   - corpus_clips: every clip of the frozen test corpus
     (avrecode_tpu_torch/testdata/corpus: 4:2:2, 4:4:4, 10-bit, mono,
     MBAFF, PAFF, PCM, CAVLC, SP, separate planes, eight containers) in
     every mode of its manifest entry (profile 2 at batch 4096 and 512, GOP
     chunks, 4 lanes, profile 0, the mesh on a 2x2 grid, warm sections): the
     container's SHA-256 == the JAX package's in the manifest (or the same
     error), per chunk probs == host model and lane blob == C++ encoder,
     exact roundtrip, profile 0's dict, sort and mm == v2; then every kernel
     those runs launched against its plain version on each chunk's staged
     inputs (avrecode_tpu_torch/testcorpus.py), one line a clip and a
     totals line;
4. the JAX package untouched: no file or directory under avrecode_tpu/
   created or changed during the run (paths, sizes and mtimes before the
   build and after the last phase), and no file under it mapped by this
   process (/proc/self/maps) after the last phase.

The last lines are the card's name and power limit as nvidia-smi reports
them, the per-kernel JSON and the result JSON.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CLIPS = ("benchdata/bench.mp4", "benchdata/multigop720.mp4")
MESH_CLIP = "benchdata/multigop720.mp4"
BATCH, SUP = 4096, 128  # the compress path's defaults
MESH_LANES = 16  # force_lanes of the mesh gate (__graft_entry__.py)
# The JAX package's directory: watched, never read (phase 4).
JAX_PKG = os.path.join(REPO, "avrecode_tpu")
PROFILE2_KERNELS = ("wire_expand", "dual0_expand", "model_pass_v4", "lane_scan_dev",
                    "lane_compact")
PROFILE0_KERNELS = ("model_pass_v2", "model_pass_dict", "model_pass", "lane_scan",
                    "lane_compact", "dense_expand", "dense_lanes")
# The cell p0_v2.archive's file: the dense kernels are timed on its largest
# profile-0 chunk.
DENSE_CLIP = "perfbench/clips/camera1080.mp4"
MESH_KERNELS = ("wire_expand", "model_pass_v4", "lane_scan", "sharded_v4_compress_step")
RECOMPRESS_KERNELS = ("model_pass", "lane_scan", "sharded_recompress_step")
# The corpus_clips phase's plain versions run in this many processes on the
# host CPU, beside this one.
CORPUS_WORKERS = max(1, (os.cpu_count() or 4) - 2)
CORPUS_CLIPS_KERNELS = (*PROFILE2_KERNELS, "model_pass_v2", "model_pass_dict", "model_pass",
                        "lane_scan", "sharded_v4_compress_step")
IMPLS = ("v2", "dict", "sort", "mm")
# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, taken for the kernels' int32
# operations (the card's int32 rate is not higher, so the bound stays a
# lower bound).
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
# The lane scans' third bound, their serial chain: the longest lane's valid
# steps x the dependent instructions of one step x this many cycles each, at
# the card's max SM clock. A step of the recurrence is DEP_PER_STEP dependent
# instructions (compare, select, multiply-high, shift, multiply-add); the
# bound takes fewer only where the built kernel's SASS shows a shorter chain.
CYCLES_PER_DEP = 4
DEP_PER_STEP = 5
# The two per-batch passes' third bound, their batch chain: batch b + 1 reads
# rows as batch b left them, so no implementation avoids, per batch, a row
# load, the update's dependent instructions (add the totals, add the pair,
# compare with the window, select) and a store the next load can see. The
# tables (over 1 MB at bench size) do not fit one SM's shared memory, so the
# round trip goes through L2: taken as 200 cycles, a round figure under the
# 260-270 cycles that published microbenchmarks of the H100 give for an L2
# hit, and the store as free, so that the figure stays a lower bound. The
# probabilities' divisions are not on this chain (the next batch does not
# read them). Nothing here is read from the built kernels.
L2_HIT_CYCLES = 200
PASS_STEP_CYCLES = L2_HIT_CYCLES + 4 * CYCLES_PER_DEP


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bucket(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_median(fn, calls: int) -> float:
    """Median device time of single calls of fn() (CUDA events around each
    call on the current stream), after two warm-up calls: steps that issue
    work from the host vary from call to call."""
    import statistics
    import torch
    fn()
    fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_timed(fn):
    """(fn(), host seconds of one call ending in a device synchronise)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching tensors (int64 math, on a's device);
    raises on a shape or dtype mismatch."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.dtype == torch.uint16:  # widen through int16 bit patterns
        a, b = (t.view(torch.int16).long() & 0xFFFF for t in (a, b))
    b = b.to(a.device)
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def c_rans_encode(bits, probs, lanes: int) -> bytes:
    """The host C++ rANS encoder (native/rans.h) through the C ABI."""
    from avrecode_tpu_torch import host
    return host.rans_encode(bits, probs, lanes)


def roundtrip_ok(comp: bytes, data: bytes) -> bool:
    from avrecode_tpu_torch import host
    return host.decompress(comp)[0] == data


class Kernels:
    """Per-kernel results: worst error over all comparisons, the device
    times of the kernel and its plain version at main-path shapes, and the
    work (bytes moved, operations) that gives its bound."""

    # _native.launches counter -> (kernel source, the JAX function it replaces)
    SOURCES = {
        "wire_expand": ("avrecode_tpu_torch/csrc/wire_expand.cu",
                        "avrecode_tpu/ops/model_pass.py:257"),
        "dual0_expand": ("avrecode_tpu_torch/csrc/model_pass.cu",
                         "avrecode_tpu/ops/model_pass.py:226"),
        "model_pass_v4": ("avrecode_tpu_torch/csrc/model_pass.cu",
                          "avrecode_tpu/ops/model_pass.py:405"),
        "lane_scan_dev": ("avrecode_tpu_torch/csrc/lanes.cu", "avrecode_tpu/ops/lanes.py:61"),
        "lane_compact": ("avrecode_tpu_torch/csrc/lanes.cu", "avrecode_tpu/ops/lanes.py:94"),
        "model_pass_v2": ("avrecode_tpu_torch/csrc/model_pass.cu",
                          "avrecode_tpu/ops/model_pass.py:111"),
        "lane_scan": ("avrecode_tpu_torch/csrc/lanes.cu", "avrecode_tpu/ops/lanes.py:26"),
        "model_pass_dict": ("avrecode_tpu_torch/csrc/model_pass.cu",
                            "avrecode_tpu/ops/model_pass.py:530"),
        "model_pass": ("avrecode_tpu_torch/csrc/model_pass.cu",
                       "avrecode_tpu/ops/model_pass.py:636"),
        # profile 0's staging, which the JAX package does on the host
        "dense_expand": ("avrecode_tpu_torch/csrc/wire_expand.cu",
                         "avrecode_tpu/ops/model_pass.py:901"),
        "dense_lanes": ("avrecode_tpu_torch/csrc/wire_expand.cu",
                        "avrecode_tpu/ops/lanes.py:196"),
    }
    # The mesh steps: the kernels each one launches (their counters).
    STEPS = {
        "sharded_v4_compress_step": ("avrecode_tpu_torch/parallel/pipeline.py",
                                     "avrecode_tpu/parallel/pipeline.py:31",
                                     ("wire_expand", "model_pass_v4", "lane_scan")),
        "sharded_recompress_step": ("avrecode_tpu_torch/parallel/pipeline.py",
                                    "avrecode_tpu/parallel/pipeline.py:107",
                                    ("model_pass", "lane_scan")),
    }
    COLLECTIVE = ("_psum_across_processes", "avrecode_tpu_torch/parallel/distributed.py",
                  "avrecode_tpu/parallel/distributed.py:165")

    def __init__(self):
        self.err = {k: 0 for k in (*self.SOURCES, *self.STEPS)}
        self.ms = {}
        self.plain_ms = {}
        self.work = {}  # name -> (bytes moved, operations)
        self.steps = {}  # serial kernels: name -> the longest lane's valid steps when timed
        self.chain = {}  # serial kernels: name -> dependent instructions per step
        self.chain_cycles = {}  # kernels with a fixed chain: name -> its cycles
        self.sm_clock_hz = 0.0  # the card's max SM clock
        self.mesh_ms = {}  # kernel times at the mesh shapes (printed, not in the JSON)
        self.extra = {}  # name -> further fields of its JSON row

    def check(self, name: str, got, want, what: str) -> None:
        e = max_abs_err(got, want)
        self.err[name] = max(self.err[name], e)
        if e != 0:
            raise AssertionError(f"{name}: kernel != plain on {what} (max abs err {e})")

    def chain_ms(self, name: str, steps: int) -> float:
        """The least time (ms) of a serial kernel's chain of `steps` steps."""
        return steps * self.chain[name] * CYCLES_PER_DEP / self.sm_clock_hz * 1e3

    def bound(self, name: str, work) -> tuple[float, str]:
        """The least time (ms) for `work` = (bytes, operations), and for a
        serial kernel its chain too, and which of them bounds it."""
        nb, ops = work
        times = {"bytes": nb / HBM_BYTES_S * 1e3, "operations": ops / SCALAR_OPS_S * 1e3}
        if name in self.steps:
            times["chain"] = self.chain_ms(name, self.steps[name])
        if name in self.chain_cycles:
            times["chain"] = self.chain_cycles[name] / self.sm_clock_hz * 1e3
        by = max(times, key=times.get)
        return times[by], by

    def _row(self, name, route, src, rep, launches, err, ms, plain_ms, work, **extra):
        bound_ms, bound_by = self.bound(name, work)
        if name in self.steps:
            extra.update(chain_steps=self.steps[name], chain_dep_per_step=self.chain[name],
                         sm_clock_mhz=self.sm_clock_hz / 1e6)
        if name in self.chain_cycles:
            extra.update(chain_cycles=self.chain_cycles[name],
                         sm_clock_mhz=self.sm_clock_hz / 1e6)
        return {"name": name, "route": route, "source": src, "replaces": rep,
                "launches": int(launches), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "bytes": int(work[0]), "ops": int(work[1]), **extra}

    def json_line(self, launches: dict, step_launched: dict, collective: dict) -> str:
        """launches: each counter over the main-path runs, each path counted
        from 0; step_launched: per step, the kernel counters of its own
        main path; collective: the corpus run's measurements of row 12."""
        rows = [self._row(k, "cuda", src, rep, launches[k], self.err[k], self.ms[k],
                          self.plain_ms[k], self.work[k], **self.extra.get(k, {}))
                for k, (src, rep) in self.SOURCES.items()]
        rows += [self._row(k, "cuda", src, rep, launches[k], self.err[k], self.ms[k],
                           self.plain_ms[k], self.work[k],
                           launched={c: step_launched[k][c] for c in kernels},
                           **self.extra.get(k, {}))
                 for k, (src, rep, kernels) in self.STEPS.items()]
        name, src, rep = self.COLLECTIVE
        coll = self._row(name, "torch.distributed (gloo)", src, rep, collective["calls"],
                         collective["err"], collective["ms"], collective["plain_ms"],
                         (collective["bytes"], 0),
                         launched="collective (torch.distributed)")
        return json.dumps({"kernels": rows, "collectives": [coll]})


def scan_launches(K: Kernels, name: str, what: str, key: str = "launches_in_call") -> None:
    """Records the device-side launches of the last v3_core / model_pass_v2
    call and prints them beside the pass's cycle counters (chunk 0)."""
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import model_pass as mp
    n = _native.pass_launches()
    prof = mp.scan_profile()
    K.extra.setdefault(name, {})[key] = n
    K.extra[name][key.replace("launches_in_call", "cycles")] = prof
    print(f"{name} on {what}: {n} launches in a call (kernels, copies and clears); cycles "
          f"(clock64) of stage block 0's thread 0 at work {prof['stage']} and at the barriers "
          f"{prof['stage_wait']}, of the first probability block's thread 0 at work "
          f"{prof['prob']} and at the barriers {prof['prob_wait']}", flush=True)


def kernel_phase(K: Kernels, an, chunks, dev) -> None:
    """Each kernel against its plain version at the chunks' full shapes on
    `dev`; the first chunk also gives the timings and the work."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    for ci, c in enumerate(chunks):
        timed = ci == 0
        st = td.to_torch_staged(an, c, dev)
        what = f"bench chunk {ci} (n={c.n}, m={c.m}, ud={c.ud}, us={c.us})"
        # dual0_expand, on the dictionary at its wire widths, as staged
        d0 = [td._wire(a).to(dev) for a in td._dual0_dict(c)]
        got = mp.dual0_expand(*d0)
        made = _native.dual0_launches()
        K.check("dual0_expand", got, mp._dual0_expand_plain(*d0), what)
        K.check("dual0_expand", st.dual0, got, f"{what}: the staged table")
        if timed:
            K.ms["dual0_expand"] = cuda_ms(lambda: mp.dual0_expand(*d0), 20)
            K.plain_ms["dual0_expand"] = cuda_ms(lambda: mp._dual0_expand_plain(*d0), 5)
            # The launch floor: the same wrapper path launching an empty
            # kernel on the same grid (uncounted), timed the same way.
            floor_ms = cuda_ms(lambda: mp._dual0_expand_cuda(
                *d0, entry="artc_launch_floor"), 20)
            K.extra["dual0_expand"] = {"launches_in_call": made, "launch_floor_ms": floor_ms}
            # a gather of n_dual rows and the escape rows' scatter, 4 columns each
            K.work["dual0_expand"] = (nbytes(*d0, got), 4 * (d0[1].numel() + d0[2].numel()))
            print(f"dual0_expand on {what}: {K.ms['dual0_expand']:.4f} ms a call, the launch "
                  f"floor (an empty kernel through the same wrapper) {floor_ms:.4f} ms",
                  flush=True)
        # wire_expand4_blob
        ex = st.statics["expand"]
        eargs = [ex[k] for k in ("m", "nsub", "U", "ud", "us", "ns", "batch", "layout")]
        got = mp.wire_expand4_blob(st.blob, st.sc, **ex)
        made = _native.expand_launches()
        want = mp._wire_expand_plain(st.blob, st.sc, *eargs)
        for g, w in zip(got, want):
            K.check("wire_expand", g, w, what)
        if timed:
            K.extra.setdefault("wire_expand", {})["launches_in_call"] = made
            K.ms["wire_expand"] = cuda_ms(lambda: mp.wire_expand4_blob(st.blob, st.sc, **ex), 10)
            K.plain_ms["wire_expand"] = cuda_ms(lambda: mp._wire_expand_plain(
                st.blob, st.sc, *eargs), 2)
            # per bin: nibble decode, the rank scans, an unpack and the prior
            # gather (16); per COO entry: an unpack and the delta scatter (8)
            K.work["wire_expand"] = (nbytes(st.blob, st.sc, *got[:5]),
                                     16 * ex["m"] + 8 * ex["layout"][6])
        # model_pass_v4 / v3_core
        bit, kind, slot, prior, deltas, dk_d, dk_s = got
        mo = st.statics["model"]
        margs = (kind, slot, prior, dk_d, dk_s, deltas, st.dual0, mo["batch"], mo["sup"],
                 mo["fast_w"], mo["slow_w"], mo["sig_w"], mo["sig_alpha"], mo["ud"],
                 mo["us"], mo["n_sig"], st.s_idx, st.s_val)

        def kernel_probs():
            return mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                    sig0_idx=st.s_idx, sig0_val=st.s_val, **mo)[0]

        probs = kernel_probs()
        K.check("model_pass_v4", probs, mp._v3_core_plain(*margs), what)
        if not np.array_equal(probs[:c.n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"model_pass_v4: probs != host probs on {what}")
        if timed:
            scan_launches(K, "model_pass_v4", what)
            K.ms["model_pass_v4"] = cuda_ms(kernel_probs, 5)
            K.plain_ms["model_pass_v4"] = cuda_ms(lambda: mp._v3_core_plain(*margs), 1)
            K.work["model_pass_v4"] = (
                nbytes(kind, slot, prior, dk_d, dk_s, deltas, st.dual0, st.s_idx, st.s_val,
                       probs), model_ops(ex["m"], ex["nsub"], ex["U"]))
            # lanes at the main path's shapes
            n = c.n
            lanes = td.pick_lanes(n)
            T = bucket(-(-n // lanes))
            scan = lx.lane_scan_dev(bit, probs, n, T, lanes)
            plain, plain_scan_s = host_timed(lambda: lx._lane_scan_dev_plain(
                bit, probs, n, T, lanes))
            for g, w in zip(scan, plain):
                K.check("lane_scan_dev", g, w, what)
            K.ms["lane_scan_dev"] = cuda_ms(
                lambda: lx.lane_scan_dev(bit, probs, n, T, lanes), 3)
            K.plain_ms["lane_scan_dev"] = plain_scan_s * 1e3
            K.work["lane_scan_dev"] = (8 * n + nbytes(*scan), RANS_STEP_OPS * n)
            K.steps["lane_scan_dev"] = -(-n // lanes)  # lane 0's bins below n
            print(f"lane_scan_dev plain version: one run of its Python step loop "
                  f"(T={T} steps, K={lanes}), timed once on the host clock: "
                  f"{plain_scan_s:.3f} s", flush=True)
            # Where the padded tiles' time goes: the same T and K with every
            # bin valid (the chunk's bins repeated), beside the chunk itself.
            full = T * lanes
            fb, fp = (x.repeat(-(-full // x.numel()))[:full] for x in (bit, probs))
            full_ms = cuda_ms(lambda: lx.lane_scan_dev(fb, fp, full, T, lanes), 3)
            steps, hz = K.steps["lane_scan_dev"], K.sm_clock_hz
            pad_ms = K.ms["lane_scan_dev"] - full_ms * steps / T
            print(f"lane_scan_dev with all {T} steps valid: {full_ms:.3f} ms = "
                  f"{full_ms * 1e-3 * hz / T:.1f} cycles a step; {what}: "
                  f"{K.ms['lane_scan_dev']:.3f} ms = {K.ms['lane_scan_dev'] * 1e-3 * hz / steps:.1f} "
                  f"cycles a valid step ({steps} of {T}); its {T - steps} padded steps then "
                  f"take {pad_ms:.3f} ms = {pad_ms * 1e-3 * hz / max(T - steps, 1):.1f} cycles a step "
                  f"(at the max SM clock)", flush=True)
            _, words, emits, counts = scan
            maxW = bucket(max(int(counts.max()), 1))
            out = lx.lane_compact(words, emits, maxW)
            K.extra["lane_compact"] = {"launches_in_call": _native.compact_launches()}
            K.check("lane_compact", out, lx._lane_compact_plain(words, emits, maxW), what)
            K.ms["lane_compact"] = cuda_ms(lambda: lx.lane_compact(words, emits, maxW), 5)
            K.plain_ms["lane_compact"] = cuda_ms(
                lambda: lx._lane_compact_plain(words, emits, maxW), 3)
            # per step: the emit count's add and compare, one store
            K.work["lane_compact"] = (nbytes(words, emits, out), 3 * words.numel())
        print(f"kernels == plain on {what}", flush=True)
    lane_streams(K, dev)
    dual0_cases(K, dev)


def dual0_cases(K: Kernels, dev) -> None:
    """The dual0 expand on avrecode_tpu_torch/testing.py's dictionaries: no
    escapes, escapes at row 0 and row n_dual - 1, blocks that see only
    padding escapes, a dictionary of fewer than 256 rows, a block of
    escapes only, 70,000 escapes, bench.mp4's shape (no n_dual a multiple
    of the kernel's block), each also with an index vector 5 rows short."""
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import model_pass as mp
    from avrecode_tpu_torch.testing import DUAL0_CASES, dual0_case
    for case in DUAL0_CASES:
        d0 = [td._wire(a).to(dev) for a in dual0_case(case)]
        short = [d0[0], d0[1][:d0[1].shape[0] - 5], *d0[2:]]
        for args, what in ((d0, case), (short, f"{case}, n_dual - 5")):
            K.check("dual0_expand", mp.dual0_expand(*args), mp._dual0_expand_plain(*args),
                    f"the dictionary {what}")
    print(f"dual0_expand == plain on {len(DUAL0_CASES)} synthetic dictionaries "
          f"({', '.join(DUAL0_CASES)}), each also 5 rows short", flush=True)


def expand_compact_cases(K: Kernels, dev) -> None:
    """The expand on avrecode_tpu_torch/testing.py's synthetic blobs and the
    compaction at K in {1, 7, 33, 128} (T not a multiple of the tile and
    under one tile, a silent lane, a lane emitting at every step, maxW at
    the bucket, at the largest count and below it), each kernel against
    its plain version (on CPU copies); the launches a call must stay at
    most 3 (expand) and 2 (compaction)."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    from avrecode_tpu_torch.testing import EXPAND_CASES, expand_case, lane_planes
    made = {}
    for case in (*EXPAND_CASES, "empty_coo_stream"):
        blob, sc, kw = expand_case(case)
        b, s = td._wire(blob), td._wire(sc)
        got = mp.wire_expand4_blob(b.to(dev), s.to(dev), **kw)
        made[case] = _native.expand_launches()
        for g, w in zip(got, mp.wire_expand4_blob(b, s, **kw)):
            K.check("wire_expand", g, w, f"synthetic blob {case}")
    rng = np.random.default_rng(7)
    compact_made = set()
    for lanes in (1, 7, 33, 128):
        for T in (lx._compact_rows(9000, lanes) * 3 + 17, 20):
            words, emits = (torch.from_numpy(a) for a in lane_planes(rng, T, lanes))
            top = max(int(emits.sum(0).max()), 1)
            for maxW in (lx._bucket(top), top, max(top // 3, 1)):
                got = lx.lane_compact(words.to(dev), emits.to(dev), maxW)
                compact_made.add(_native.compact_launches())
                K.check("lane_compact", got, lx._lane_compact_plain(words, emits, maxW),
                        f"K={lanes} T={T} maxW={maxW}")
    if max(made.values()) > 3 or compact_made != {2}:
        raise AssertionError(f"launches a call: expand {made}, compaction {compact_made}")
    print(f"wire_expand == plain on synthetic blobs {list(made)} (launches a call "
          f"{sorted(set(made.values()))}); lane_compact == plain at K in (1, 7, 33, 128) on "
          f"ragged tiles, silent lanes and maxW below a lane's count (launches a call "
          f"{sorted(compact_made)})", flush=True)


# Operations of the model passes (int32, as the kernels do them): per bin
# about 20 (the staged-row gather, the mix with one division, the clamp),
# per staged (sub-batch, slot) about 24 (the delta add and the bounded
# halving). One rANS step is about 10 (select f and c, the emit compare and
# shift, one division and its remainder, the state update).
RANS_STEP_OPS = 10


def model_ops(m: int, nsub: int, U: int) -> int:
    return 20 * m + 24 * nsub * U


def chain_steps(valid) -> int:
    """The steps a lane scan's chain needs on this data: an invalid step is
    the identity, so the most valid steps any one lane (of any chunk) has
    (valid: bool [T, K] or [G, T, K])."""
    return int(valid.sum(-2).max())


def lane_streams(K: Kernels, dev) -> None:
    """Random lane streams (K = 16 and 128, with and without the probability
    extremes): kernel == plain, and the kernel-path blob == the C++ encoder."""
    import numpy as np
    import torch
    from avrecode_tpu_torch.ops import lanes as lx
    rng = np.random.default_rng(2026)
    for lanes in (16, 128):
        for extreme in (False, True):
            n = 200_003
            bits = rng.integers(0, 2, n).astype(np.int32)
            if extreme:  # p = 1 and 32767 (the clamp bounds), both ways round
                probs = np.where(rng.random(n) < 0.5, 1, 32767).astype(np.int32)
            else:
                probs = rng.integers(1, 32768, n).astype(np.int32)
            b = torch.from_numpy(bits).to(dev)
            p = torch.from_numpy(probs).to(dev)
            T = bucket(-(-n // lanes))
            what = f"random stream n={n} K={lanes} extremes={extreme}"
            scan = lx.lane_scan_dev(b, p, n, T, lanes)
            for g, w in zip(scan, lx._lane_scan_dev_plain(b, p, n, T, lanes)):
                K.check("lane_scan_dev", g, w, what)
            _, words, emits, counts = scan
            maxW = bucket(max(int(counts.max()), 1))
            K.check("lane_compact", lx.lane_compact(words, emits, maxW),
                    lx._lane_compact_plain(words, emits, maxW), what)
            blob = c_rans_encode(bits, probs, lanes)
            if lx.encode_interleaved_dev(b, p, n, lanes) != blob:
                raise AssertionError(f"lane blob != C++ encoder on {what}")
            if lx.encode_interleaved(bits, probs, lanes, device=dev) != blob:
                raise AssertionError(f"encode_interleaved blob != C++ encoder on {what}")
            # The masked scan with a mask that is not a prefix: lane-sliced
            # (every third lane off) and ragged.
            valid = rng.random((T, lanes)) < 0.8
            valid[:, ::3] = False
            planes = [torch.from_numpy(np.resize(a, T * lanes).reshape(T, lanes)).to(dev)
                      for a in (bits, probs)]
            args = (*planes, torch.from_numpy(valid).to(dev))
            for g, w in zip(lx.lane_scan(*args), lx._lane_scan_plain(*args)):
                K.check("lane_scan", g, w, what + ", non-prefix valid mask")
            print(f"kernels == plain, blobs == C++ encoder on {what} (and the masked "
                  f"scan on a non-prefix mask)", flush=True)
    ragged_lane_groups(K, dev, rng)


def ragged_lane_groups(K: Kernels, dev, rng) -> None:
    """Lane counts that leave the scans' 32-lane groups ragged (K = 1, 7,
    33): the dense scan on n not a multiple of K (its last ring tile part
    padding), and the masked scan over G = 3 chunks with a ragged mask on a
    lane slice of wider planes (T = 1000, not a multiple of the ring's
    tile), each against its plain version on CPU copies."""
    import numpy as np
    import torch
    from avrecode_tpu_torch.ops import lanes as lx
    for lanes in (1, 7, 33):
        n = lanes * 3001 + lanes // 2
        T = bucket(-(-n // lanes))
        bits = rng.integers(0, 2, n).astype(np.int32)
        probs = np.where(rng.random(n) < 0.2, rng.choice([1, 32767], n),
                         rng.integers(1, 32768, n)).astype(np.int32)
        b, p = (torch.from_numpy(a) for a in (bits, probs))
        scan = lx.lane_scan_dev(b.to(dev), p.to(dev), n, T, lanes)
        for g, w in zip(scan, lx._lane_scan_dev_plain(b, p, n, T, lanes)):
            K.check("lane_scan_dev", g, w, f"n={n} K={lanes} T={T}")
        G, T2, wide = 3, 1000, lanes + 5
        planes = [torch.from_numpy(a) for a in (
            rng.integers(0, 2, (G, T2, wide)).astype(np.int32),
            rng.integers(1, 32768, (G, T2, wide)).astype(np.int32),
            (rng.random((G, T2, wide)) < 0.7) & (rng.random((G, 1, wide)) < 0.9))]
        sliced = [x.to(dev)[:, :, 2:2 + lanes] for x in planes]
        for g, w in zip(lx.lane_scan(*sliced), lx._lane_scan_plain(
                *(x[:, :, 2:2 + lanes] for x in planes))):
            K.check("lane_scan", g, w, f"G={G} T={T2} K={lanes} slice of {wide}, ragged mask")
        print(f"lane scans == plain at K={lanes} (dense n={n}, T={T}; masked G={G}, T={T2}, "
              f"lane slice 2..{2 + lanes} of {wide}, ragged mask)", flush=True)


def pass_stream(rng, nb: int, batch: int, n_dual: int, n_sig: int, scratch_mix: bool):
    """A padded pair stream of nb batches for the per-batch passes: kinds
    0-3, live dual keys below the scratch row n_dual - 1, tagged and zero
    priors, padding (kind 0, the scratch key, bit 0, prior 0) beside kind-3
    bins inside the first batch and at the stream's end."""
    import numpy as np
    n = nb * batch
    p = (0.3, 0.2, 0.2, 0.3) if scratch_mix else (0.45, 0.2, 0.3, 0.05)
    kinds = rng.choice(4, n, p=p).astype(np.int32)
    keys = np.where(kinds == 2, rng.integers(0, n_sig, n),
                    rng.integers(0, n_dual - 1, n)).astype(np.int32)
    bits = rng.integers(0, 2, n).astype(np.int32)
    priors = rng.integers(1, 65536, n).astype(np.int32)
    priors[rng.random(n) < 0.2] = 0
    pad = np.zeros(n, bool)
    pad[n - batch // 3:] = True
    pad[batch // 2: batch // 2 + 40] = True
    kinds[batch // 2 + 40: batch // 2 + 60] = 3
    for a, v in ((kinds, 0), (keys, n_dual - 1), (bits, 0), (priors, 0)):
        a[pad] = v
    return bits, kinds, keys, priors


def pass_tables(rng, n_dual: int, n_sig: int, far=()):
    """Start tables within their windows (the dual one ending in its scratch
    row of ones); the `far` rows, which no bin may read (their products
    would pass 2^31), start with sums about 2^28."""
    import numpy as np
    dual = rng.integers(1, 20, (n_dual, 4)).astype(np.int32)
    sig = rng.integers(0, 20, (n_sig, 2)).astype(np.int32)
    dual[-1] = 1
    for r in far:
        dual[r] = 1 << 27
        sig[r] = 1 << 27
    return dual, sig


def pass_cases(K: Kernels, dev) -> None:
    """model_pass_dict and model_pass against their plain versions on the
    inputs that have broken them before: rows far over their windows (sums
    about 2^28: whole-table halving must go on for several batches), kind-3
    and pad bins on the scratch key inside one batch, 1 and 3 batches,
    batches of 512, 4096 and 12288, more batches than the staging ring
    holds, and model_pass over a chunk axis of 3 with its own tables per
    chunk. The launches a call makes must not depend on the batches."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import model_pass as mp
    kw = dict(fast_w=48, slow_w=640, sig_w=80, sig_alpha=(24 << 16) | 12)
    rng = np.random.default_rng(5)
    made = {"model_pass_dict": set(), "model_pass": set()}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    cases = [("rows far over their windows", 5, 256, 96, 160, False, (7, 50)),
             ("the scratch-key mix, 1 batch", 1, 512, 96, 160, True, ()),
             ("the scratch-key mix, 3 batches", 3, 512, 96, 160, True, ()),
             ("batch 4096", 3, 4096, 3000, 5000, False, ()),
             ("batch 12288", 2, 12288, 3000, 5000, False, ()),
             ("70 batches of 64", 70, 64, 96, 160, False, ())]
    for label, nb, batch, n_dual, n_sig, mix, far in cases:
        bits, kinds, keys, priors = pass_stream(rng, nb, batch, n_dual, n_sig, mix)
        for r in far:
            keys[(keys == r) & (kinds != 3)] = 3
        dual, sig = pass_tables(rng, n_dual, n_sig, far)
        bin_u, dict_keys = mp.build_dicts(kinds, keys, n_dual, batch)
        dargs = [up(a.reshape(nb, batch)) for a in (bits, kinds, priors)] + [
            up(bin_u), up(dict_keys), up(dual),
            up(np.concatenate([sig, np.zeros((1, 2), np.int32)]))]
        sargs = [up(a) for a in (bits, kinds, keys, priors, dual, sig)]
        for name, kern, plain_fn, args in (
                ("model_pass_dict", mp.model_pass_dict, mp._model_pass_dict_plain, dargs),
                ("model_pass", mp.model_pass, mp._model_pass_plain, sargs)):
            got = kern(*args, batch=batch, **kw)
            made[name].add(_native.pass_launches())
            K.check(name, got, plain_fn(*args, batch, *kw.values()), label)
    G, nb, batch = 3, 5, 512
    streams = [pass_stream(rng, nb, batch, 96, 160, g == 2) for g in range(G)]
    tables = [pass_tables(rng, 96, 160, (7, 50) if g == 1 else ()) for g in range(G)]
    for g in range(G):
        keys, kinds = streams[g][2], streams[g][1]
        for r in (7, 50):
            keys[(keys == r) & (kinds != 3)] = 3
    stacked = [up(np.stack([s[i] for s in streams])) for i in range(4)] + [
        up(np.stack([t[i] for t in tables])) for i in range(2)]
    got = mp.model_pass(*stacked, batch=batch, **kw)
    made["model_pass"].add(_native.pass_launches())
    for g in range(G):
        K.check("model_pass", got[g], mp._model_pass_plain(*(a[g] for a in stacked), batch,
                                                           *kw.values()),
                f"chunk {g} of a chunk axis of {G}")
    if any(len(v) != 1 for v in made.values()):
        raise AssertionError(f"launches a call vary with the input: {made}")
    # 20 chunks: more than one launch of the chain clusters holds (resident /
    # 2 chunks a launch), so the launches split and every trip runs.
    G, nb, batch = 20, 2, 512
    streams = [pass_stream(rng, nb, batch, 96, 160, g % 2 == 0) for g in range(G)]
    tables = [pass_tables(rng, 96, 160) for g in range(G)]
    stacked = [up(np.stack([s[i] for s in streams])) for i in range(4)] + [
        up(np.stack([t[i] for t in tables])) for i in range(2)]
    got = mp.model_pass(*stacked, batch=batch, **kw)
    split = _native.pass_launches()
    for g in range(G):
        K.check("model_pass", got[g], mp._model_pass_plain(*(a[g] for a in stacked), batch,
                                                           *kw.values()),
                f"chunk {g} of a chunk axis of {G}")
    made = {k: v.pop() for k, v in made.items()}
    if split <= made["model_pass"]:
        raise AssertionError(f"model_pass over {G} chunks did not split its launch: {split}")
    print(f"model_pass_dict and model_pass == plain on {[c[0] for c in cases]} and model_pass "
          f"over chunk axes of 3 and {G} (own tables per chunk); launches a call, whatever the "
          f"batches: {made}; {split} over {G} chunks (the launch split)", flush=True)


def scan_inputs(rng, G: int, ns: int, sup: int, batch: int, ud: int, us: int, cap: bool,
                n_dual: int = 200, n_sig: int = 300):
    """Random v3_core inputs of G chunks, each with its own tables: kinds
    0-3, sorted-unique key rows per super-step (scratch rows included), warm
    sig rows (some past the table: they drop), and (ones, total) deltas of up
    to 19 a slot and sub-batch, or with `cap` of batch to 4 x batch, so that
    the halving runs its whole bounded count and stops over the window."""
    import numpy as np
    U, m = ud + us, ns * sup * batch
    tot = rng.integers(batch, 4 * batch + 1, (G, ns * sup, U)) if cap else rng.integers(
        0, 20, (G, ns * sup, U))
    tot = np.where(rng.random(tot.shape) < 0.5, 0, tot)
    one = np.minimum((rng.random(tot.shape) * (tot + 1)).astype(np.int64), tot)

    def keys(n, width):
        return np.stack([np.stack([np.sort(rng.choice(n, width, replace=False))
                                   for _ in range(ns)]) for _ in range(G)]).astype(np.int32)

    return dict(
        planes=[rng.integers(0, 4, (G, m)), rng.integers(0, U, (G, m)),
                rng.integers(0, 65536, (G, m))],
        dk_d=keys(n_dual + 1 + ud, ud), dk_s=keys(n_sig + us, us),
        deltas=np.stack([one, tot], -1).astype(np.uint16),
        dual0=rng.integers(1, 30, (G, n_dual, 4)),
        si=rng.integers(0, n_sig + 3, (G, 7)), sv=rng.integers(0, 40, (G, 7, 2)),
        kw=dict(batch=batch, sup=sup, fast_w=48, slow_w=640, sig_w=80,
                sig_alpha=(24 << 16) | 12, ud=ud, us=us, n_sig=n_sig))


def scan_cases(K: Kernels, dev) -> None:
    """v3_core and model_pass_v2 against their plain versions on synthetic
    inputs: a chunk axis of 3 with different tables per chunk, ns = 1,
    deltas that make the halving run its whole bounded count, and 40
    chunks of 8192 slots, more than one launch can hold (the pass splits
    its launches); model_pass_v2 on the first chunk of each. The launches
    a call makes grow only with the split."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import model_pass as mp
    rng = np.random.default_rng(6)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    made = {}
    for label, G, ns, sup, batch, ud, us, cap in (
            ("a chunk axis of 3", 3, 3, 9, 256, 300, 200, False),
            ("ns = 1", 1, 1, 16, 512, 400, 100, False),
            ("the whole halving count", 2, 3, 17, 64, 200, 120, True),
            ("40 chunks of 8192 slots", 40, 1, 2, 64, 4096, 4096, False)):
        x = scan_inputs(rng, G, ns, sup, batch, ud, us, cap)
        args = [up(a) for a in (*x["planes"], x["dk_d"], x["dk_s"])] + [
            torch.from_numpy(x["deltas"].view(np.int16)).to(dev).view(torch.uint16),
            up(x["dual0"])]
        si = up(x["si"])
        sv = torch.from_numpy(x["sv"].astype(np.int16)).to(dev)  # u16 on the wire
        got = mp.v3_core(args[0], *args, sig0_idx=si, sig0_val=sv, **x["kw"])
        made[label] = _native.pass_launches()
        K.check("model_pass_v4", got, mp._v3_core_plain(*args, *x["kw"].values(), si, sv),
                f"synthetic v3_core, {label}")
        if G == 40:
            continue
        # model_pass_v2 on chunk 0: split deltas, extended tables, prefix adders
        sh = (ns, sup, batch)
        pret = rng.integers(0, 10, sh)
        pre1 = np.minimum((rng.random(sh) * (pret + 1)).astype(np.int64), pret)
        d = x["deltas"][0].astype(np.int32).reshape(ns, sup, ud + us, 2)
        kw = {k: x["kw"][k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha")}
        v2_args = [up(x["planes"][0][0].reshape(sh)), up(x["planes"][2][0].reshape(sh)),
                   up(pre1), up(pret), up(x["planes"][1][0].reshape(sh)), up(x["dk_d"][0]),
                   up(x["dk_s"][0]), up(d[:, :, :ud]), up(d[:, :, ud:]),
                   up(np.concatenate([x["dual0"][0], np.ones((1 + ud, 4))])),
                   up(np.concatenate([rng.integers(0, 30, (300, 2)), np.ones((us, 2))]))]
        got = mp.model_pass_v2(*v2_args, **kw)
        made[f"model_pass_v2, {label}"] = _native.pass_launches()
        K.check("model_pass_v2", got, mp._model_pass_v2_plain(*v2_args, *kw.values()),
                f"synthetic model_pass_v2, {label}")
    # a barrier clear, the table init, the sig0 scatter and one pass; two
    # table copies, a clear and one pass
    split = made.pop("40 chunks of 8192 slots")
    if split <= 4 or any(v != 4 for v in made.values()):
        raise AssertionError(f"launches a call: {made}, 40 chunks of 8192 slots {split}")
    print(f"v3_core and model_pass_v2 == plain on synthetic inputs; launches a call: {made}, "
          f"40 chunks of 8192 slots (split): {split}", flush=True)


def profile0_kernel_phase(K: Kernels, an, dev) -> None:
    """The profile-0 kernels against their plain versions at the shapes of
    the analysis's chunk 0 (bench.mp4 at batch 4096, sup 128), timed there;
    every kernel's probs also equal the host model's."""
    import numpy as np
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    c = an.chunks[0]
    n = len(c.bit)
    ns, ud = c.v2_dk_d.shape
    us = c.v2_dk_s.shape[1]
    what = f"profile-0 bench chunk 0 (n={n}, m={c.v2_m}, ns={ns}, ud={ud}, us={us})"

    def host_equal(name, probs):
        if not np.array_equal(probs[:n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"{name}: probs != host probs on {what}")

    # model_pass_v2 on the native export's tables, staged as the main path does
    v2_args, kw = mp.v2_tables_inputs(
        c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d, c.v2_dk_s,
        c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w,
        an.sig_alpha, an.n_sig, device=dev)
    statics = [kw[k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha")]

    def v2():
        return mp.model_pass_v2(*v2_args, **kw)

    def v2_plain():
        return mp._model_pass_v2_plain(*v2_args, *statics)

    got, plain = v2(), v2_plain()
    K.check("model_pass_v2", got, plain, what)
    host_equal("model_pass_v2", got)
    scan_launches(K, "model_pass_v2", what)
    K.ms["model_pass_v2"] = cuda_ms(v2, 5)
    K.plain_ms["model_pass_v2"] = cuda_ms(v2_plain, 1)
    # v4's work plus the per-bin prefix adders on six columns
    K.work["model_pass_v2"] = (nbytes(*v2_args, got),
                               model_ops(c.v2_m, ns * an.sup, ud + us) + 6 * c.v2_m)
    print(f"model_pass_v2 == plain == host on {what}", flush=True)

    # The v2 fallback: the chunk without the native tables, which
    # device_probs then builds on the host (run_chunk_v2), as JAX does.
    bare = dataclasses.replace(c, v2_bin_u=None, v2_dk_d=None, v2_dk_s=None, v2_dd=None,
                               v2_ds=None)
    fallback, fallback_s = host_timed(lambda: td.device_probs(an, bare, dev, impl="v2"))
    tables_probs = mp.run_chunk_v2_tables(
        c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d, c.v2_dk_s,
        c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w,
        an.sig_alpha, an.n_sig, device=dev)
    if not (np.array_equal(fallback, c.host_probs) and np.array_equal(fallback, tables_probs)):
        raise AssertionError(f"device_probs(impl='v2') without the native tables != host "
                             f"probs / run_chunk_v2_tables on {what}")
    print(f"v2 fallback (tables built on the host, model_pass_v2 on the card) == host == "
          f"run_chunk_v2_tables on {what}: {fallback_s:.3f} s on the host clock", flush=True)

    # model_pass_dict and model_pass on run_chunk's padded layout
    common = (c.bit, c.kind, c.key, c.prior, c.dual0, an.batch, an.fast_w, an.slow_w,
              an.sig_w, an.sig_alpha, an.n_sig)
    dargs, pkw = mp.run_chunk_inputs(*common, "dict", device=dev)
    sargs, _ = mp.run_chunk_inputs(*common, "sort", device=dev)
    pstatics = [pkw[k] for k in ("batch", "fast_w", "slow_w", "sig_w", "sig_alpha")]
    nb, U = dargs[4].shape
    m = nb * an.batch
    n_dual = c.dual0.shape[0]
    dict_keys = dargs[4].cpu().numpy()
    kind_p, key_p = (sargs[i].cpu().numpy() for i in (1, 2))
    # The least work of the function, whatever the implementation: a
    # sort-sized count of earlier equal keys per batch (log2(batch)
    # compare-exchanges of 2 operations a bin), one probability a bin (20),
    # and one update with its halving per touched row of each batch (40):
    # dict's live entries, or the batch's distinct unified keys.
    touched = {"model_pass_dict": int((dict_keys != n_dual).sum()) + nb,
               "model_pass": int(sum(len(np.unique(u)) for u in np.where(
                   kind_p == 3, n_dual, np.where(kind_p == 2, key_p.astype(np.int64)
                                                 + n_dual + 1, key_p)).reshape(nb, an.batch)))}
    sort_ops = 2 * (an.batch - 1).bit_length() * m
    raw = {"model_pass_dict": (mp._model_pass_dict_cuda, dargs),
           "model_pass": (mp._model_pass_cuda, [a[None] for a in sargs])}
    for name, kern, plain_fn, args, extra in (
            ("model_pass_dict", mp.model_pass_dict, mp._model_pass_dict_plain, dargs, {}),
            ("model_pass", mp.model_pass, mp._model_pass_plain, sargs, {"impl": "mm"})):
        got = kern(*args, **pkw, **extra)
        made = _native.pass_launches()
        plain, plain_s = host_timed(lambda: plain_fn(*args, *pstatics))
        K.check(name, got, plain, f"{what}, {nb} batches of {an.batch}")
        host_equal(name, got)
        K.ms[name] = cuda_ms(lambda: kern(*args, **pkw, **extra), 5)
        K.plain_ms[name] = plain_s * 1e3
        K.work[name] = (nbytes(*args, got), sort_ops + 20 * m + 40 * touched[name])
        K.chain_cycles[name] = nb * PASS_STEP_CYCLES
        # The pre-pass and the chain apart, on one set of working buffers.
        fn, rargs = raw[name]
        w = mp._pass_scratch(dev, 1, nb, an.batch, U if name == "model_pass_dict" else an.batch,
                             rargs[-2].shape[-2], rargs[-1].shape[-2])
        def part(ph):
            return cuda_ms(lambda: fn(*rargs, *pstatics, phases=ph, scratch=w), 5)

        parts = [part(1), part(4)]
        fn(*rargs, *pstatics, phases=5, scratch=w)  # repeated totals had piled up
        parts.append(part(2))
        prof = mp.pass_profile(w)  # of the last chain run
        K.check(name, w["probs"][0], plain, f"{what}: the chain on an earlier pre-pass")
        print(f"{name} == plain == host on {what} ({nb} batches, U={U}, {touched[name]} "
              f"touched rows); {made} launches a call (kernels, copies and clears; they do "
              f"not grow with the batches); pre-pass: the ordered walk {parts[0]:.3f} ms, the "
              f"totals {parts[1]:.3f} ms; chain with the probabilities {parts[2]:.3f} ms = "
              f"{parts[2] * 1e3 / nb:.3f} us a batch; cycles a batch (clock64) of the chain "
              f"cluster's block 0, thread 0: {prof['barrier'] // nb} at the cluster barrier "
              f"(the barrier and the slowest warp), {prof['copies'] // nb} waiting for the "
              f"entries' copies, {prof['body'] // nb} from its row loads to its stores, "
              f"{prof['rest'] // nb} the rest, and {prof['ring'] // nb} held up by a full "
              f"ring; the first consumer block worked {prof['consumer_work']} and waited "
              f"{prof['consumer_wait']} cycles; plain "
              f"version timed once on the host clock: {plain_s:.3f} s", flush=True)
    pass_cases(K, dev)

    # lane_scan at this chunk's K and T, the encode_interleaved layout
    lanes = td.pick_lanes(n)
    *lane_planes, valid = lx.interleaved_planes(c.bit, c.host_probs, lanes, dev)
    T = valid.shape[0]
    scan = lx.lane_scan(*lane_planes, valid)
    plain, plain_s = host_timed(lambda: lx._lane_scan_plain(*lane_planes, valid))
    for g, w in zip(scan, plain):
        K.check("lane_scan", g, w, what)
    K.ms["lane_scan"] = cuda_ms(lambda: lx.lane_scan(*lane_planes, valid), 3)
    K.plain_ms["lane_scan"] = plain_s * 1e3
    K.work["lane_scan"] = (nbytes(*lane_planes, valid) + nbytes(*scan), RANS_STEP_OPS * n)
    K.steps["lane_scan"] = chain_steps(valid)
    print(f"lane_scan == plain on {what} (T={T}, K={lanes}); plain version: one run of "
          f"its Python step loop, timed once on the host clock: {plain_s:.3f} s", flush=True)


def dense_kernel_phase(K: Kernels, refs0: dict, dev) -> None:
    """Profile 0's card route (ops/dense.py) against the host route it
    replaces: on every chunk of both clips (batch 4096, sup 128) each
    chunk's packed blob through dense_expand == its plain version ==
    v2_tables_inputs, the pass on it == the host model, and dense_lanes ==
    its plain version == interleaved_planes at K = pick_lanes(n) and 7.
    Timed on camera1080.mp4's largest chunk, the cell p0_v2.archive's: the
    kernels (mean of 10), their plain versions (once, host clock), and the
    staging both ways: the host route's v2_tables_inputs to the card, probs
    download and interleaved_planes to the card (host clock, the card
    synchronised, median of 5) against the pack into the call's pinned
    staging buffer (host clock, median of 5 warm) and its one upload (CUDA
    events on the copy stream, mean of 10)."""
    import statistics
    import numpy as np
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch import streams as cs
    from avrecode_tpu_torch.ops import dense
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp

    def kw(an):
        return dict(batch=an.batch, sup=an.sup, fast_w=an.fast_w, slow_w=an.slow_w,
                    sig_w=an.sig_w, sig_alpha=an.sig_alpha)

    def host_inputs(an, c):
        return mp.v2_tables_inputs(
            c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d, c.v2_dk_s,
            c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w,
            an.sig_alpha, an.n_sig, td._sig0_dense(c, an.n_sig), device=dev)[0]

    def case(an, c, what):
        """Checks one chunk; returns (lay, blob on the card, its host copy,
        the pass's probs on the card, the host route's inputs)."""
        n = len(c.bit)
        lay = dense.chunk_layout(an, c)
        buf = np.empty(lay.nbytes, np.uint8)
        dense.pack(c, lay, buf)
        host_blob = torch.from_numpy(buf)
        blob = host_blob.to(dev)
        got, want = dense.expand(blob, lay), host_inputs(an, c)
        for g, p, w in zip(got, dense.expand(host_blob, lay), want, strict=True):
            K.check("dense_expand", g, p, what)
            K.check("dense_expand", g, w, f"{what} (v2_tables_inputs)")
        probs = mp.model_pass_v2(*got, **kw(an))
        if not np.array_equal(probs[:n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"model_pass_v2 on dense_expand's inputs != host probs on "
                                 f"{what}")
        for lanes in (td.pick_lanes(n), 7):
            T = lx._bucket(-(-n // lanes))
            planes = dense.lane_planes(blob, probs, lay, T, lanes)
            plain = dense.lane_planes(host_blob, probs.cpu(), lay, T, lanes)
            host_planes = lx.interleaved_planes(c.bit, c.host_probs, lanes, dev)
            for g, p, w in zip(planes, plain, host_planes, strict=True):
                K.check("dense_lanes", g, p, f"{what}, K={lanes}")
                K.check("dense_lanes", g, w, f"{what}, K={lanes} (interleaved_planes)")
        return lay, blob, host_blob, probs, want

    chunks = 0
    for clip, an in refs0.items():
        for i, c in enumerate(an.chunks):
            case(an, c, f"{clip} profile-0 chunk {i} (n={len(c.bit)}, m={c.v2_m})")
            chunks += 1
    print(f"dense_expand == plain == v2_tables_inputs and dense_lanes == plain == "
          f"interleaved_planes (K = pick_lanes, 7) on all {chunks} profile-0 chunks of "
          f"{list(refs0)}; the pass on the expanded inputs == host probs", flush=True)

    with open(os.path.join(REPO, DENSE_CLIP), "rb") as f:
        an = td.analyze(f.read(), batch_size=BATCH, model_profile=0, sup=SUP)
    c = max(an.chunks, key=lambda ch: len(ch.bit))
    n = len(c.bit)
    lanes = td.pick_lanes(n)
    T = lx._bucket(-(-n // lanes))
    what = f"{DENSE_CLIP}'s largest profile-0 chunk (n={n}, m={c.v2_m}, T={T}, K={lanes})"
    lay, blob, host_blob, probs, want = case(an, c, what)
    got = dense.expand(blob, lay)
    K.ms["dense_expand"] = cuda_ms(lambda: dense.expand(blob, lay), 10)
    K.plain_ms["dense_expand"] = host_timed(lambda: dense.expand(host_blob, lay))[1] * 1e3
    K.ms["dense_lanes"] = cuda_ms(lambda: dense.lane_planes(blob, probs, lay, T, lanes), 10)
    host_probs = probs.cpu()
    K.plain_ms["dense_lanes"] = host_timed(
        lambda: dense.lane_planes(host_blob, host_probs, lay, T, lanes))[1] * 1e3
    tables_in = sum(lay.counts[8:12])
    K.work["dense_expand"] = (7 * n + 16 * lay.m + 6 * (lay.counts[8] + lay.counts[9])
                              + 2 * (lay.counts[10] + lay.counts[11])
                              + 4 * (got[9].numel() + got[10].numel()),
                              4 * lay.m + tables_in)
    K.work["dense_lanes"] = (5 * n + 9 * T * lanes, 3 * T * lanes)

    # The staging both ways: the host route as device_probs and device_blob
    # run it, the card route as _dense_on_card does.
    def median_s(fn, reps=5):
        return statistics.median(host_timed(fn)[1] for _ in range(reps))

    pass_probs = mp.model_pass_v2(*want, **kw(an))
    probs_u16 = pass_probs[:n].cpu().numpy().astype(np.uint16)
    host_route = {"inputs_s": median_s(lambda: host_inputs(an, c)),
                  "probs_down_s": median_s(
                      lambda: pass_probs[:n].cpu().numpy().astype(np.uint16)),
                  "planes_s": median_s(lambda: lx.interleaved_planes(c.bit, probs_u16, lanes,
                                                                     dev)),
                  "bytes": nbytes(*want) + 4 * n + nbytes(*lx.interleaved_planes(
                      c.bit, probs_u16, lanes, dev))}
    streams = cs.CallStreams(dev)
    pack_s = []

    def fill(buf):
        t0 = time.perf_counter()
        dense.pack(c, lay, buf)
        pack_s.append(time.perf_counter() - t0)

    for _ in range(6):
        staged = streams.upload_staged(lay.nbytes, fill)
        torch.cuda.synchronize()
    staged = staged.cpu()  # the gaps between segments are never written: compare segments
    if not all(torch.equal(dense._seg(staged, lay, k), dense._seg(host_blob, lay, k))
               for k in range(len(dense.SEGMENTS))):
        raise AssertionError(f"upload_staged's blob != the packed blob on {what}")
    pinned = streams._staging[:lay.nbytes]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    streams.upload(pinned)
    torch.cuda.synchronize()
    start.record(streams.copy)
    for _ in range(10):
        streams.upload(pinned)
    end.record(streams.copy)
    torch.cuda.synchronize()
    upload_ms = start.elapsed_time(end) / 10
    host_ms = 1e3 * (host_route["inputs_s"] + host_route["probs_down_s"]
                     + host_route["planes_s"])
    pack_ms = 1e3 * statistics.median(pack_s[1:])
    K.extra["dense_expand"] = {"shape": what, "blob_bytes": lay.nbytes,
                               "pack_ms": pack_ms, "upload_ms": upload_ms,
                               "host_route_ms": host_ms, "host_route_bytes": host_route["bytes"]}
    print(f"profile-0 staging of {what}: host route {host_ms:.1f} ms (v2_tables_inputs to the "
          f"card {host_route['inputs_s'] * 1e3:.1f}, probs down "
          f"{host_route['probs_down_s'] * 1e3:.1f}, interleaved_planes to the card "
          f"{host_route['planes_s'] * 1e3:.1f}; {host_route['bytes']} B over the bus); card "
          f"route: pack {pack_ms:.1f} ms into warm pinned memory, upload {upload_ms:.3f} ms "
          f"({lay.nbytes / upload_ms / 1e6:.1f} GB/s) of {lay.nbytes} B, dense_expand "
          f"{K.ms['dense_expand']:.3f} ms, dense_lanes {K.ms['dense_lanes']:.3f} ms", flush=True)


def mesh_grids(dev, wide: bool = False):
    """The 1x1 grid on `dev` and the 2x2 grid: four cards where the machine
    has four, else four cells on `dev`; with `wide` also a 4x2 grid of eight
    cells on `dev`."""
    import torch
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(4)] if n >= 4 else [dev] * 4
    grids = {"1x1": make_mesh(1, 1, [dev]), "2x2": make_mesh(2, 2, cards)}
    if wide:
        grids["4x2"] = make_mesh(4, 2, [dev] * 8)
    return grids


def step_outputs_equal(K: Kernels, name: str, got, want, what: str) -> None:
    for label, g, w in zip(("x_final", "words", "emits", "probs", "total_words"), got, want):
        K.check(name, g, w, f"{what}: {label}")


def mesh_kernel_phase(K: Kernels, an, dev) -> None:
    """The three mesh-mode kernels against their plain versions at the
    mesh-uniform shapes of multigop720.mp4 (chunk mode 1, 2 x 2 grid):
    the mesh expand on every chunk, the model pass over the chunk axis on
    all chunks at once (probs == host model too), the lane-sliced masked
    scan on one chunk (its plain version on a CPU copy: a Python loop of T
    steps); then the whole step against the same step on a 2 x 2 grid of
    CPU devices, the step's plain version. Not counted as main-path
    launches (the counters are reset before each main path)."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    from avrecode_tpu_torch.parallel import pipeline
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    shapes = {(c.ns, c.ud, c.us) for c in an.chunks}
    if len(shapes) < 2:  # the mesh gate of __graft_entry__.py
        raise AssertionError(f"{MESH_CLIP} no longer stresses non-uniform padding: "
                             f"all {len(an.chunks)} chunks share dict shape {shapes}")
    inp = td.mesh_inputs(an, an.chunks, 2, SUP, MESH_LANES)
    st = inp.statics
    UD, US, NS, layout = st["ud"], st["us"], st["ns"], st["layout"]
    G, M, T = inp.blob.shape[0], NS * SUP * BATCH, NS * SUP * BATCH // MESH_LANES
    what = (f"{MESH_CLIP} mesh shapes (G={G}, M={M}, ud={UD}, us={US}, "
            f"{len(shapes)} chunk shapes)")
    blob, sc, dual0_u16, si, sv, n_arr = (t.to(dev) for t in inp.tensors())
    dual0 = dual0_u16.to(torch.int32) & 0xFFFF  # widened as the step's cells widen it
    ekw = dict(m=M, nsub=NS * SUP, U=UD + US, ud=UD, us=US, ns=NS, batch=BATCH, layout=layout,
               mesh=True)
    planes = mp.wire_expand4_blob(blob, sc, **ekw)
    made = {G: _native.expand_launches()}
    for g in range(G):
        want = mp._wire_expand_plain(blob[g], sc[g], M, NS * SUP, UD + US, UD, US, NS, BATCH,
                                     layout, True)
        for got, w in zip(planes, want):
            K.check("wire_expand", got[g], w, f"{what}, chunk {g}, mesh mode")
        if g == 0:  # chunk 0 alone
            one = mp.wire_expand4_blob(blob[:1], sc[:1], **ekw)
            made[1] = _native.expand_launches()
            for got, w in zip(one, want):
                K.check("wire_expand", got[0], w, f"{what}, chunk 0 alone, mesh mode")
    if made[G] > made[1]:
        raise AssertionError(f"wire_expand: launches a call grow with the chunks: {made}")
    K.mesh_ms["wire_expand"] = cuda_ms(lambda: mp.wire_expand4_blob(blob, sc, **ekw), 10)
    K.mesh_ms["wire_expand_g1"] = cuda_ms(
        lambda: mp.wire_expand4_blob(blob[:1], sc[:1], **ekw), 10)
    K.extra.setdefault("wire_expand", {}).update(
        mesh_ms=K.mesh_ms["wire_expand"], mesh_chunks=G, mesh_g1_ms=K.mesh_ms["wire_expand_g1"],
        mesh_bound_ms=nbytes(blob, sc, *planes[:5]) / HBM_BYTES_S * 1e3,
        mesh_launches_in_call={str(k): v for k, v in made.items()})
    print(f"wire_expand at the mesh shapes: launches in a call {made[1]} for one chunk, "
          f"{made[G]} for all {G}; card ms {K.mesh_ms['wire_expand_g1']:.3f} (one chunk), "
          f"{K.mesh_ms['wire_expand']:.3f} (all {G})", flush=True)
    bit, kind, slot, prior, deltas, dk_d, dk_s = planes
    mkw = dict(batch=BATCH, sup=SUP, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
               sig_alpha=an.sig_alpha, ud=UD, us=US, n_sig=an.n_sig)

    def v3():
        return mp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, dual0, sig0_idx=si,
                          sig0_val=sv, **mkw)

    probs = v3()
    scan_launches(K, "model_pass_v4", what, "mesh_launches_in_call")
    plain = mp._v3_core_plain(kind, slot, prior, dk_d, dk_s, deltas, dual0,
                              *(mkw[k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w",
                                                 "sig_alpha", "ud", "us", "n_sig")), si, sv)
    K.check("model_pass_v4", probs, plain, f"{what}, all chunks over the chunk axis")
    for g, c in enumerate(an.chunks):
        if not np.array_equal(probs[g, :c.n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"{what}: chunk {g} probs != host probs")
    K.mesh_ms["model_pass_v4"] = cuda_ms(v3, 3)
    K.extra["model_pass_v4"]["mesh_ms"] = K.mesh_ms["model_pass_v4"]
    valid = torch.arange(M, device=dev) < n_arr[:, None]
    lane_planes = [x.view(G, T, MESH_LANES)[:, :, MESH_LANES // 2:]
                   for x in (bit, probs.clamp_min(1), valid)]  # lane cell 1 of 2
    scan = lx.lane_scan(*lane_planes)
    plain, plain_s = host_timed(lambda: lx._lane_scan_plain(*(x[0].cpu() for x in lane_planes)))
    for got, w in zip(scan, plain):
        K.check("lane_scan", got[0], w, f"{what}, chunk 0, lanes 8-15 of 16 in place")
    K.mesh_ms["lane_scan"] = cuda_ms(lambda: lx.lane_scan(*lane_planes), 3)
    print(f"mesh kernels == plain on {what}; probs == host; card ms: expand (G={G} chunks) "
          f"{K.mesh_ms['wire_expand']:.3f}, model pass (chunk axis) "
          f"{K.mesh_ms['model_pass_v4']:.3f}, lane-sliced scan (T={T}, 8 lanes x {G} chunks) "
          f"{K.mesh_ms['lane_scan']:.3f} (chain bound "
          f"{K.chain_ms('lane_scan', chain_steps(lane_planes[2])):.4f}); the "
          f"scan's plain version on one chunk, CPU, one run: {plain_s:.3f} s", flush=True)

    # The whole step on the 2 x 2 grid against the plain step on 2 x 2 CPUs.
    grid = mesh_grids(dev)["2x2"]
    step = pipeline.sharded_v4_compress_step(grid, **st)
    staged = (blob, sc, dual0_u16, si, sv, n_arr)
    got = step(*staged)
    t0 = time.perf_counter()
    want = pipeline.sharded_v4_compress_step(make_mesh(2, 2, ["cpu"] * 4), **st)(
        *inp.tensors())
    plain_s = time.perf_counter() - t0
    name = "sharded_v4_compress_step"
    step_outputs_equal(K, name, got, want, what)
    K.ms[name] = cuda_ms(lambda: step(*staged), 3)
    K.plain_ms[name] = plain_s * 1e3
    nsub, U, nc = NS * SUP, UD + US, layout[6]
    K.work[name] = (nbytes(*staged, *got), G * (16 * M + 8 * nc + model_ops(M, nsub, U)
                                                + RANS_STEP_OPS * M))
    print(f"{name} (2x2 on {grid.devices[1][1]}) == the step on a 2x2 CPU grid: card "
          f"{K.ms[name]:.3f} ms, plain (CPU, host clock, one run) {plain_s:.3f} s", flush=True)
    # The 1x1, 2x2 and 4x2 step on this one card: the cells run on streams
    # of their own, eight v3_core passes at once on the 4x2 grid. Its four
    # gop rows pad the chunks to 12: its real chunks equal the CPU grid's,
    # and all of it the 1x1 step's on the same padded inputs.
    one_card = {"1x1": make_mesh(1, 1, [dev]), "2x2": make_mesh(2, 2, [dev] * 4)}
    for label, g in one_card.items():
        one_step = pipeline.sharded_v4_compress_step(g, **st)
        step_outputs_equal(K, name, one_step(*staged), want, f"{what} ({label} on {dev})")
        K.mesh_ms[f"step_{label}"] = cuda_ms_median(lambda: one_step(*staged), 15)
    inp4 = td.mesh_inputs(an, an.chunks, 4, SUP, MESH_LANES)
    staged4 = tuple(t.to(dev) for t in inp4.tensors())
    want4 = pipeline.sharded_v4_compress_step(make_mesh(1, 1, [dev]), **inp4.statics)(*staged4)
    step4 = pipeline.sharded_v4_compress_step(make_mesh(4, 2, [dev] * 8), **inp4.statics)
    got4 = step4(*staged4)
    step_outputs_equal(K, name, got4, want4, f"{what} (4x2 on {dev} vs 1x1, 12 chunks)")
    step_outputs_equal(K, name, [x[:G] for x in got4[:4]], want[:4],
                       f"{what} (4x2 on {dev}, its {G} real chunks vs the 2x2 CPU grid)")
    K.mesh_ms["step_4x2"] = cuda_ms_median(lambda: step4(*staged4), 15)
    ratio = K.mesh_ms["step_2x2"] / K.mesh_ms["step_1x1"]
    print(f"{name} on one card ({torch.cuda.get_device_name(dev)}), median of 15 calls: 1x1 "
          f"{K.mesh_ms['step_1x1']:.3f} ms, 2x2 {K.mesh_ms['step_2x2']:.3f} ms, 4x2 (12 "
          f"chunks) {K.mesh_ms['step_4x2']:.3f} ms (cells on their own streams), 2x2 / 1x1 = "
          f"{ratio:.3f}", flush=True)
    K.extra[name] = {f"step_{k}_ms": K.mesh_ms[f"step_{k}"] for k in ("1x1", "2x2", "4x2")}


def recompress_inputs():
    """The pre-ANL5 step's inputs, as test_parallel.py builds them, at the
    compress path's batch: 4 chunks of 65,536 pairs, the real sig table."""
    import numpy as np
    G, N = 4, 1 << 16
    n_dual, n_sig = 4096, 1 << 17
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (G, N)).astype(np.int32)
    kinds = rng.integers(0, 3, (G, N)).astype(np.int32)
    keys = np.where(kinds == 2, rng.integers(0, n_sig, (G, N)),
                    rng.integers(0, n_dual - 1, (G, N))).astype(np.int32)
    priors = rng.integers(1, 32767, (G, N)).astype(np.int32)
    dual0 = np.ones((G, n_dual, 4), np.int32) * 3
    sig0 = np.zeros((G, n_sig, 2), np.int32)
    return bits, kinds, keys, priors, dual0, sig0


def recompress_kernel_phase(K: Kernels, dev):
    """sharded_recompress_step on the 2 x 2 grid against the same step on
    a 2 x 2 grid of CPU devices, and its probs against the single-device
    model_pass of each chunk (test_parallel.py:48-53). Returns the step and
    its staged inputs for the main path."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    from avrecode_tpu_torch.parallel import pipeline
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    name = "sharded_recompress_step"
    host_in = [torch.from_numpy(a) for a in recompress_inputs()]
    staged = [t.to(dev) for t in host_in]
    kw = dict(batch=BATCH, fast_w=48, slow_w=640, sig_w=80, sig_alpha=1)
    step = pipeline.sharded_recompress_step(mesh_grids(dev)["2x2"], **kw)(K_total=16)
    got = step(*staged)
    t0 = time.perf_counter()
    want = pipeline.sharded_recompress_step(make_mesh(2, 2, ["cpu"] * 4), **kw)(
        K_total=16)(*host_in)
    plain_s = time.perf_counter() - t0
    G, N = host_in[0].shape
    what = f"random pairs G={G} N={N} batch {BATCH}, 16 lanes"
    for label, g, w in zip(("probs", "x_final", "words", "emits", "total_words"), got, want):
        K.check(name, g, w, f"{what}: {label}")
    for g in range(G):
        one = mp.model_pass(*(t[g] for t in staged), **kw)
        K.check(name, got[0][g], lx._as_i16(one),  # the step's probs: u16 bit patterns
                f"{what}: chunk {g} probs vs single-device model_pass")
    K.ms[name] = cuda_ms(lambda: step(*staged), 3)
    K.plain_ms[name] = plain_s * 1e3
    # The same step with its four chunks on a 4x2 grid of this one card:
    # eight cells, eight cooperative model_pass launches on eight streams.
    step4 = pipeline.sharded_recompress_step(make_mesh(4, 2, [dev] * 8), **kw)(K_total=16)
    for label, g, w in zip(("probs", "x_final", "words", "emits", "total_words"),
                           step4(*staged), want):
        K.check(name, g, w, f"{what} (4x2 on {dev}): {label}")
    cell_launches = _native.pass_launches()
    K.extra[name] = {"step_2x2_ms": K.ms[name],
                     "step_4x2_ms": cuda_ms_median(lambda: step4(*staged), 15),
                     "model_pass_launches_in_call": cell_launches}
    print(f"{name} on a 4x2 grid of {dev} == the 2x2 CPU grid: median of 15 calls "
          f"{K.extra[name]['step_4x2_ms']:.3f} ms (2x2: {K.ms[name]:.3f} ms); a cell's "
          f"model_pass call makes {cell_launches} launches", flush=True)
    nb = N // BATCH
    n_dual, n_sig = staged[4].shape[1], staged[5].shape[1]
    # Per chunk the least work of model_pass (a sort-sized prefix count, a
    # probability a bin, an update a touched row) and the scan's steps; the
    # chain is a chunk's batches and then its lane's steps (chunks and lanes
    # run side by side).
    bits_h, kinds_h, keys_h = (a.numpy() for a in host_in[:3])
    ukey = np.where(kinds_h == 2, keys_h.astype(np.int64) + n_dual, keys_h)
    touched = sum(len(np.unique(u)) for u in ukey.reshape(G * nb, BATCH))
    K.work[name] = (nbytes(*staged, *got),
                    G * N * (2 * (BATCH - 1).bit_length() + 20 + RANS_STEP_OPS) + 40 * touched)
    K.chain_cycles[name] = (nb * PASS_STEP_CYCLES
                            + N // 16 * DEP_PER_STEP * CYCLES_PER_DEP)
    print(f"{name} (2x2) == the step on a 2x2 CPU grid and == model_pass per chunk on "
          f"{what}: card {K.ms[name]:.3f} ms, plain (CPU, host clock, one run) "
          f"{plain_s:.3f} s", flush=True)
    return step, staged


def staged_nbytes(an) -> int:
    """The nbytes of the numpy arrays that the port's staging builds for
    these chunks (the fused blob, the scalars, the dual0 dictionary at its
    wire widths, the padded warm sig rows), the tables that chunks alias
    once: what `wire_bytes` must count. The comparison with the JAX
    package's own count is tests/test_torch_wire.py's, on the CPU."""
    from avrecode_tpu_torch import device as td
    total, shipped = 0, set()
    for c in an.chunks:
        blob, sc = td._build_blob4(an, c, td._chunk_layout(c))
        total += blob.nbytes + sc.nbytes
        si, sv = td._sig0_sparse_padded(c, an.n_sig)
        if si is not None and ("sig0", id(c.sig0_idx)) not in shipped:
            shipped.add(("sig0", id(c.sig0_idx)))
            total += si.nbytes + sv.nbytes
        if ("dual0", id(c.d0_idx)) not in shipped:
            shipped.add(("dual0", id(c.d0_idx)))
            total += sum(a.nbytes for a in td._dual0_dict(c))
    return total


def main_path_phase(clips: dict, refs: dict, dev) -> dict:
    """compress(device=dev) on each clip: one warm-up, best of 3, then
    the checks on a further run that keeps its probs."""
    import numpy as np
    from avrecode_tpu_torch import device as td
    report = {}
    for name, data in clips.items():
        td.compress(data, batch_size=BATCH, device=dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            td.compress(data, batch_size=BATCH, device=dev)
            times.append(time.perf_counter() - t0)
        info = {}
        comp, stats = td.compress(data, batch_size=BATCH, device=dev, info=info,
                                  keep_probs=True)
        chunks = refs[name].chunks
        if len(chunks) != info["n_chunks"]:
            raise AssertionError(f"{name}: {info['n_chunks']} chunks vs {len(chunks)} analysed")
        for i, c in enumerate(chunks):
            if not np.array_equal(info["probs"][i], c.host_probs):
                bad = int(np.flatnonzero(info["probs"][i] != c.host_probs)[0])
                raise AssertionError(f"{name} chunk {i}: probs != host probs (first at {bad})")
            bits = (c.packed >> 15).astype(np.uint8)
            want = c_rans_encode(bits, c.host_probs, td.pick_lanes(c.n))
            if info["blobs"][i] != want:
                raise AssertionError(f"{name} chunk {i}: lane blob != C++ encoder")
        if not roundtrip_ok(comp, data):
            raise AssertionError(f"{name}: decompress(compress(x)) != x")
        staged = staged_nbytes(refs[name])
        if info["wire_bytes"] != staged:
            raise AssertionError(f"{name}: wire_bytes {info['wire_bytes']} != {staged}, the "
                                 f"nbytes of the staged arrays")
        print(f"main path {name}: wire_bytes {info['wire_bytes']} (the nbytes of the staged "
              f"arrays: {staged})", flush=True)
        best = min(times)
        report[name] = dict(bytes=len(data), container=len(comp), chunks=len(chunks),
                            bins=int(sum(c.n for c in chunks)), best_s=best,
                            runs_s=times, mb_s=len(data) / 1e6 / best,
                            wire_bytes=info["wire_bytes"], staged_nbytes=staged,
                            host_phases_s={k: info[k] for k in (
                                "open_s", "fetch_s", "stage_s", "launch_s", "compact_s",
                                "dispatch_s", "emit_s", "pack_s")})
        print(f"main path {name}: e2e best {best:.3f} s of {['%.3f' % t for t in times]} = "
              f"{len(data) / 1e6 / best:.3f} MB/s, {report[name]['bins']} bins in "
              f"{len(chunks)} chunks, ratio {len(comp) / len(data):.5f}; probs == host, "
              f"blobs == C++ encoder, roundtrip exact", flush=True)
    return report


def profile0_main_path_phase(clips: dict, refs0: dict, dev) -> dict:
    """compress(model_profile=0, device=dev): ARTC_MODEL_IMPL=v2 on each clip
    with one warm-up and best of 3, then dict, sort and mm once each on the
    first clip; every run is checked (probs == host, blobs == C++ encoder,
    exact roundtrip) and a clip's containers must be identical."""
    import numpy as np
    from avrecode_tpu_torch import device as td
    report = {}
    for ci, (name, data) in enumerate(clips.items()):
        chunks = refs0[name].chunks
        want_blobs = [c_rans_encode(c.bit, c.host_probs, td.pick_lanes(len(c.bit)))
                      for c in chunks]
        containers = {}
        runs = {}
        for impl in IMPLS if ci == 0 else IMPLS[:1]:
            os.environ["ARTC_MODEL_IMPL"] = impl
            reps = 4 if impl == "v2" else 1  # v2: one warm-up, then best of 3
            times = []
            for _ in range(reps):
                info = {}
                t0 = time.perf_counter()
                comp, _ = td.compress(data, batch_size=BATCH, model_profile=0, device=dev,
                                      info=info, keep_probs=True)
                times.append(time.perf_counter() - t0)
            if len(chunks) != info["n_chunks"]:
                raise AssertionError(f"{name} {impl}: {info['n_chunks']} chunks vs "
                                     f"{len(chunks)} analysed")
            for i, c in enumerate(chunks):
                if not np.array_equal(info["probs"][i], c.host_probs):
                    bad = int(np.flatnonzero(info["probs"][i] != c.host_probs)[0])
                    raise AssertionError(f"{name} {impl} chunk {i}: probs != host probs "
                                         f"(first at {bad})")
                if info["blobs"][i] != want_blobs[i]:
                    raise AssertionError(f"{name} {impl} chunk {i}: lane blob != C++ encoder")
            if not roundtrip_ok(comp, data):
                raise AssertionError(f"{name} {impl}: decompress(compress(x)) != x")
            containers[impl] = comp
            timed = times[1:] if impl == "v2" else times
            runs[impl] = dict(best_s=min(timed), runs_s=timed, mb_s=len(data) / 1e6 / min(timed),
                              host_phases_s={k: info[k] for k in (
                                  "analyze_s", "model_s", "lanes_s", "pack_s")})
            print(f"main path profile 0 {name} {impl}: e2e best {min(timed):.3f} s of "
                  f"{['%.3f' % t for t in timed]}, ratio {len(comp) / len(data):.5f}; probs == "
                  f"host, blobs == C++ encoder, roundtrip exact", flush=True)
        os.environ.pop("ARTC_MODEL_IMPL", None)
        if len(set(containers.values())) != 1:
            raise AssertionError(f"{name}: the profile-0 containers differ across "
                                 f"{list(containers)}")
        report[name] = dict(bytes=len(data), container=len(containers["v2"]),
                            chunks=len(chunks), bins=int(sum(len(c.bit) for c in chunks)),
                            impls=runs)
    return report


def mesh_main_path_phase(data: bytes, single: bytes, dev) -> dict:
    """compress_mesh on the 1x1, the 2x2 and a 4x2 grid of eight cells on
    `dev`: one warm-up, best of 3;
    each container == the single-device container (computed before the
    counters were reset), and the host decoder returns the input."""
    from avrecode_tpu_torch import device as td
    report = {}
    for name, grid in mesh_grids(dev, wide=True).items():
        def run():
            return td.compress_mesh(data, grid, chunk_mode=1, batch_size=BATCH, sup=SUP,
                                    force_lanes=MESH_LANES)
        run()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            comp, st = run()
            times.append(time.perf_counter() - t0)
        if comp != single:
            raise AssertionError(f"{MESH_CLIP} {name} grid: mesh container != single-device")
        if not roundtrip_ok(comp, data):
            raise AssertionError(f"{MESH_CLIP} {name} grid: mesh container did not roundtrip")
        best = min(times)
        report[name] = dict(cells=[[str(d) for d in row] for row in grid.devices],
                            chunks=st.n_chunks, container=len(comp), best_s=best, runs_s=times,
                            mb_s=len(data) / 1e6 / best)
        print(f"main path compress_mesh {MESH_CLIP} {name}: e2e best {best:.3f} s of "
              f"{['%.3f' % t for t in times]} = {len(data) / 1e6 / best:.3f} MB/s, "
              f"{st.n_chunks} chunks; container == single-device, roundtrip exact", flush=True)
    return report


def memcpy_kinds(prof) -> dict:
    """{memcpy name: [count, bytes]} of a torch.profiler run's device trace
    (its chrome trace: events of category gpu_memcpy, bytes in their args):
    the name says the kind, e.g. "Memcpy HtoD (Pinned -> Device)"."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kinds = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            k = kinds.setdefault(e["name"], [0, 0])
            k[0] += 1
            k[1] += int(e.get("args", {}).get("bytes", 0))
    return kinds


def transfers_phase(clips: dict, single_mesh: bytes, dev) -> dict:
    """The main path's transfers (streams.CallStreams: a compute and a copy
    stream per call, pinned host memory):
    - a torch.profiler pass over one compress(device=dev) on bench.mp4 and
      one compress_mesh on multigop720.mp4 (1x1): every memcpy kind with its
      count and bytes; none may be pageable, and the mesh download must be
      3 bytes a (step, lane) slot plus the final states and the total;
    - the counts readback of chunk i-1 ends before chunk i's lane scan ends
      (CUDA event times of compress(info=...)): it waits on its own scan;
    - two compress calls at once from two threads (bench.mp4 and
      multigop720.mp4) each write the container of the same call alone;
    - multigop720.mp4 at chunk mode 1 (the mesh's chunks, 16 lanes) three
      times: each container == the single-device one of the mesh phase."""
    import threading
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    from torch.profiler import ProfilerActivity, profile
    bench, mesh_data = clips[CLIPS[0]], clips[MESH_CLIP]
    report = {}
    alone = {c: td.compress(d, batch_size=BATCH, device=dev)[0] for c, d in clips.items()}
    mesh = make_mesh(1, 1, [dev])

    def mesh_run():
        return td.compress_mesh(mesh_data, mesh, chunk_mode=1, batch_size=BATCH, sup=SUP,
                                force_lanes=MESH_LANES)

    mesh_run()
    for name, fn in (("compress", lambda: td.compress(bench, batch_size=BATCH, device=dev)),
                     ("compress_mesh", mesh_run)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            comp, _ = fn()
            torch.cuda.synchronize()
        kinds = memcpy_kinds(prof)
        print(f"transfers: {name} memcpy kinds (count, bytes) {kinds}", flush=True)
        if not kinds:
            raise AssertionError(f"{name}: the profiler traced no memcpy on the card")
        pageable = {k: v for k, v in kinds.items() if "Pageable" in k}
        if pageable:
            raise AssertionError(f"{name}: pageable copies in the call: {pageable}")
        report[name] = {k: {"count": v[0], "bytes": v[1]} for k, v in kinds.items()}
        want = alone[CLIPS[0]] if name == "compress" else single_mesh
        if comp != want:
            raise AssertionError(f"{name}: the traced call's container differs")
    an = td.analyze(mesh_data, chunk_mode=1, batch_size=BATCH, model_profile=2, sup=SUP)
    G, NS = len(an.chunks), max(c.ns for c in an.chunks)
    T = NS * SUP * BATCH // MESH_LANES
    want_down = 3 * G * T * MESH_LANES + 4 * G * MESH_LANES + 4
    down = sum(v[1] for k, v in kinds.items() if "DtoH" in k)
    print(f"transfers: compress_mesh downloaded {down} B for G={G} chunks x T={T} steps x "
          f"{MESH_LANES} lanes (3 B a slot, the final states and the total: {want_down} B)",
          flush=True)
    if down != want_down:
        raise AssertionError(f"compress_mesh downloaded {down} B, not {want_down}")
    report["mesh_download_bytes"] = down
    info = {}
    td.compress(bench, batch_size=BATCH, device=dev, info=info)
    ready, scan = info["counts_ready_ms"], info["scan_end_ms"]
    print(f"transfers: bench.mp4 lane scans end at {scan} ms, their counts' copies at "
          f"{ready} ms (from the call's first event)", flush=True)
    for i in range(1, len(scan)):
        if not ready[i - 1] < scan[i]:
            raise AssertionError(f"chunk {i - 1}'s counts readback ended at {ready[i - 1]} "
                                 f"ms, after chunk {i}'s lane scan ({scan[i]} ms)")
    report["counts_ready_ms"], report["scan_end_ms"] = ready, scan
    got = {}

    def run(clip):
        got[clip] = td.compress(clips[clip], batch_size=BATCH, device=dev)[0]

    threads = [threading.Thread(target=run, args=(c,)) for c in CLIPS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if got != alone:
        raise AssertionError("two concurrent compress calls differ from the calls alone: "
                             f"{[c for c in CLIPS if got.get(c) != alone[c]]}")
    for r in range(3):
        comp, _ = td.compress(mesh_data, chunk_mode=1, batch_size=BATCH,
                              force_lanes=MESH_LANES, device=dev)
        if comp != single_mesh:
            raise AssertionError(f"{MESH_CLIP} chunk mode 1, run {r}: container differs")
    print(f"transfers: no pageable copy in either call; two concurrent calls == each call "
          f"alone; {MESH_CLIP} at chunk mode 1 three times == the single-device container",
          flush=True)
    return report


def _captured(main, argv) -> tuple[int, str]:
    """(exit code, the last line printed) of an entry point's main(argv);
    its other output goes to stderr."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        print(line, file=sys.stderr)
    return rc, lines[-1] if lines else ""


def modules_phase(data: bytes, an, card: str, dev) -> dict:
    """The CLI, pipeline, format_bill, refprior, the microbench and the
    bench on CLIPS[0]; `an` is its profile-2 analysis, `card` nvidia-smi's
    line. Any failure raises."""
    from avrecode_tpu_torch import bench, cli, host, microbench, pipeline
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.models import MODEL_FAMILIES
    from avrecode_tpu_torch.ops import intmath
    from avrecode_tpu_torch.utils.billing import format_bill
    t0 = time.perf_counter()
    clip = os.path.join(REPO, CLIPS[0])
    out_dir = os.path.join(REPO, "avrecode_tpu_torch", "build", "modules_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    comp_path, dec_path = os.path.join(out_dir, "bench.atrc"), os.path.join(out_dir, "bench.mp4")

    def cli_json(*argv) -> dict:
        rc, line = _captured(cli.main, list(argv))
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} exited {rc}: {line}")
        return json.loads(line)

    opts = ["--device", str(dev), "--batch-size", str(BATCH)]
    rep = cli_json("compress", clip, comp_path, *opts)
    with open(comp_path, "rb") as f:
        written = f.read()
    want, _ = td.compress(data, batch_size=BATCH, device=dev)
    if written != want or rep["output_bytes"] != len(want):
        raise AssertionError(f"cli compress --device {dev}: container != compress(device)'s")
    info = cli_json("info", comp_path)
    if not info["readable"] or info["container_version"] != host.container_version():
        raise AssertionError(f"cli info: {info}")
    dec = cli_json("decompress", comp_path, dec_path)
    with open(dec_path, "rb") as f:
        if f.read() != data or dec["output_bytes"] != len(data):
            raise AssertionError("cli decompress: output != input")
    rt = cli_json("roundtrip", clip, *opts, "--bill")
    if rt["roundtrip_ok"] is not True or not rt["bill"] or rt["compressed_bytes"] != len(want):
        raise AssertionError(f"cli roundtrip --bill: {rt}")
    print(f"modules: cli compress / info / decompress / roundtrip --bill on {CLIPS[0]} with "
          f"--device {dev}: container == compress(device='{dev}') ({len(want)} B), version "
          f"{info['container_version']}, decompress == input, roundtrip ok", flush=True)
    prt = pipeline.roundtrip(data)
    if not prt.ok:
        raise AssertionError("pipeline.roundtrip: not ok")
    table = format_bill(prt.stats)
    if not table.splitlines()[-1].startswith("TOTAL") or len(table.splitlines()) < 4:
        raise AssertionError(f"format_bill: {table!r}")
    cfg = MODEL_FAMILIES["refprior"]
    header = (an.fast_w, an.slow_w, an.sig_w, an.sig_alpha & 0xFFFF, an.n_sig,
              intmath.PROB_BITS, intmath.RES_DIR_ALPHA, intmath.RES_DIR_K)
    want_cfg = (cfg.fast_window, cfg.slow_window, cfg.sig_window, cfg.sig_mix_alpha,
                1 << cfg.sig_hash_bits, cfg.prob_bits, cfg.res_dir_alpha, cfg.res_dir_fast_boost)
    if header != want_cfg or (an.sig_alpha >> 16) not in cfg.sig_mix_alpha_off_cands:
        raise AssertionError(f"refprior {want_cfg} != export header / intmath {header}")
    print(f"modules: pipeline.roundtrip ok (ratio {prt.ratio:.5f}, overhead "
          f"{prt.container_overhead:.5f}); format_bill {len(table.splitlines())} lines; "
          f"MODEL_FAMILIES['refprior'] == the export header and ops/intmath.py", flush=True)
    rc, micro_line = _captured(microbench.main, [clip, "--reps", "5", *opts])
    micro = json.loads(micro_line)
    if rc != 0 or not micro["differential_ok"]:
        raise AssertionError(f"microbench exited {rc}: {micro_line}")
    print("modules: microbench", flush=True)
    print(micro_line, flush=True)
    rc, bench_line = _captured(bench.main, ["--reps", "3", "--host-reps", "3", *opts])
    rep_bench = json.loads(bench_line)
    if rc != 0 or "error" in rep_bench or rep_bench.get("roundtrip_bit_exact") is not True:
        raise AssertionError(f"bench exited {rc}: {bench_line}")
    if rep_bench["card"] != card:
        raise AssertionError(f"bench card {rep_bench['card']!r} != {card!r}")
    print("modules: bench", flush=True)
    print(bench_line, flush=True)
    seconds = time.perf_counter() - t0
    print(f"modules: device e2e best {rep_bench['device_e2e_s']:.3f} s, median "
          f"{rep_bench['device_e2e_median_s']:.3f} s, spread "
          f"{rep_bench['device_e2e_spread']:.3f}; {rep_bench['value']:.3f} MB/s "
          f"(vs host {rep_bench['vs_baseline']:.3f}x); phase {seconds:.1f} s", flush=True)
    return {"seconds": seconds, "microbench": micro, "bench": rep_bench}


def corpus_clips_phase(K: Kernels, dev) -> dict:
    """Every clip of the frozen test corpus (avrecode_tpu_torch/testdata/
    corpus) in every mode its manifest entry names, through the port on
    `dev` (testcorpus.check_clip): per chunk probs == host model and lane
    blob == C++ encoder, the container's digest == the JAX package's (or the
    same error), exact roundtrip, under profile 0 dict, sort and mm == v2,
    the mesh on a 2x2 grid of `dev`. Every kernel those runs launch is held
    against its plain version on each chunk's staged inputs
    (testcorpus.KernelCheck: uncounted launches; the plain versions on the
    host CPU in CORPUS_WORKERS processes while the clips run, the lane scans
    at the end over a chunk axis). One line a clip, then the totals."""
    from avrecode_tpu_torch import testcorpus as tc
    t0 = time.perf_counter()
    man = tc.manifest()
    runs = {}
    with tc.KernelCheck(K.check, workers=CORPUS_WORKERS) as kc:
        for name in tc.clip_names():
            runs[name] = tc.check_clip(name, dev, man, kernels=kc)
        clips_s = time.perf_counter() - t0
        kc.flush()
    seconds = time.perf_counter() - t0
    for name, r in runs.items():
        print(f"corpus_clips {name}: {len(r['modes'])} modes ({','.join(r['modes'])}; "
              f"{r['errors']} raise the JAX package's error), {r['chunks']} chunks, "
              f"{kc.clips[name]} kernel == plain checks, {r['seconds']:.2f} s", flush=True)
    total = {k: sum(r[k] for r in runs.values()) for k in ("chunks", "errors")}
    n_runs = sum(len(r["modes"]) for r in runs.values())
    plain = {k: round(v, 3) for k, v in kc.seconds.items()}
    print(f"corpus_clips totals: {len(runs)} clips, {n_runs} (clip, mode) runs ("
          f"{total['errors']} where the JAX package raises: the same error), {total['chunks']} "
          f"chunks; containers == the JAX package's, probs == host, blobs == C++ encoder, "
          f"roundtrips exact; kernel == plain (max abs err 0) on {dict(kc.counts)} chunks; "
          f"plain versions {plain} s in {CORPUS_WORKERS} processes; clips {clips_s:.1f} s, "
          f"phase {seconds:.1f} s", flush=True)
    return {"clips": len(runs), "runs": n_runs, **total, "kernel_checks": dict(kc.counts),
            "plain_s": plain, "clips_s": clips_s, "seconds": seconds}


_CORPUS_CHILD = """
import json, os, sys, time
import torch
import torch.distributed as tdist
from avrecode_tpu_torch import cli
from avrecode_tpu_torch.parallel import distributed
rc = cli.main(["corpus", sys.argv[1], sys.argv[2], "--device", "cuda", "--chunk-mode", "1"])
calls = distributed.calls["_psum_across_processes"]
rank, world = tdist.get_rank(), tdist.get_world_size()
x = torch.arange(1, 5, dtype=torch.int64) * (rank + 1)
def psum():
    return distributed._psum_across_processes(x)
def plain():
    parts = [torch.empty_like(x) for _ in range(world)]
    tdist.all_gather(parts, x)
    return torch.stack(parts).sum(0)
out = {}
for name, fn in (("ms", psum), ("plain_ms", plain)):
    for _ in range(5):
        fn()
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(50):
        got = fn()
    out[name] = (time.perf_counter() - t0) / 50 * 1e3
    out[name + "_value"] = got.tolist()
tdist.barrier()
tdist.destroy_process_group()
out["calls"] = calls
print(json.dumps(out), flush=True)
sys.exit(rc)
"""


def corpus_phase() -> dict:
    """Two processes on this machine join one gloo group through the JAX
    launch variables and run `cli corpus --device cuda --chunk-mode 1` over
    benchdata/*.mp4 (one chunk per GOP, the corpus's unit: multigop.mp4 as
    one chunk overflows the slim wire's 8192-slot dictionary); both report the same merged stats with no failures,
    and every output roundtrips. Each then times its collective (row 12)
    against the plain sum of an all-gather."""
    from avrecode_tpu_torch import host
    out_dir = os.path.join(REPO, "avrecode_tpu_torch", "build", "corpus_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    src = os.path.join(REPO, "benchdata", "*.mp4")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_COORDINATOR=f"localhost:{port}", JAX_NUM_PROCESSES="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _CORPUS_CHILD, src, out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env={**env, "JAX_PROCESS_ID": str(i)})
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):  # a failed file fails every rank's report
        raise AssertionError("corpus: " + "; ".join(
            f"process {i} exited {p.returncode}, stdout {out[-1500:]!r}, stderr {err[-3000:]!r}"
            for i, (p, (out, err)) in enumerate(zip(procs, outs))))
    reports, colls = [], []
    for out, _ in outs:
        lines = out.strip().splitlines()
        reports.append(json.loads(lines[-2]))
        colls.append(json.loads(lines[-1]))
    for key in ("files", "input_bytes", "output_bytes", "failures"):
        if reports[0][key] != reports[1][key]:
            raise AssertionError(f"corpus: the processes' merged {key} differ: {reports}")
    inputs = sorted(glob.glob(src))
    if reports[0]["files"] != len(inputs) or reports[0]["failures"] != 0:
        raise AssertionError(f"corpus: {reports[0]} for {len(inputs)} inputs")
    for path in inputs:
        with open(os.path.join(out_dir, os.path.basename(path) + ".atrc"), "rb") as f:
            dec, _ = host.decompress(f.read())
        with open(path, "rb") as f:
            if dec != f.read():
                raise AssertionError(f"corpus: {path} did not roundtrip")
    err = max(abs(a - b) for c in colls for a, b in zip(c["ms_value"], c["plain_ms_value"]))
    if any(c["ms_value"] != [3, 6, 9, 12] for c in colls) or err != 0:  # (1..4) * (1 + 2)
        raise AssertionError(f"corpus: the collective's sums are wrong: {colls}")
    print(f"corpus: 2 processes (gloo), {reports[0]['files']} files, "
          f"{reports[0]['input_bytes']} -> {reports[0]['output_bytes']} bytes, wall "
          f"{wall:.3f} s; merged stats equal on both, every output roundtrips; "
          f"all-reduce {colls[0]['ms']:.4f} / {colls[1]['ms']:.4f} ms per call", flush=True)
    return {"reports": reports, "wall_s": wall,
            "collective": {"calls": sum(c["calls"] for c in colls), "err": err,
                           "ms": max(c["ms"] for c in colls),
                           "plain_ms": max(c["plain_ms"] for c in colls),
                           "bytes": 2 * 4 * 8}}


_CONTROL = ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC",
            "BREAK", "KILL", "BPT")
# Opcodes whose operands are all read (stores, copies into shared memory,
# barriers, branches).
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "LDGSTS", "BAR", "MEMBAR", "SYNCS", "DEPBAR",
            "NOP", "ERRBAR", "CCTL", "FENCE", "ARRIVES", "YIELD", *_CONTROL)
_REG = r"\b(U?R\d+|U?P\d)\b"


def _sass_functions(lib_path: str) -> dict:
    """The built library's SASS (cuobjdump -sass), as function name -> its
    instruction lines."""
    import re
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and (re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)
                                   or re.match(r"\s*\.L\w*:", line)):
            funcs[name].append(line)
    return funcs


def _blocks(lines) -> list:
    """The basic blocks of these SASS lines, each a list of (guard, opcode,
    operands): blocks end at labels, branch targets and control
    instructions."""
    import re
    targets = {int(t, 16) for line in lines for t in re.findall(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)",
                                                                   line)}
    blocks, block = [], []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s*(.*?)\s*;", line)
        if (not m or int(m.group(1), 16) in targets) and block:  # a label or a branch target
            blocks.append(block)
            block = []
        if not m:
            continue
        ins = m.group(2)
        guard = re.match(r"@!?(U?P\w+)\s+", ins)
        if guard:
            ins = ins[guard.end():]
        op, _, rest = ins.partition(" ")
        block.append((guard.group(1) if guard else None, op,
                      [o.strip() for o in rest.split(",")] if rest else []))
        if op.split(".")[0] in _CONTROL:
            blocks.append(block)
            block = []
    if block:
        blocks.append(block)
    return blocks


def _chain(block) -> int:
    """The longest chain of dependent instructions in one basic block: a
    register's reader depends on its last writer in the block."""
    import re
    depth, longest = {}, 0
    for guard, op, ops in block:
        dests, srcs = [], [guard] if guard else []
        if op.split(".")[0] in _NO_DEST or not ops:
            srcs += ops
        else:
            dests.append(ops[0])
            i = 1
            while i < len(ops) and i < 3 and re.fullmatch(r"U?P(\d|T)", ops[i]):
                dests.append(ops[i])
                i += 1
            srcs += ops[i:]
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
        read = set()
        for o in srcs:
            read.update(re.findall(_REG, o))
        if ".WIDE" in op and srcs:  # the addend is a register pair
            read.update(f"R{int(r[1:]) + 1}" for r in re.findall(r"\bR\d+\b", srcs[-1]))
        d = 1 + max((depth.get(r, 0) for r in read), default=0)
        for o in dests:
            for r in re.findall(_REG, o):
                if r[0] == "R":  # a vector load or a wide result fills a register run
                    depth.update((f"R{int(r[1:]) + k}", d) for k in range(width))
                else:
                    depth[r] = d
        longest = max(longest, d)
    return longest


def scan_chains() -> dict:
    """Dependent instructions per step of each lane scan, for its chain
    bound: DEP_PER_STEP, the recurrence's own, or fewer where the built
    kernel's consumer has a shorter chain. The consumer's straight-line
    block of steps is the one that holds the step records' 8-byte shared
    loads (LDS.64, one a step, and in no other block); its longest chain
    over its steps is printed beside its issued instructions a step."""
    from avrecode_tpu_torch import _native
    funcs = _sass_functions(_native.LIB_PATH)
    out = {}
    for name, kernel in (("lane_scan_dev", "lane_scan_dev_kernel"),
                         ("lane_scan", "lane_scan_kernel")):
        found = [lines for f, lines in funcs.items() if kernel in f]
        if len(found) != 1:
            raise AssertionError(f"SASS of {kernel}: {len(found)} functions match")
        block = max(_blocks(found[0]), key=lambda b: sum(op == "LDS.64" for _, op, _ in b))
        steps = sum(op == "LDS.64" for _, op, _ in block)
        if steps == 0:
            raise AssertionError(f"SASS of {kernel}: no block loads step records")
        chain = _chain(block)
        out[name] = min(DEP_PER_STEP, chain / steps)
        print(f"{name} SASS: the consumer's block of {steps} steps has a longest dependent "
              f"chain of {chain} instructions = {chain / steps:.3f} a step (the bound takes "
              f"{out[name]:.3f}) and issues {len(block)} instructions = "
              f"{len(block) / steps:.2f} a step", flush=True)
    return out


def max_sm_clock_hz() -> float:
    """The card's max SM clock, from nvidia-smi."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return float(mhz) * 1e6


def build_all() -> None:
    """The CUDA kernels and the host library, built at the same time."""
    from avrecode_tpu_torch import _native

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        kern = ex.submit(timed, _native.build)
        host_lib = ex.submit(timed, _native.ensure_host_lib)
        t_nvcc, t_host = kern.result(), host_lib.result()
    print(f"build (at once): kernels (one nvcc per source, sm_90a) {t_nvcc:.1f} s -> "
          f"{os.path.relpath(_native.LIB_PATH, REPO)}; host library {t_host:.1f} s -> "
          f"{os.path.relpath(_native.HOST_LIB_PATH, REPO)} (g++ "
          f"{' '.join(_native.HOST_CXXFLAGS)})", flush=True)


def tree_snapshot(root: str) -> dict:
    """{path: (size, mtime_ns)} of every file and directory under root
    (os.stat only: nothing is opened)."""
    snap = {}
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            st = os.stat(os.path.join(d, name))
            snap[os.path.join(d, name)] = (st.st_size, st.st_mtime_ns)
    return snap


def jax_package_phase(before: dict) -> str:
    """Fails if a file or directory under the JAX package was created,
    changed or removed since `before`, or if this process maps a file under
    it; returns the report line."""
    after = tree_snapshot(JAX_PKG)
    changed = sorted(p for p in before.keys() | after.keys() if before.get(p) != after.get(p))
    jax_dir = os.path.realpath(JAX_PKG) + os.sep
    with open("/proc/self/maps") as f:
        rows = [line.split(None, 5) for line in f]
    paths = {os.path.realpath(r[5].strip()) for r in rows if len(r) == 6}
    mapped = sorted(p for p in paths if p.startswith(jax_dir))
    if changed or mapped:
        fail(f"the run touched the JAX package: created or changed {changed[:20]}, "
             f"mapped {mapped}")
    return (f"jax package untouched: {len(after)} paths under "
            f"{os.path.relpath(JAX_PKG, REPO)}/ unchanged (size, mtime), none created; "
            f"{len(rows)} mappings of this process, none under it")


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import torch
        from avrecode_tpu_torch import _native
        from avrecode_tpu_torch import device as td
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    if not all(os.path.exists(os.path.join(REPO, c)) for c in (*CLIPS, DENSE_CLIP)):
        fail(f"missing {CLIPS} or {DENSE_CLIP}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the GPU only")

    t_start = time.perf_counter()
    jax_before = tree_snapshot(JAX_PKG)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; card {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    print(f"host library toolchain: {gxx}; HOST_CXXFLAGS {' '.join(_native.HOST_CXXFLAGS)}",
          flush=True)
    build_all()

    clips = {c: open(os.path.join(REPO, c), "rb").read() for c in CLIPS}
    refs = {c: td.analyze(d, batch_size=BATCH, model_profile=2, sup=SUP)
            for c, d in clips.items()}
    refs0 = {c: td.analyze(d, batch_size=BATCH, model_profile=0, sup=SUP)
             for c, d in clips.items()}
    mesh_an = td.analyze(clips[MESH_CLIP], chunk_mode=1, batch_size=BATCH, model_profile=2,
                         sup=SUP)
    dev = torch.device("cuda")

    K = Kernels()
    K.chain, K.sm_clock_hz = scan_chains(), max_sm_clock_hz()
    kernel_phase(K, refs[CLIPS[0]], refs[CLIPS[0]].chunks, dev)
    expand_compact_cases(K, dev)
    scan_cases(K, dev)
    profile0_kernel_phase(K, refs0[CLIPS[0]], dev)
    dense_kernel_phase(K, refs0, dev)
    mesh_kernel_phase(K, mesh_an, dev)
    recompress_step, recompress_in = recompress_kernel_phase(K, dev)
    for name, ms in K.ms.items():
        bound_ms, bound_by = K.bound(name, K.work[name])
        chain = (f", chain of {K.steps[name]} steps x {K.chain[name]:.3f} dependent "
                 f"instructions x {CYCLES_PER_DEP} cycles" if name in K.steps else "")
        if name in K.chain_cycles:
            chain = f", chain of {K.chain_cycles[name]} cycles"
        print(f"kernel {name}: {ms:.3f} ms on the card; plain version "
              f"{K.plain_ms[name]:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{K.work[name][0]} bytes, {K.work[name][1]} operations{chain})", flush=True)
    single_mesh_ref, _ = td.compress(clips[MESH_CLIP], chunk_mode=1, batch_size=BATCH,
                                     force_lanes=MESH_LANES, device=dev)

    # Each main path counts its own launches, from 0.
    launches = dict.fromkeys(_native.launches, 0)
    step_launched = {}
    report = {}
    paths = (
        ("profile2", PROFILE2_KERNELS, lambda: main_path_phase(clips, refs, dev)),
        ("profile0", PROFILE0_KERNELS, lambda: profile0_main_path_phase(clips, refs0, dev)),
        ("mesh", MESH_KERNELS, lambda: mesh_main_path_phase(
            clips[MESH_CLIP], single_mesh_ref, dev)),
        ("recompress", RECOMPRESS_KERNELS, lambda: {
            "total_words": int(recompress_step(*recompress_in)[4])}),
        ("transfers", PROFILE2_KERNELS + MESH_KERNELS, lambda: transfers_phase(
            clips, single_mesh_ref, dev)),
        ("modules", PROFILE2_KERNELS, lambda: modules_phase(
            clips[CLIPS[0]], refs[CLIPS[0]], card, dev)),
        ("corpus_clips", CORPUS_CLIPS_KERNELS, lambda: corpus_clips_phase(K, dev)),
    )
    for path, kernels, run in paths:
        _native.reset_launches()
        report[path] = run()
        torch.cuda.synchronize()
        counts = dict(_native.launches)
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"the {path} main path never launched {missing}")
        print(f"{path} main path launches: {counts}", flush=True)
        for k, v in counts.items():
            launches[k] += v
        for step, (_, _, used) in Kernels.STEPS.items():
            if step in kernels:
                step_launched[step] = {k: counts[k] for k in used}
    report["corpus"] = corpus_phase()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"no main path launched {missing}")
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"main_path": report}), flush=True)
    print(jax_package_phase(jax_before), flush=True)
    print(card, flush=True)
    print(K.json_line(launches, step_launched, report["corpus"]["collective"]), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
