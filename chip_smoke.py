#!/usr/bin/env python3
"""Proof that the PyTorch + CUDA port (avrecode_tpu_torch) runs on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases; any failure ends the script with a nonzero exit code:

1. build: the port's CUDA kernels (nvcc, sm_90a, from avrecode_tpu_torch/csrc)
   and, where needed, the native host library;
2. kernels: every kernel of both compress paths against its plain PyTorch
   version on the same inputs, at the full shapes of benchdata/bench.mp4's
   chunks (profile 2: every chunk; profile 0: chunk 0 at batch 4096, sup
   128), plus random lane streams with K in {16, 128}, the probability
   extremes 1 and 32767 and valid masks that are not a prefix; all values
   are integers, so the tolerance is 0;
3. main paths, each with the launch counters set to 0 just before it and
   read just after: avrecode_tpu_torch.device.compress(device="cuda") on
   bench.mp4 and multigop720.mp4, first under profile 2 (one warm-up, best
   of 3), then under profile 0 with ARTC_MODEL_IMPL=v2 (one warm-up, best of
   3) and dict, sort and mm (one run each). Every run's chunk probs equal
   the host model's, every lane blob the C++ rANS encoder's, the host
   decoder returns the input exactly, and the four profile-0 containers are
   identical; the counters show each path went through each of its kernels.

The last lines are the card's name and power limit as nvidia-smi reports
them, the per-kernel JSON and the result JSON.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CLIPS = ("benchdata/bench.mp4", "benchdata/multigop720.mp4")
BATCH, SUP = 4096, 128  # the compress path's defaults
PROFILE2_KERNELS = ("wire_expand", "dual0_expand", "model_pass_v4", "lane_scan_dev",
                    "lane_compact")
PROFILE0_KERNELS = ("model_pass_v2", "model_pass_dict", "model_pass", "lane_scan",
                    "lane_compact")
IMPLS = ("v2", "dict", "sort", "mm")


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


def host_timed(fn):
    """(fn(), host seconds of one call ending in a device synchronise)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching tensors (int64 math); raises on a shape
    or dtype mismatch."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.dtype == torch.uint16:  # widen through int16 bit patterns
        a, b = (t.view(torch.int16).long() & 0xFFFF for t in (a, b))
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def c_rans_encode(bits, probs, lanes: int) -> bytes:
    """The host C++ rANS encoder (native/rans.h) through the C ABI."""
    import numpy as np
    from avrecode_tpu import host
    lib = host.lib()
    lib.artc_rans_encode.restype = ctypes.c_int
    lib.artc_rans_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    bits = np.ascontiguousarray(bits, np.uint8)
    probs = np.ascontiguousarray(probs, np.uint16)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.artc_rans_encode(bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                              len(bits), lanes, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(lib.artc_last_error().decode())
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.artc_free(out)


class Kernels:
    """Per-kernel results: worst error over all comparisons, and the device
    times of the kernel and its plain version at main-path shapes."""

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
    }

    def __init__(self):
        self.err = {k: 0 for k in self.SOURCES}
        self.ms = {}
        self.plain_ms = {}

    def check(self, name: str, got, want, what: str) -> None:
        e = max_abs_err(got, want)
        self.err[name] = max(self.err[name], e)
        if e != 0:
            raise AssertionError(f"{name}: kernel != plain on {what} (max abs err {e})")

    def json_line(self, launches: dict) -> str:
        """launches: each kernel's count over the main-path runs (profile 2,
        then profile 0), each path counted from 0."""
        rows = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                 "launches": int(launches[k]), "max_abs_err": self.err[k],
                 "ms": self.ms[k], "plain_ms": self.plain_ms[k]}
                for k, (src, rep) in self.SOURCES.items()]
        return json.dumps({"kernels": rows})


def kernel_phase(K: Kernels, an, chunks, dev) -> None:
    """Each kernel against its plain version at the chunks' full shapes on
    `dev`; the first chunk also gives the timings."""
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    for ci, c in enumerate(chunks):
        timed = ci == 0
        st = td.to_torch_staged(an, c, dev)
        what = f"bench chunk {ci} (n={c.n}, m={c.m}, ud={c.ud}, us={c.us})"
        # dual0_expand
        d0 = [td._i32(a).to(dev) for a in td._dual0_dict(c)]
        got = mp.dual0_expand(*d0)
        K.check("dual0_expand", got, mp._dual0_expand_plain(*d0), what)
        if timed:
            K.ms["dual0_expand"] = cuda_ms(lambda: mp.dual0_expand(*d0), 20)
            K.plain_ms["dual0_expand"] = cuda_ms(lambda: mp._dual0_expand_plain(*d0), 5)
        # wire_expand4_blob
        ex = st.statics["expand"]
        got = mp.wire_expand4_blob(st.blob, st.sc, **ex)
        want = mp._wire_expand_plain(st.blob, st.sc, *(ex[k] for k in (
            "m", "nsub", "U", "ud", "us", "ns", "batch", "layout")))
        for g, w in zip(got, want):
            K.check("wire_expand", g, w, what)
        if timed:
            K.ms["wire_expand"] = cuda_ms(lambda: mp.wire_expand4_blob(st.blob, st.sc, **ex), 10)
            K.plain_ms["wire_expand"] = cuda_ms(lambda: mp._wire_expand_plain(
                st.blob, st.sc, *(ex[k] for k in (
                    "m", "nsub", "U", "ud", "us", "ns", "batch", "layout"))), 2)
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
        if timed:
            K.ms["model_pass_v4"] = cuda_ms(kernel_probs, 5)
            K.plain_ms["model_pass_v4"] = cuda_ms(lambda: mp._v3_core_plain(*margs), 1)
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
            print(f"lane_scan_dev plain version: one run of its Python step loop "
                  f"(T={T} steps, K={lanes}), timed once on the host clock: "
                  f"{plain_scan_s:.3f} s", flush=True)
            _, words, emits, counts = scan
            maxW = bucket(max(int(counts.max()), 1))
            K.check("lane_compact", lx.lane_compact(words, emits, maxW),
                    lx._lane_compact_plain(words, emits, maxW), what)
            K.ms["lane_compact"] = cuda_ms(lambda: lx.lane_compact(words, emits, maxW), 5)
            K.plain_ms["lane_compact"] = cuda_ms(
                lambda: lx._lane_compact_plain(words, emits, maxW), 3)
        print(f"kernels == plain on {what}", flush=True)
    lane_streams(K, dev)


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
            # (every third lane off) and ragged, as the mesh slices it.
            valid = rng.random((T, lanes)) < 0.8
            valid[:, ::3] = False
            planes = [torch.from_numpy(np.resize(a, T * lanes).reshape(T, lanes)).to(dev)
                      for a in (bits, probs)]
            args = (*planes, torch.from_numpy(valid).to(dev))
            for g, w in zip(lx.lane_scan(*args), lx._lane_scan_plain(*args)):
                K.check("lane_scan", g, w, what + ", non-prefix valid mask")
            print(f"kernels == plain, blobs == C++ encoder on {what} (and the masked "
                  f"scan on a non-prefix mask)", flush=True)


def profile0_kernel_phase(K: Kernels, an, dev) -> None:
    """The profile-0 kernels against their plain versions at the shapes of
    the analysis's chunk 0 (bench.mp4 at batch 4096, sup 128), timed there;
    every kernel's probs also equal the host model's."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    c = an.chunks[0]
    n = len(c.bit)
    ns, ud = c.v2_dk_d.shape
    us = c.v2_dk_s.shape[1]
    what = f"profile-0 bench chunk 0 (n={n}, m={c.v2_m}, ns={ns}, ud={ud}, us={us})"

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def padded(a, total, v):
        return np.concatenate([a.astype(np.int32), np.full(total - n, v, np.int32)])

    def host_equal(name, probs):
        if not np.array_equal(probs[:n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"{name}: probs != host probs on {what}")

    # model_pass_v2 on the native export's tables
    sh = (ns, an.sup, an.batch)
    planes = [up(padded(a, c.v2_m, v).reshape(sh)) for a, v in (
        (c.kind, 3), (c.prior, 1), (c.pre_ones, 0), (c.pre_tot, 0))]
    tables = [up(c.v2_bin_u.reshape(sh)), up(c.v2_dk_d), up(c.v2_dk_s), up(c.v2_dd),
              up(c.v2_ds),
              up(np.concatenate([c.dual0, np.ones((1 + ud, 4), np.int32)])),
              up(np.concatenate([np.zeros((an.n_sig, 2), np.int32),
                                 np.ones((us, 2), np.int32)]))]
    kw = dict(batch=an.batch, sup=an.sup, fast_w=an.fast_w, slow_w=an.slow_w,
              sig_w=an.sig_w, sig_alpha=an.sig_alpha)
    statics = [kw[k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha")]

    def v2():
        return mp.model_pass_v2(*planes, *tables, **kw)

    def v2_plain():
        return mp._model_pass_v2_plain(*planes, *tables, *statics)

    got, plain = v2(), v2_plain()
    K.check("model_pass_v2", got, plain, what)
    host_equal("model_pass_v2", got)
    K.ms["model_pass_v2"] = cuda_ms(v2, 5)
    K.plain_ms["model_pass_v2"] = cuda_ms(v2_plain, 1)
    print(f"model_pass_v2 == plain == host on {what}", flush=True)

    # model_pass_dict and model_pass on run_chunk's padded layout
    nb = bucket(-(-n // an.batch))
    m = nb * an.batch
    n_dual = c.dual0.shape[0]
    bit_p, kind_p, key_p, prior_p = (padded(a, m, v) for a, v in (
        (c.bit, 0), (c.kind, 0), (c.key, n_dual), (c.prior, 0)))
    dual_ext = np.concatenate([c.dual0.astype(np.int32), np.ones((1, 4), np.int32)])
    pkw = {k: kw[k] for k in ("batch", "fast_w", "slow_w", "sig_w", "sig_alpha")}
    pstatics = [pkw[k] for k in ("batch", "fast_w", "slow_w", "sig_w", "sig_alpha")]
    bin_u, dict_keys = mp.build_dicts(kind_p, key_p, n_dual + 1, an.batch)
    dargs = [up(a.reshape(nb, an.batch)) for a in (bit_p, kind_p, prior_p)] + [
        up(bin_u), up(dict_keys), up(dual_ext),
        up(np.zeros((an.n_sig + 1, 2), np.int32))]
    sargs = [up(a) for a in (bit_p, kind_p, key_p, prior_p, dual_ext,
                             np.zeros((an.n_sig, 2), np.int32))]
    for name, kern, plain_fn, args, extra in (
            ("model_pass_dict", mp.model_pass_dict, mp._model_pass_dict_plain, dargs, {}),
            ("model_pass", mp.model_pass, mp._model_pass_plain, sargs, {"impl": "mm"})):
        got = kern(*args, **pkw, **extra)
        plain, plain_s = host_timed(lambda: plain_fn(*args, *pstatics))
        K.check(name, got, plain, f"{what}, {nb} batches of {an.batch}")
        host_equal(name, got)
        K.ms[name] = cuda_ms(lambda: kern(*args, **pkw, **extra), 3)
        K.plain_ms[name] = plain_s * 1e3
        print(f"{name} == plain == host on {what} ({nb} batches, U={dict_keys.shape[1]}); "
              f"plain version timed once on the host clock: {plain_s:.3f} s", flush=True)

    # lane_scan at this chunk's K and T, the encode_interleaved layout
    lanes = td.pick_lanes(n)
    T = bucket(-(-n // lanes))
    lane_planes = [up(padded(a, T * lanes, v).reshape(T, lanes))
                   for a, v in ((c.bit, 0), (c.host_probs, 1))]
    valid = (torch.arange(T * lanes, device=dev) < n).reshape(T, lanes)
    scan = lx.lane_scan(*lane_planes, valid)
    plain, plain_s = host_timed(lambda: lx._lane_scan_plain(*lane_planes, valid))
    for g, w in zip(scan, plain):
        K.check("lane_scan", g, w, what)
    K.ms["lane_scan"] = cuda_ms(lambda: lx.lane_scan(*lane_planes, valid), 3)
    K.plain_ms["lane_scan"] = plain_s * 1e3
    print(f"lane_scan == plain on {what} (T={T}, K={lanes}); plain version: one run of "
          f"its Python step loop, timed once on the host clock: {plain_s:.3f} s", flush=True)


def main_path_phase(clips: dict, refs: dict, dev) -> dict:
    """compress(device=dev) on each clip: one warm-up, best of 3, then
    the checks on a further run that keeps its probs."""
    import numpy as np
    from avrecode_tpu import pipeline
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
        dec, _ = pipeline.decompress(comp)
        if dec != data:
            raise AssertionError(f"{name}: decompress(compress(x)) != x")
        best = min(times)
        report[name] = dict(bytes=len(data), container=len(comp), chunks=len(chunks),
                            bins=int(sum(c.n for c in chunks)), best_s=best,
                            runs_s=times, mb_s=len(data) / 1e6 / best,
                            wire_bytes=info["wire_bytes"],
                            host_phases_s={k: info[k] for k in (
                                "open_s", "fetch_s", "stage_s", "launch_s", "compact_s",
                                "dispatch_s", "emit_s", "pack_s")})
        print(f"main path {name}: e2e best {best:.3f} s of {['%.3f' % t for t in times]} = "
              f"{len(data) / 1e6 / best:.3f} MB/s, {report[name]['bins']} bins in "
              f"{len(chunks)} chunks, ratio {len(comp) / len(data):.5f}; probs == host, "
              f"blobs == C++ encoder, roundtrip exact", flush=True)
    return report


def profile0_main_path_phase(clips: dict, refs0: dict, dev) -> dict:
    """compress(model_profile=0, device=dev) on each clip: ARTC_MODEL_IMPL=v2
    with one warm-up and best of 3, then dict, sort and mm once each; every
    run is checked (probs == host, blobs == C++ encoder, exact roundtrip) and
    the four containers must be identical."""
    import numpy as np
    from avrecode_tpu import pipeline
    from avrecode_tpu_torch import device as td
    report = {}
    for name, data in clips.items():
        chunks = refs0[name].chunks
        want_blobs = [c_rans_encode(c.bit, c.host_probs, td.pick_lanes(len(c.bit)))
                      for c in chunks]
        containers = {}
        runs = {}
        for impl in IMPLS:
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
            dec, _ = pipeline.decompress(comp)
            if dec != data:
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
            raise AssertionError(f"{name}: the profile-0 containers differ across {IMPLS}")
        report[name] = dict(bytes=len(data), container=len(containers["v2"]),
                            chunks=len(chunks), bins=int(sum(len(c.bit) for c in chunks)),
                            impls=runs)
    return report


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import torch
        from avrecode_tpu_torch import _native
        from avrecode_tpu_torch import device as td
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    if not all(os.path.exists(os.path.join(REPO, c)) for c in CLIPS):
        fail(f"missing {CLIPS}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the GPU only")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; card {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _native.build()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    _native.ensure_host_lib()
    t_host = time.perf_counter() - t0
    print(f"build: kernels (nvcc sm_90a) {t_nvcc:.1f} s -> "
          f"{os.path.relpath(_native.LIB_PATH, REPO)}; host library {t_host:.1f} s",
          flush=True)

    clips = {c: open(os.path.join(REPO, c), "rb").read() for c in CLIPS}
    refs = {c: td.analyze(d, batch_size=BATCH, model_profile=2, sup=SUP)
            for c, d in clips.items()}
    refs0 = {c: td.analyze(d, batch_size=BATCH, model_profile=0, sup=SUP)
             for c, d in clips.items()}
    dev = torch.device("cuda")

    K = Kernels()
    kernel_phase(K, refs[CLIPS[0]], refs[CLIPS[0]].chunks, dev)
    profile0_kernel_phase(K, refs0[CLIPS[0]], dev)
    for name, ms in K.ms.items():
        print(f"kernel {name}: {ms:.3f} ms on the card; plain version "
              f"{K.plain_ms[name]:.3f} ms", flush=True)

    # Each main path counts its own launches, from 0.
    launches = dict.fromkeys(Kernels.SOURCES, 0)
    report = {}
    for profile, kernels, run in ((2, PROFILE2_KERNELS, lambda: main_path_phase(
            clips, refs, dev)), (0, PROFILE0_KERNELS, lambda: profile0_main_path_phase(
                clips, refs0, dev))):
        _native.reset_launches()
        report[f"profile{profile}"] = run()
        counts = dict(_native.launches)
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            fail(f"the profile-{profile} main path never launched {missing}")
        print(f"profile-{profile} main path launches: {counts}", flush=True)
        for k, v in counts.items():
            launches[k] += v
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"no main path launched {missing}")
    print(json.dumps({"main_path": report}), flush=True)
    print(card, flush=True)
    print(K.json_line(launches), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
