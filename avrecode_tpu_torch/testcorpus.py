"""The frozen test corpus, and the checks that hold the port to the JAX
package's bytes on it.

testdata/corpus/ holds the clips that tests/conftest.py's generator writes
(tools/make_corpus.cc through libx264, tools/make_synth.cc for the PAFF, SP
and separate-plane streams; testdata/corpus/README.md gives each clip's
spec), frozen, because x264's output differs between versions. Beside them,
manifest.json holds each clip's SHA-256 and, for each (clip, mode) of
CORPUS_MODES that the clip admits, the digest of the container the JAX
package writes on the CPU (container_digest), or the error it raises. The
manifest is written by tests/test_torch_corpus_manifest.py (`--write`): the
port imports no JAX.

`check_clip` runs every mode of one clip through the port on a device and
holds the result to the manifest; `KernelCheck` holds every kernel those
modes launch against its plain version on each chunk's staged inputs.
chip_smoke.py's corpus_clips phase and tests/test_torch_cuda.py run both on
the card; tests/test_torch_corpus_port.py runs them on the CPU.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import multiprocessing
import os
import time
from collections import Counter
from concurrent.futures import Future, ProcessPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _native, host
from . import device as td
from .ops import lanes as lx
from .ops import model_pass as mp
from .parallel.mesh import make_mesh

CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata", "corpus")
MANIFEST = os.path.join(CORPUS_DIR, "manifest.json")
# The warm-section environment: multislice.264 runs as warm-started
# sections, so its chunks carry a nonzero sparse sig0.
WARM_ENV = {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
            "ARTC_WARM_BINS": "120000"}
P0_IMPLS = ("dict", "sort", "mm")  # must write the same container as v2


@dataclass(frozen=True)
class CorpusMode:
    """One way of compressing a corpus clip: compress's keywords, the
    environment it runs in, and for the mesh its (gop, lane) grid
    (compress_mesh, held to the single-device container at the same
    keywords). `clips`, if given, are the only clips the mode runs on; a
    mesh mode runs only on clips of two or more GOP chunks."""
    kw: dict
    env: dict = field(default_factory=dict)
    mesh: tuple[int, int] | None = None
    clips: tuple[str, ...] | None = None

    @property
    def profile(self) -> int:
        return self.kw["model_profile"]

    def admits(self, clip: str, gop_chunks: int) -> bool:
        if self.clips is not None and clip not in self.clips:
            return False
        return self.mesh is None or gop_chunks >= 2

    def record(self) -> dict:
        """The mode as the manifest lists it."""
        return {"kw": self.kw, "env": self.env, "mesh": list(self.mesh) if self.mesh else None,
                "clips": list(self.clips) if self.clips else None}


CORPUS_MODES = {
    "p2_b4096": CorpusMode(dict(model_profile=2, chunk_mode=0, batch_size=4096)),
    "p2_b512": CorpusMode(dict(model_profile=2, chunk_mode=0, batch_size=512)),
    "p2_gop": CorpusMode(dict(model_profile=2, chunk_mode=1, batch_size=512)),
    "p2_k4": CorpusMode(dict(model_profile=2, chunk_mode=0, batch_size=512, force_lanes=4)),
    "p0_v2": CorpusMode(dict(model_profile=0, chunk_mode=0, batch_size=512),
                        {"ARTC_MODEL_IMPL": "v2"}),
    "mesh_2x2": CorpusMode(dict(model_profile=2, chunk_mode=1, batch_size=512,
                                force_lanes=16), mesh=(2, 2)),
    "p2_warm": CorpusMode(dict(model_profile=2, chunk_mode=0, batch_size=512), WARM_ENV,
                          clips=("multislice.264",)),
}


@contextlib.contextmanager
def corpus_env(env: dict):
    """The environment variables `env`, set for the block and restored
    after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def clip_names() -> list[str]:
    """The corpus's clips (every file of CORPUS_DIR but the manifest and
    the README), sorted."""
    return sorted(f for f in os.listdir(CORPUS_DIR) if f not in ("manifest.json", "README.md"))


def clip_bytes(name: str) -> bytes:
    with open(os.path.join(CORPUS_DIR, name), "rb") as f:
        return f.read()


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def container_digest(comp: bytes) -> str:
    """The SHA-256 of a container without its build provenance. The header
    (native/recode.h) holds, after the magic and the version, a u8 length
    and the writing build's git revision ("nogit" outside a git checkout):
    the only bytes that depend on which build of the host library wrote the
    container, so they are cut out. Everything else, the input's CRC-32
    included, is hashed."""
    if comp[:4] != b"ATRC" or len(comp) < 6 or comp[4] < 26:
        raise ValueError("not an ATRC container of version 26 or later")
    return sha256(comp[:5] + comp[6 + comp[5]:])


def build_field(comp: bytes) -> bytes:
    """The container's build provenance (the writing build's git revision)."""
    return comp[6:6 + comp[5]]


@functools.cache
def library_build() -> bytes:
    """The build provenance this process's host library writes (from a
    host-engine container of the corpus's smallest clip)."""
    small = min(clip_names(), key=lambda n: os.path.getsize(os.path.join(CORPUS_DIR, n)))
    return build_field(host.compress(clip_bytes(small))[0])


def outcome(fn) -> dict:
    """fn()'s container as {"digest": container_digest(...)}, or the error it
    raised as {"error": "<type>: <text>"}."""
    try:
        comp, _ = fn()
    except Exception as e:  # the manifest records what the reference raised
        return {"error": f"{type(e).__name__}: {e}"}
    return {"digest": container_digest(comp)}


def port_container(data: bytes, mode: CorpusMode, device="cuda", info: dict | None = None):
    """The port's (container, stats) for `mode`: compress on `device`, or
    compress_mesh on the mode's grid with `device` in every cell, in the
    mode's environment."""
    with corpus_env(mode.env):
        if mode.mesh is None:
            return td.compress(data, device=device, info=info,
                               keep_probs=info is not None, **mode.kw)
        cells = mode.mesh[0] * mode.mesh[1]
        grid = make_mesh(*mode.mesh, [device] * cells)
        return td.compress_mesh(data, grid, **{k: v for k, v in mode.kw.items()
                                               if k != "model_profile"})


def mode_analysis(data: bytes, mode: CorpusMode):
    """The host analysis of the chunks `mode`'s compress runs (with the host
    model's probabilities)."""
    with corpus_env(mode.env):
        return td.analyze(data, chunk_mode=mode.kw["chunk_mode"],
                          batch_size=mode.kw["batch_size"], model_profile=mode.profile,
                          sup=mp.default_sup())


def first_diff(a: bytes, b: bytes) -> int:
    """The first index where a and b differ (the shorter length if one is
    a prefix of the other)."""
    x = np.frombuffer(a[:min(len(a), len(b))], np.uint8)
    y = np.frombuffer(b[:len(x)], np.uint8)
    bad = np.flatnonzero(x != y)
    return int(bad[0]) if len(bad) else len(x)


def check_chunks(what: str, an, info: dict, lanes: int | None) -> int:
    """Each chunk's probs (info["probs"]) equal the host model's and its lane
    blob (info["blobs"]) the C++ encoder's; returns the chunk count."""
    if info["n_chunks"] != len(an.chunks):
        raise AssertionError(f"{what}: {info['n_chunks']} chunks vs {len(an.chunks)} analysed")
    for i, c in enumerate(an.chunks):
        got, want = info["probs"][i], c.host_probs
        if not np.array_equal(got, want):
            bad = first_diff(got.tobytes(), want.astype(got.dtype).tobytes()) // got.itemsize
            raise AssertionError(f"{what} chunk {i}: probs != host model (first at bin {bad})")
        bits = (c.packed >> 15).astype(np.uint8) if an.slim else c.bit
        blob = host.rans_encode(bits, want, lanes or td.pick_lanes(len(want)))
        if info["blobs"][i] != blob:
            raise AssertionError(f"{what} chunk {i}: lane blob != C++ encoder (first at byte "
                                 f"{first_diff(info['blobs'][i], blob)})")
    return len(an.chunks)


def check_container(what: str, comp: bytes, want: dict, data: bytes, build: bytes) -> None:
    """The container's digest is the manifest's (the JAX package's bytes),
    its build provenance is this host library's, and the host decoder gives
    back the input exactly."""
    got = container_digest(comp)
    if got != want["digest"]:
        raise AssertionError(f"{what}: container digest {got} != the JAX package's "
                             f"{want['digest']} ({len(comp)} bytes)")
    if build_field(comp) != build:
        raise AssertionError(f"{what}: build provenance {build_field(comp)!r} != the host "
                             f"library's {build!r}")
    dec, _ = host.decompress(comp)
    if dec != data:
        raise AssertionError(f"{what}: decompress(compress(x)) != x (first at byte "
                             f"{first_diff(dec, data)})")


def check_clip(name: str, device, man: dict | None = None, modes=None, kernels=None,
               impls=P0_IMPLS) -> dict:
    """Runs each of the clip's manifest modes (or those of `modes`) through
    the port on `device` and checks: the clip's SHA-256; every chunk's probs
    against the host model and its lane blob against the C++ encoder; the
    container's digest against the manifest (JAX's bytes) or, where JAX
    raised, the same error; decompress gives back the input; under profile
    0, each of `impls` (dict, sort and mm) writes v2's container. Any
    mismatch raises, naming
    the clip, the mode, the chunk and the first differing bin or byte.

    With `kernels` (a KernelCheck), every kernel the modes launch is also
    handed to it with each chunk's staged inputs (those launches are not
    counted); its verdicts come with its `flush`. Returns {"modes",
    "chunks", "errors", "seconds"}."""
    t0 = time.perf_counter()
    man = man or manifest()
    entry = man["clips"][name]
    data = clip_bytes(name)
    if sha256(data) != entry["sha256"]:
        raise AssertionError(f"{name}: clip SHA-256 {sha256(data)} != the manifest's")
    build = library_build()
    done, chunks, errors = [], 0, 0
    for mode_name, want in entry["modes"].items():
        if modes is not None and mode_name not in modes:
            continue
        mode = CORPUS_MODES[mode_name]
        what = f"{name} {mode_name}"
        done.append(mode_name)
        if "error" in want:
            got = outcome(lambda: port_container(data, mode, device))
            if got != want:
                raise AssertionError(f"{what}: the port gave {got}, JAX raised {want['error']!r}")
            errors += 1
            continue
        if mode.mesh is not None:
            comp, st = port_container(data, mode, device)
            check_container(what, comp, want, data, build)
            chunks += st.n_chunks
            continue
        info: dict = {}
        comp, _ = port_container(data, mode, device, info=info)
        an = mode_analysis(data, mode)
        chunks += check_chunks(what, an, info, mode.kw.get("force_lanes"))
        check_container(what, comp, want, data, build)
        if mode.profile == 0:
            for impl in impls:
                other, _ = port_container(data, CorpusMode(
                    mode.kw, {**mode.env, "ARTC_MODEL_IMPL": impl}), device)
                if other != comp:
                    raise AssertionError(f"{what}: ARTC_MODEL_IMPL={impl} wrote another "
                                         f"container than v2 (first at byte "
                                         f"{first_diff(other, comp)})")
        if kernels is not None:
            with corpus_env(mode.env):
                kernels.analysis(what, an, device, mode.kw.get("force_lanes"))
    return {"modes": done, "chunks": chunks, "errors": errors,
            "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave _native.launches as they were: the
    comparisons with the plain versions are not the main path's."""
    saved = dict(_native.launches)
    try:
        yield
    finally:
        _native.launches.update(saved)


# ------------------------------------------- plain versions, on the host CPU

def _pack(t: torch.Tensor) -> tuple:
    """A tensor as (dtype name, shape, bytes): what crosses to a worker
    process, and what a digest covers."""
    t = t.detach().contiguous().cpu()
    return str(t.dtype).removeprefix("torch."), tuple(t.shape), \
        t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _unpack(p: tuple) -> torch.Tensor:
    dtype, shape, raw = p
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else torch.empty(
        0, dtype=torch.uint8)
    return flat.view(getattr(torch, dtype)).reshape(shape)


def digest(out) -> str:
    """The SHA-256 of a tensor, or of a tuple or list of them: dtypes,
    shapes and bytes. Equal digests are equal outputs (max abs error 0)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        dtype, shape, raw = _pack(t)
        h.update(f"{dtype}{shape}".encode())
        h.update(raw)
    return h.hexdigest()


def _v3_plain(kind, slot, prior, dk_d, dk_s, deltas, dual0, *rest):
    """_v3_core_plain, with the warm sig rows (idx, val) last among the
    tensors when there are any: rest = ([idx, val,] statics...)."""
    sig, statics = (rest[:2], rest[2:]) if isinstance(rest[0], torch.Tensor) else (
        (None, None), rest)
    return mp._v3_core_plain(kind, slot, prior, dk_d, dk_s, deltas, dual0, *statics, *sig)


def _scan_group(planes: list) -> list:
    """The plain lane scan of chunks of one lane count K and one step count
    T in one run over a chunk axis (the plain scan's own [G, T, K] form);
    returns each chunk's outputs."""
    b, p, v = (torch.stack(x) for x in zip(*planes))
    x, words, emits, counts = lx._lane_scan_plain(b, p, v)
    return [(x[g], words[g], emits[g], counts[g]) for g in range(len(planes))]


PLAIN = {
    "dual0_expand": mp._dual0_expand_plain,
    "wire_expand": mp._wire_expand_plain,
    "model_pass_v4": _v3_plain,
    "model_pass_v2": mp._model_pass_v2_plain,
    "model_pass_dict": mp._model_pass_dict_plain,
    "model_pass": mp._model_pass_plain,
    "lane_compact": lx._lane_compact_plain,
}


def _worker_init() -> None:
    torch.set_num_threads(1)


def _plain_job(name: str, packed: list, statics: tuple) -> tuple:
    """(digest of PLAIN[name] on the unpacked tensors and statics, seconds);
    a lane-scan group gives a digest a chunk."""
    t0 = time.perf_counter()
    tensors = [_unpack(p) for p in packed]
    if name == "lane_scan":
        out = [digest(o) for o in _scan_group([tensors[i:i + 3]
                                               for i in range(0, len(tensors), 3)])]
    else:
        out = digest(PLAIN[name](*tensors, *statics))
    return out, time.perf_counter() - t0


def _done(value) -> Future:
    f: Future = Future()
    f.set_result(value)
    return f


class KernelCheck:
    """Holds every kernel a chunk's main path launches against its plain
    version on the chunk's staged inputs, built as the main path builds
    them: for a profile-2 chunk the dual0 expand, the wire expand, the
    frozen-batch pass (rows 1-3), the lane scan and the compaction (rows 4
    and 5); for a profile-0 chunk model_pass_v2, model_pass_dict, model_pass
    (sort and mm launch one kernel), the masked lane scan and the
    compaction (rows 6-9, 7 and 5).

    The kernels run where the chunk is staged; their inputs are copied to
    the host, where the plain versions run in `workers` spawned processes
    (0: in this one) while the caller goes on. Each plain run returns the
    digest of its outputs (dtypes, shapes, bytes), held against the
    kernel's at `flush`: equal digests are a max abs error of 0; on a
    difference the plain version runs again here and `check(name, got,
    want, what)` (chip_smoke.py's Kernels.check) gets both outputs, whose
    message names the first differing index. Identical inputs (one chunk
    under two modes) run their plain version once. The plain lane scans of
    one (K, T) run as one group over a chunk axis. `counts` holds the
    chunks each kernel was held on, `seconds` the workers' time in the plain
    versions."""

    def __init__(self, check, workers: int = 0):
        self.check = check
        self.counts: Counter = Counter()
        self.seconds: Counter = Counter()
        self.clips: Counter = Counter()  # clip -> kernel comparisons
        self._pool = None
        if workers:
            self._pool = ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init)
        self._jobs: dict = {}  # input key -> (plain name, Future of (digest, seconds))
        self._pending: list = []  # (name, job key, kernel outputs, kernel digest, retry, what)
        self._scans: list = []  # (name, kernel outputs, packed planes, planes key, what)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    @property
    def queued(self) -> int:
        return len(self._pending) + len(self._scans)

    def _submit(self, name: str, packed: list, statics: tuple) -> str:
        h = hashlib.sha256(repr((name, statics)).encode())
        for p in packed:
            h.update(repr(p[:2]).encode())
            h.update(p[2])
        key = h.hexdigest()
        if key not in self._jobs:
            if self._pool is None:
                self._jobs[key] = (name, _done(_plain_job(name, packed, statics)))
            else:
                self._jobs[key] = (name, self._pool.submit(_plain_job, name, packed, statics))
        return key

    def _queue(self, name: str, got, tensors, statics, what: str, plain: str | None = None):
        """Hands kernel `name`'s outputs `got` and its inputs to the plain
        version PLAIN[plain or name]."""
        packed = [_pack(t) for t in tensors]
        key = self._submit(plain or name, packed, statics)
        self._pending.append((name, key, got, digest(got), (plain or name, packed, statics),
                              what))

    def analysis(self, what: str, an, device, force_lanes: int | None) -> None:
        """Every chunk of `an` (a profile-2 or profile-0 analysis)."""
        with uncounted():
            cache: dict = {}
            for i, c in enumerate(an.chunks):
                where = f"{what} chunk {i}"
                if an.slim:
                    self._slim_chunk(where, an, c, device, cache, force_lanes)
                else:
                    self._dense_chunk(where, an, c, device, force_lanes)

    def _slim_chunk(self, what, an, c, device, cache, force_lanes) -> None:
        st = td.to_torch_staged(an, c, device, cache)
        d0 = [td._wire(a).to(device) for a in td._dual0_dict(c)]
        got = mp.dual0_expand(*d0)
        self._queue("dual0_expand", got, d0, (), what)
        self.check("dual0_expand", st.dual0, got, f"{what}: the staged table")
        ex = st.statics["expand"]
        eargs = tuple(ex[k] for k in ("m", "nsub", "U", "ud", "us", "ns", "batch", "layout"))
        planes = tuple(mp.wire_expand4_blob(st.blob, st.sc, **ex))
        self._queue("wire_expand", planes, (st.blob, st.sc), eargs, what)
        bit, kind, slot, prior, deltas, dk_d, dk_s = planes
        mo = st.statics["model"]
        probs, bits = mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                       sig0_idx=st.s_idx, sig0_val=st.s_val, **mo)
        sig = [t for t in (st.s_idx, st.s_val) if t is not None]
        self._queue("model_pass_v4", probs, [kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                             *sig],
                    tuple(mo[k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w",
                                          "sig_alpha", "ud", "us", "n_sig")), what)
        if c.n:
            K = force_lanes or td.pick_lanes(c.n)
            T = lx._bucket(-(-c.n // K))
            scan = lx.lane_scan_dev(bits, probs, c.n, T, K)
            self._scan("lane_scan_dev", scan, lx._dev_planes(bits, probs, c.n, T, K), what)
            self._compact(scan, what)

    def _dense_chunk(self, what, an, c, device, force_lanes) -> None:
        n = len(c.bit)
        if n == 0:
            return
        sig0 = td._sig0_dense(c, an.n_sig)
        tables = (c.v2_m, c.v2_bin_u, c.v2_dk_d, c.v2_dk_s, c.v2_dd, c.v2_ds)
        if c.v2_bin_u is None:  # no native tables: the host builds them, as device_probs does
            tables = mp.v2_host_tables(c.bit, c.kind, c.key, c.dual0, an.batch, an.sup,
                                       an.n_sig)
        args, kw = mp.v2_tables_inputs(c.kind, c.prior, c.pre_ones, c.pre_tot, *tables,
                                       c.dual0, an.batch, an.sup, an.fast_w, an.slow_w,
                                       an.sig_w, an.sig_alpha, an.n_sig, sig0, device=device)
        got = mp.model_pass_v2(*args, **kw)
        self._host_probs("model_pass_v2", got, c, what)
        self._queue("model_pass_v2", got, args, tuple(kw[k] for k in (
            "batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha")), what)
        common = (c.bit, c.kind, c.key, c.prior, c.dual0, an.batch, an.fast_w, an.slow_w,
                  an.sig_w, an.sig_alpha, an.n_sig)
        for name, impl, kernel in (("model_pass_dict", "dict", mp.model_pass_dict),
                                   ("model_pass", "sort", mp.model_pass)):
            args, kw = mp.run_chunk_inputs(*common, impl, sig0, device=device)
            got = kernel(*args, **kw)
            self._host_probs(name, got, c, what)
            self._queue(name, got, args, tuple(kw[k] for k in (
                "batch", "fast_w", "slow_w", "sig_w", "sig_alpha")), what)
        planes = lx.interleaved_planes(c.bit, c.host_probs, force_lanes or td.pick_lanes(n),
                                       device)
        scan = lx.lane_scan(*planes)
        self._scan("lane_scan", scan, planes, what)
        self._compact(scan, what)

    def _host_probs(self, name, probs, c, what) -> None:
        n = len(c.host_probs)
        if not np.array_equal(probs[:n].cpu().numpy(), c.host_probs.astype(np.int32)):
            raise AssertionError(f"{name}: probs != host model on {what}")

    def _compact(self, scan, what) -> None:
        _, words, emits, counts = scan
        maxW = lx._bucket(max(int(counts.max()), 1))
        got = lx.lane_compact(words, emits, maxW)
        self._queue("lane_compact", got, (words, emits), (maxW,), what)

    def _scan(self, name, scan, planes, what) -> None:
        """A lane scan's outputs and the [T, K] planes its plain version
        scans (bits and probs as int32, the plain scan widens them), held
        until `flush` groups them."""
        b, p, v = planes
        packed = [_pack(b.to(torch.int32)), _pack(p.to(torch.int32)), _pack(v)]
        key = sha256(repr(packed[0][1]).encode() + b"".join(x[2] for x in packed))
        self._scans.append((name, tuple(scan), packed, key, what))

    def flush(self) -> None:
        """Submits the queued lane scans, one plain run for each (K, T) over
        every queued chunk (identical planes once), then holds every queued
        kernel against its plain version; raises on the first difference."""
        groups: dict = {}
        for _, _, packed, key, _ in self._scans:
            groups.setdefault(packed[0][1], {}).setdefault(key, packed)
        index = {}
        for unique in groups.values():
            job = self._submit("lane_scan", [p for packed in unique.values() for p in packed],
                               ())
            index.update({key: (job, g) for g, key in enumerate(unique)})
        for name, scan, packed, key, what in self._scans:
            job, g = index[key]
            self._pending.append((name, job, scan, digest(scan), ("lane_scan", packed, g),
                                  what))
        self._scans.clear()
        for name, job, got, got_digest, retry, what in self._pending:
            want, _ = self._jobs[job][1].result()
            if retry[0] == "lane_scan":
                want = want[retry[2]]
            if want != got_digest:
                self._differs(name, got, retry, what)
            self.counts[name] += 1
            self.clips[what.split(" ")[0]] += 1
        self._pending.clear()
        for name, job in self._jobs.values():
            self.seconds[name] += job.result()[1]
        self._jobs.clear()

    def _differs(self, name, got, retry, what) -> None:
        """Runs the plain version here and hands both outputs to `check`,
        naming the first differing index; raises if `check` does not."""
        fn, packed, statics = retry
        tensors = [_unpack(p) for p in packed]
        statics = () if fn == "lane_scan" else statics
        want = (_scan_group([tensors])[0] if fn == "lane_scan"
                else PLAIN[fn](*tensors, *statics))
        pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
        for i, (g, w) in enumerate(pairs):
            if g.shape == w.shape and g.dtype == w.dtype:
                bad = (g.cpu().reshape(-1) != w.reshape(-1)).nonzero()
                if len(bad):
                    where = f"{what}, output {i}, first at flat index {int(bad[0])}"
                    self.check(name, g, w.to(g.device), where)
                    raise AssertionError(f"{name}: kernel != plain on {where}")
            else:
                self.check(name, g, w.to(g.device), f"{what}, output {i}")
        raise AssertionError(f"{name}: kernel digest != plain digest on {what}")
