"""The two per-batch profile-0 passes (model_pass_dict; model_pass, sort and
mm) on the inputs that have broken ports of them before: seeded numpy streams
through the JAX function, the port's plain version and the numpy mirror of
the port's persistent CUDA kernels (ops/model_pass.py _walk_mirror,
_entry_pass_mirror: the kernels themselves need the card). Every value is an
integer: every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu.ops import model_pass as jmp
from avrecode_tpu_torch import _native
from avrecode_tpu_torch.ops import model_pass as tmp

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

KW = dict(fast_w=48, slow_w=640, sig_w=80, sig_alpha=(24 << 16) | 12)
N_DUAL, N_SIG = 96, 160  # N_DUAL counts the scratch row; both small, so keys repeat


def _stream(rng, nb, batch, kinds_p=(0.45, 0.2, 0.3, 0.05), n_dual=N_DUAL, n_sig=N_SIG):
    """A padded pair stream of nb batches: kinds 0-3, live dual keys below the
    scratch row, tagged and zero priors, and padding (kind 0, the scratch
    key, bit 0, prior 0) both inside a batch and at the stream's end."""
    n = nb * batch
    kinds = rng.choice(4, n, p=kinds_p).astype(np.int32)
    keys = np.where(kinds == 2, rng.integers(0, n_sig, n),
                    rng.integers(0, n_dual - 1, n)).astype(np.int32)
    bits = rng.integers(0, 2, n).astype(np.int32)
    priors = rng.integers(1, 65536, n).astype(np.int32)
    priors[rng.random(n) < 0.2] = 0
    pad = np.zeros(n, bool)
    pad[n - batch // 3:] = True
    pad[batch // 2: batch // 2 + 40] = True  # beside kind-3 bins, in one batch
    kinds[batch // 2 + 40: batch // 2 + 60] = 3
    for a, v in ((kinds, 0), (keys, n_dual - 1), (bits, 0), (priors, 0)):
        a[pad] = v
    return bits, kinds, keys, priors


def _tables(rng, over: bool, n_dual=N_DUAL, n_sig=N_SIG, untouched=()):
    """Start tables (the dual one ending in its scratch row of ones). With
    `over`, live rows start over their windows (sums up to about 9,000: the
    probabilities' int32 products stay below 2^31), and the `untouched` rows,
    which no bin may read, start with sums about 2^28."""
    hi = 4500 if over else 20
    dual = rng.integers(1, hi, (n_dual, 4)).astype(np.int32)
    sig = rng.integers(0, hi, (n_sig, 2)).astype(np.int32)
    dual[-1] = 1
    for r in untouched:
        dual[r] = 1 << 27
        sig[r] = 1 << 27
    return dual, sig


def _jax_pass(bits, kinds, keys, priors, dual, sig, batch, impl):
    return np.asarray(jmp.model_pass(*(jnp.asarray(a) for a in (bits, kinds, keys, priors, dual,
                                                               sig)),
                                     batch=batch, impl=impl, **KW)).astype(np.int32)


def _plain_pass(bits, kinds, keys, priors, dual, sig, batch, impl):
    return tmp.model_pass(*(torch.from_numpy(a) for a in (bits, kinds, keys, priors, dual, sig)),
                          batch=batch, impl=impl, **KW).numpy()


def _dict_inputs(kinds, keys, sig, batch, n_dual=N_DUAL):
    """run_chunk's dict layout: build_dicts over the padded stream, the sig
    table with its scratch row appended."""
    bin_u, dict_keys = tmp.build_dicts(kinds, keys, n_dual, batch)
    return bin_u, dict_keys, np.concatenate([sig, np.zeros((1, 2), np.int32)])


def _dict_passes(bits, kinds, keys, priors, dual, sig, batch):
    """(JAX, plain, mirror) probs of the dict pass."""
    nb = len(bits) // batch
    bin_u, dict_keys, sig_ext = _dict_inputs(kinds, keys, sig, batch)
    planes = [a.reshape(nb, batch) for a in (bits, kinds, priors)]
    want = np.asarray(jmp.model_pass_dict(
        *(jnp.asarray(a) for a in (*planes, bin_u, dict_keys, dual, sig_ext)), batch=batch,
        **KW)).astype(np.int32)
    got = tmp.model_pass_dict(*(torch.from_numpy(a) for a in (*planes, bin_u, dict_keys, dual,
                                                              sig_ext)), batch=batch, **KW)
    mirror, n_whole = tmp._entry_pass_mirror(bits, kinds, bin_u.reshape(-1), priors, dual,
                                             sig_ext, batch, *KW.values(), dict_keys=dict_keys)
    assert n_whole == 0
    return want, got.numpy(), mirror


@pytest.mark.parametrize("impl", ["sort", "mm", "dict"])
def test_tables_far_over_their_windows(impl):
    """Live rows start over their windows and rows no bin reads start with
    sums about 2^28, so JAX's whole-table halving changes untouched rows for
    several batches: JAX == plain == the kernels' formulation, which halves
    whole tables only while a row is over its window (more than once here,
    not after every batch)."""
    rng = np.random.default_rng(5)
    nb, batch = 5, 256
    bits, kinds, keys, priors = _stream(rng, nb, batch)
    far = (7, 50)
    for r in far:  # no bin reads these rows (their products would pass 2^31)
        keys[(keys == r) & (kinds != 3)] = 3
    dual, sig = _tables(rng, True, untouched=far)
    if impl == "dict":
        want, got, mirror = _dict_passes(bits, kinds, keys, priors, dual, sig, batch)
    else:
        want = _jax_pass(bits, kinds, keys, priors, dual, sig, batch, impl)
        got = _plain_pass(bits, kinds, keys, priors, dual, sig, batch, impl)
        mirror, n_whole = tmp._entry_pass_mirror(bits, kinds, keys, priors, dual, sig, batch,
                                                 *KW.values())
        assert 2 <= n_whole < nb
    assert np.array_equal(got, want)
    assert np.array_equal(mirror, want)


@pytest.mark.parametrize("impl", ["sort", "mm", "dict"])
@pytest.mark.parametrize("nb", [1, 3])
def test_scratch_key_mix_and_odd_batch_counts(impl, nb):
    """Kind-3 bins and padding share the dual scratch key inside one batch
    (kind-3 bits count in the key's prefix but add nothing; pad bins add
    zeros), over a batch count that is not a power of two, pad batches'
    probs included: JAX == plain == the kernels' formulation, with one
    whole-table halving (seeds within their windows)."""
    rng = np.random.default_rng(nb)
    batch = 512
    bits, kinds, keys, priors = _stream(rng, nb, batch, kinds_p=(0.3, 0.2, 0.2, 0.3))
    bits[kinds == 3] = rng.integers(0, 2, int((kinds == 3).sum()))
    dual, sig = _tables(rng, False)
    if impl == "dict":
        want, got, mirror = _dict_passes(bits, kinds, keys, priors, dual, sig, batch)
    else:
        want = _jax_pass(bits, kinds, keys, priors, dual, sig, batch, impl)
        got = _plain_pass(bits, kinds, keys, priors, dual, sig, batch, impl)
        mirror, n_whole = tmp._entry_pass_mirror(bits, kinds, keys, priors, dual, sig, batch,
                                                 *KW.values())
        assert n_whole == 1
    assert np.array_equal(got, want)
    assert np.array_equal(mirror, want)


def test_keys_past_the_tables_clamp_on_read_and_drop_on_add():
    """Keys at or past a table's end: gathers clamp to the last row, adds are
    dropped, and a kind-0 key past the dual table shares its unified key
    with a sig key. The plain version and the kernels' formulation (which
    flags such a batch) equal JAX."""
    rng = np.random.default_rng(11)
    nb, batch = 3, 256
    bits, kinds, keys, priors = _stream(rng, nb, batch)
    live = np.flatnonzero(kinds != 3)
    odd = rng.choice(live, 60, replace=False)
    keys[odd] = np.where(kinds[odd] == 2, N_SIG + rng.integers(0, 5, 60),
                         N_DUAL + rng.integers(0, 5, 60))
    dual, sig = _tables(rng, False)
    want = _jax_pass(bits, kinds, keys, priors, dual, sig, batch, "sort")
    assert np.array_equal(_plain_pass(bits, kinds, keys, priors, dual, sig, batch, "sort"), want)
    mirror, _ = tmp._entry_pass_mirror(bits, kinds, keys, priors, dual, sig, batch, *KW.values())
    assert np.array_equal(mirror, want)
    flagged = [tmp._walk_mirror(keys[s], bits[s], kinds[s], N_DUAL, N_SIG)[3]
               for s in (slice(b * batch, (b + 1) * batch) for b in range(nb))]
    assert flagged == [bool(np.isin(odd, np.arange(b * batch, (b + 1) * batch)).any())
                       for b in range(nb)]


@pytest.mark.parametrize("impl", ["sort", "mm"])
def test_chunk_axis_matches_per_chunk_loop_and_vmap(impl):
    """model_pass over a leading chunk axis (every chunk its own tables)
    equals a loop over the chunks and jax.vmap of the JAX function."""
    rng = np.random.default_rng(2)
    G, nb, batch = 3, 3, 256
    streams = [_stream(rng, nb, batch) for _ in range(G)]
    tables = [_tables(rng, g == 1) for g in range(G)]
    stacked = [np.stack([s[i] for s in streams]) for i in range(4)] + [
        np.stack([t[i] for t in tables]) for i in range(2)]
    got = tmp.model_pass(*(torch.from_numpy(a) for a in stacked), batch=batch, impl=impl,
                         **KW).numpy()
    assert got.shape == (G, nb * batch)
    want = np.asarray(jax.vmap(lambda *a: jmp.model_pass(*a, batch=batch, impl=impl, **KW))(
        *(jnp.asarray(a) for a in stacked))).astype(np.int32)
    assert np.array_equal(got, want)
    for g in range(G):
        assert np.array_equal(got[g], _plain_pass(*streams[g], *tables[g], batch, impl))


@pytest.mark.parametrize("batch", [100, 512])
def test_pre_pass_mirror_matches_definition(batch):
    """The kernels' pre-pass (32 bins a step, equal keys grouped, running
    counts per key): its packed prefix counts equal _prefix_counts_plain and
    the definition; entries are the distinct unified keys in order of first
    appearance, each bin points at its key's entry, and an entry's totals
    are the counts of its bins masked by kind (not the prefix totals)."""
    rng = np.random.default_rng(batch)
    bits, kinds, keys, _ = _stream(rng, 1, batch, kinds_p=(0.3, 0.2, 0.3, 0.2))
    bits[kinds == 3] = 1
    pre, bin_e, ent, hazard = tmp._walk_mirror(keys, bits, kinds, N_DUAL, N_SIG)
    assert not hazard
    ukey = np.where(kinds == 3, N_DUAL - 1, np.where(kinds == 2, keys + N_DUAL, keys))
    p1, pt = tmp._prefix_counts_plain(torch.from_numpy(ukey[None].astype(np.int64)),
                                      torch.from_numpy(bits[None].astype(np.int64)))
    assert np.array_equal(pre & 0xFFFF, p1[0].numpy())
    assert np.array_equal(pre >> 16, pt[0].numpy())
    same = ukey[:, None] == ukey[None, :]
    earlier = np.tri(batch, k=-1, dtype=bool)
    assert np.array_equal(pre >> 16, (same & earlier).sum(1))
    assert np.array_equal(pre & 0xFFFF, (same & earlier & (bits[None] == 1)).sum(1))
    first = np.flatnonzero((pre >> 16) == 0)  # the first bin of each key, in order
    assert np.array_equal(bin_e[first], np.arange(len(first))) and len(ent) == len(first)
    assert np.array_equal(ukey[first][bin_e], ukey)
    for e, i in enumerate(first):
        members = ukey == ukey[i]
        d = members & (kinds != 2) & (kinds != 3)
        s = members & (kinds == 2)
        uk = int(ukey[i])
        assert ent[e, 0] == min(uk, N_DUAL - 1) and ent[e, 1] == min(max(uk - N_DUAL, 0),
                                                                      N_SIG - 1)
        assert ent[e, 2] == (tmp._LIVE_BIT if uk < N_DUAL else 0) \
            | int(bits[d].sum()) | int(d.sum()) << tmp._TOT_SHIFT
        assert ent[e, 3] == (tmp._LIVE_BIT if uk >= N_DUAL else 0) \
            | int(bits[s].sum()) | int(s.sum()) << tmp._TOT_SHIFT
    scratch = bin_e[np.flatnonzero(kinds == 3)[0]]
    assert (ent[scratch, 2] >> tmp._TOT_SHIFT & tmp._COUNT_MASK) == \
        int(((ukey == N_DUAL - 1) & (kinds == 0)).sum())


def test_dict_pre_pass_mirror_never_writes_scratch_rows():
    """The dict pass's entries: padding entries repeat the dual scratch key
    and every entry aliases the other table's scratch row; neither scratch
    row is ever writable, and bin_u is clamped to the dictionary."""
    rng = np.random.default_rng(4)
    batch = 256
    bits, kinds, keys, _ = _stream(rng, 1, batch)
    sig = np.zeros((N_SIG, 2), np.int32)
    bin_u, dict_keys, sig_ext = _dict_inputs(kinds, keys, sig, batch)
    U = dict_keys.shape[1]
    wild = bin_u[0].copy()
    wild[:3] = (-4, U, U + 9)
    _, bin_e, ent, _ = tmp._walk_mirror(wild, bits, kinds, N_DUAL, len(sig_ext), dict_keys[0])
    assert (dict_keys[0] == N_DUAL - 1).sum() > 1
    assert bin_e.min() == 0 and bin_e.max() == U - 1 and list(bin_e[:3]) == [0, U - 1, U - 1]
    writable_d = ent[:, 2] & tmp._LIVE_BIT != 0
    writable_s = ent[:, 3] & tmp._LIVE_BIT != 0
    assert not (ent[writable_d, 0] == N_DUAL - 1).any()
    assert not (ent[writable_s, 1] == len(sig_ext) - 1).any()
    assert not (writable_d & writable_s).any()
    assert np.array_equal(writable_d | writable_s, dict_keys[0] != N_DUAL - 1)
