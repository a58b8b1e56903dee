"""The port's kernel wrappers, on the CPU, against the JAX Pallas kernels.

On a CPU tensor each wrapper in ``cylon_tpu_torch.kernels`` runs its
plain PyTorch version; here that version is held bit for bit against the
Pallas kernel in interpret mode (``CYLON_PALLAS=interpret``, as
``tests/test_pallas.py`` runs it) and against the jnp path the Pallas
kernel replaces. The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import hash as jhash
from cylon_tpu.ops import hash_join as jhj
from cylon_tpu.ops import kernels as jkernels
from cylon_tpu.ops import pallas_kernels as pk
from cylon_tpu_torch import kernels as tk
from cylon_tpu_torch import telemetry as tel
from cylon_tpu_torch.kernels import bucket as tbucket
from cylon_tpu_torch.kernels import scan as tscan
from cylon_tpu_torch.ops import hash as thash
from cylon_tpu_torch.ops import kernels as tops

#: a hash tile is 8 x 1024 elements, a scan tile 8 x 2048
HASH_SIZES = [4096, 4097, 3 * 8192 + 5]
SCAN_SIZES = [4096, 4097, 3 * 16384 + 5]
SEED = 0x9747B28C   # the murmur seed both packages default to


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CYLON_PALLAS", "interpret")


def _bits(a: np.ndarray) -> torch.Tensor:
    """u32 numpy array -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("nparts", [0, 7])
@pytest.mark.parametrize("n,nwords", [(HASH_SIZES[0], 1), (HASH_SIZES[1], 2),
                                      (HASH_SIZES[2], 3), (HASH_SIZES[1], 5),
                                      (HASH_SIZES[2], 2)])
def test_row_hash_plain_matches_pallas(n, nwords, nparts, pallas_interpret):
    rng = np.random.default_rng(1000 * nwords + n)
    words = [rng.integers(0, 2 ** 32, n, dtype=np.uint32)
             for _ in range(nwords)]
    want = np.asarray(pk.row_hash([jnp.asarray(w) for w in words], nparts))
    # the jnp chain the kernel replaces (hash.hash_columns' fallback)
    h = jnp.full(n, jnp.uint32(SEED))
    for w in words:
        h = jhash._mix_word(h, jnp.asarray(w))
    h = jhash._fmix32(h ^ jnp.uint32(4 * nwords))
    if nparts:
        h = (h % jnp.uint32(nparts)).astype(jnp.int32)
    np.testing.assert_array_equal(np.asarray(h), want)

    got = tk.row_hash([_bits(w) for w in words], nparts, seed=SEED)
    assert got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(got if nparts else got.view(np.uint32),
                                  want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
@pytest.mark.parametrize("kind", ["add", "max"])
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_scan32_int_plain_matches_pallas(n, kind, dtype, pallas_interpret):
    rng = np.random.default_rng(n)
    info = np.iinfo(dtype)
    # full-range values: the add wraps many times over
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    want = np.asarray(pk.scan32(jnp.asarray(x), kind))
    jnp_path = (jnp.cumsum(jnp.asarray(x), dtype=x.dtype) if kind == "add"
                else jax.lax.cummax(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jnp_path), want)
    got = tscan.scan32(torch.from_numpy(x), kind)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_scan32_float_plain_matches_pallas(n, pallas_interpret):
    rng = np.random.default_rng(n + 1)
    # add: positive values keep every prefix well away from 0, so a
    # relative tolerance holds; the summation orders differ
    pos = rng.random(n, dtype=np.float32)
    want = np.asarray(pk.scan32(jnp.asarray(pos), "add"))
    got = tscan.scan32(torch.from_numpy(pos), "add").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # max: bit-exact, NaN included (it propagates, as jnp.maximum does)
    x = rng.normal(size=n).astype(np.float32)
    x[n // 3] = np.nan
    want = np.asarray(pk.scan32(jnp.asarray(x), "max"))
    got = tscan.scan32(torch.from_numpy(x), "max").numpy()
    assert np.isnan(got[n // 3:]).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jax.lax.cummax(jnp.asarray(x))).view(np.uint32),
        want.view(np.uint32))


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_pair_max_scan_plain_matches_pallas(n, pallas_interpret):
    rng = np.random.default_rng(n + 2)
    mark = rng.random(n) < 0.05
    # hi spans the whole u32 range, >= 2^31 included
    hi = np.where(mark, rng.integers(0, 2 ** 32, n, dtype=np.uint32), 0
                  ).astype(np.uint32)
    lo = np.where(mark, rng.integers(0, 2 ** 32, n, dtype=np.uint32), 0
                  ).astype(np.uint32)
    assert (hi >= 2 ** 31).any()
    wh, wl = (np.asarray(a) for a in
              pk.pair_max_scan(jnp.asarray(hi), jnp.asarray(lo)))
    enc = (jnp.asarray(hi).astype(jnp.uint64) << 32) \
        | jnp.asarray(lo).astype(jnp.uint64)
    u64 = np.asarray(jax.lax.cummax(enc))
    np.testing.assert_array_equal((u64 >> 32).astype(np.uint32), wh)
    np.testing.assert_array_equal((u64 & 0xFFFFFFFF).astype(np.uint32), wl)
    gh, gl = tscan.pair_max_scan(_bits(hi), _bits(lo))
    np.testing.assert_array_equal(gh.numpy().view(np.uint32), wh)
    np.testing.assert_array_equal(gl.numpy().view(np.uint32), wl)


def _scan_cu_constants() -> dict:
    """pair_max_scan's constants as ``csrc/scan.cu`` defines them."""
    src = (Path(tscan.__file__).resolve().parent.parent / "csrc"
           / "scan.cu").read_text()

    def get(pattern):
        return int(re.search(pattern, src).group(1))

    return {"chunks": get(r"kPairChunks = (\d+);"),
            "look_back_warps": get(r"kLookBackWarps = (\d+);"),
            "three_pass_tile": get(r"kThreads = (\d+);")
            * get(r"kItems = (\d+);"),
            "split": get(r"kPairSplit = (\d+)LL << 20;") << 20}


def test_pair_scan_constants_match_scan_cu():
    """The wrapper's tiles and split are scan.cu's (the wrapper checks the
    built library against them on the card)."""
    k = _scan_cu_constants()
    assert tscan.PAIR_TILE == k["three_pass_tile"]
    assert tscan.PAIR_LOOKBACK_TILE == \
        k["look_back_warps"] * 128 * k["chunks"]
    assert tscan.PAIR_SPLIT == k["split"]


class _PairLib:
    """scan.cu's pair-scan sizing, as the wrapper reads it from the
    library."""

    @staticmethod
    def cylon_pair_scan_split():
        return tscan.PAIR_SPLIT

    @staticmethod
    def cylon_pair_scan_tile(n):
        return tscan.PAIR_TILE if n <= tscan.PAIR_SPLIT \
            else tscan.PAIR_LOOKBACK_TILE

    @classmethod
    def cylon_pair_scan_scratch(cls, n):
        t = -(-n // cls.cylon_pair_scan_tile(n))
        return 8 + 12 * (t + (t & 1))


def test_pair_scratch_epochs_unique_across_threads(monkeypatch):
    """Threads that share a stream (ThreadWorld ranks) each take an epoch
    of their own on the kept scratch; a larger call grows it (zeroed,
    epochs from 1), a smaller one keeps it."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(tscan, "_pair_state", {})
    lib, dev = _PairLib(), torch.device("cpu")
    small, big = tscan.PAIR_SPLIT, 32 * tscan.PAIR_SPLIT

    def take(_):
        return tscan._pair_scratch(lib, small, dev, 7)[1]

    with ThreadPoolExecutor(8) as pool:
        epochs = list(pool.map(take, range(800)))
    assert sorted(epochs) == list(range(1, 801))
    first = tscan._pair_scratch(lib, small, dev, 7)[0]
    grown, e = tscan._pair_scratch(lib, big, dev, 7)
    assert e == 1 and grown.numel() * 8 >= lib.cylon_pair_scan_scratch(big)
    assert grown.numel() > first.numel() and not grown.any()
    kept, e = tscan._pair_scratch(lib, small, dev, 7)
    assert kept.data_ptr() == grown.data_ptr() and e == 2
    assert tscan._pair_scratch(lib, small, dev, 8)[1] == 1   # another stream


def test_pair_scan_launches_enqueued_in_turn(monkeypatch):
    """Threads on one stream enqueue a pair scan's passes one call at a
    time: the three passes keep their carries in the shared scratch, so
    two calls interleaved on the stream would read each other's. A fake
    library holds each launch open and records any overlap."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    inside, overlaps, guard = [0], [0], threading.Lock()

    class Lib(_PairLib):
        @staticmethod
        def cylon_pair_max_scan(*args):
            with guard:
                inside[0] += 1
                overlaps[0] += inside[0] > 1
            time.sleep(0.002)   # the GIL is free, as in a ctypes call
            with guard:
                inside[0] -= 1
            return 0

    monkeypatch.setattr(tscan, "_pair_state", {})
    monkeypatch.setattr(tscan, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(tscan.build, "library", Lib)
    monkeypatch.setattr(tscan.build, "stream_of", lambda t: 7)
    monkeypatch.setattr(tscan.pair_max_scan, "launches", 0)
    x = torch.empty(tscan.PAIR_SPLIT - 1, dtype=torch.int32, device="meta")
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda _: tscan.pair_max_scan(x, x), range(40)))
    assert overlaps[0] == 0 and tscan.pair_max_scan.launches == 40


def _ex_max(a: np.ndarray, axis: int) -> np.ndarray:
    """Exclusive running max along ``axis``, identity 0."""
    inc = np.maximum.accumulate(a, axis=axis)
    zero = np.zeros_like(np.take(inc, [0], axis=axis))
    return np.concatenate([zero, np.delete(inc, -1, axis=axis)], axis=axis)


def _look_back(totals: np.ndarray, rng, eager: float,
               window: int = 32) -> np.ndarray:
    """Each tile's exclusive prefix as the look-back finds it, the blocks
    advancing in a random interleaving. Tiles start in order (the atomic
    counter), ``eager`` the chance that the next one starts before a
    running one steps. A tile's first step publishes its max (tile 0 its
    inclusive prefix); each later step waits until the ``window``
    predecessors before its window's end have published, folds their
    values down to the nearest inclusive prefix, and publishes its own in
    the same value slot, or moves the window back."""
    nt = len(totals)
    status = np.zeros(nt, np.int8)   # 0 not yet, 1 its max, 2 its prefix
    value = np.zeros(nt, np.uint64)
    carry = np.zeros(nt, np.uint64)
    end = np.arange(nt) - 1
    acc = np.zeros(nt, np.uint64)
    started, running = 0, []
    while started < nt or running:
        if started < nt and (not running or rng.random() < eager):
            running.append(started)
            started += 1
            continue
        t = running[rng.integers(len(running))]
        if status[t] == 0:
            value[t], status[t] = totals[t], 2 if t == 0 else 1
            if t == 0:
                running.remove(t)
            continue
        idx = end[t] - np.arange(window)
        st = np.where(idx >= 0, status[np.maximum(idx, 0)], 2)
        if not (st > 0).all():
            continue                 # spins: a predecessor has not published
        val = np.where(idx >= 0, value[np.maximum(idx, 0)], np.uint64(0))
        pref = np.flatnonzero(st == 2)
        stop = pref[0] if len(pref) else window - 1
        acc[t] = max(acc[t], val[:stop + 1].max())
        if len(pref):
            carry[t] = acc[t]
            value[t], status[t] = max(acc[t], totals[t]), 2
            running.remove(t)
        else:
            end[t] -= window
    return carry


def _pair_scan_model(hi: np.ndarray, lo: np.ndarray, split: int, rng,
                     eager: float = 0.5):
    """A numpy replay of scan.cu's pair_max_scan with its own constants:
    the dispatch (n <= split: the three passes, each tile's carry the max
    of the totals before it; above: the look-back order of
    :func:`_look_back`), each path's tile split, and the look-back's scan
    of a tile in registers (warp w's span in chunks of 128, lane l's 4
    pairs, the lane scan, the warp scan of the lane totals, the chunk
    carry, the earlier warps' maxima). The three passes' scan inside a
    tile is a sequential one (each thread's 8 pairs, then the threads'
    totals in order), which for a max is the tile's running max."""
    k = _scan_cu_constants()
    n = hi.shape[0]
    three_pass = n <= split
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if three_pass:
        tile = k["three_pass_tile"]
        ntiles = -(-n // tile)
        t = np.zeros(ntiles * tile, np.uint64)
        t[:n] = x
        t = t.reshape(ntiles, tile)
        carry = _ex_max(t.max(axis=1), 0)
        out = np.maximum(carry[:, None],
                         np.maximum.accumulate(t, axis=1)).reshape(-1)[:n]
    else:
        warps, chunks = k["look_back_warps"], k["chunks"]
        tile = warps * chunks * 128
        ntiles = -(-n // tile)
        t = np.zeros(ntiles * tile, np.uint64)
        t[:n] = x
        t = t.reshape(ntiles, warps, chunks, 32, 4)
        inc = np.maximum.accumulate(t, axis=4)               # in each lane
        lane_inc = np.maximum.accumulate(inc[..., 3], axis=3)
        chunk_max = lane_inc[..., 31]                    # [tile, warp, chunk]
        pre = np.maximum(_ex_max(chunk_max, 2)[..., None],
                         _ex_max(lane_inc, 3))           # [t, w, c, lane]
        warp_max = chunk_max.max(axis=2)                 # [tile, warp]
        carry = _look_back(warp_max.max(axis=1), rng, eager)
        front = np.maximum(carry[:, None], _ex_max(warp_max, 1))
        out = np.maximum(np.maximum(front[:, :, None, None], pre)[..., None],
                         inc).reshape(-1)[:n]
    return ((out >> np.uint64(32)).astype(np.uint32),
            (out & np.uint64(0xFFFFFFFF)).astype(np.uint32), three_pass)


def _model_inputs(n: int, seed: int) -> dict:
    """Sparse marks with hi and lo over the whole u32 range, ties on hi
    that lo decides, and no marks at all."""
    rng = np.random.default_rng(seed)
    mark = rng.random(n) < 0.05
    full = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint32)
    return {"sparse": (np.where(mark, full[0], 0).astype(np.uint32),
                       np.where(mark, full[1], 0).astype(np.uint32)),
            "ties": ((np.arange(n) >> 9).astype(np.uint32), full[1]),
            "none": (np.zeros(n, np.uint32), np.zeros(n, np.uint32))}


PAIR_TILE, PAIR_SPLIT = tscan.PAIR_TILE, tscan.PAIR_SPLIT
LB_TILE = tscan.PAIR_LOOKBACK_TILE


@pytest.mark.parametrize("n", [4096, 4097, LB_TILE + 1, 40 * LB_TILE + 5,
                               PAIR_SPLIT - 1, PAIR_SPLIT, PAIR_SPLIT + 1,
                               PAIR_SPLIT + LB_TILE + 1])
def test_pair_scan_model_matches_plain_and_pallas(n, pallas_interpret):
    """The model of both paths, bit for bit against the plain version, the
    u64 lax.cummax, and below 8192 pairs the Pallas kernel in interpret
    mode: two three-pass tiles and one pair more, one look-back tile and
    one pair more, many tiles, the split and one pair on each side of it,
    and a look-back tile past it. Below the
    split both paths run (the look-back forced, its tiling at a size the
    kernel gives the three passes), the look-back in three interleavings,
    the last starting every tile before any looks back (so that windows
    step back past 32 tiles); from the split up, the path the kernel's
    dispatch picks."""
    rng = np.random.default_rng(n)
    inputs = _model_inputs(n, n + 7)
    if n >= PAIR_SPLIT - 1:   # the largest sizes: one input each
        inputs = {"sparse": inputs["sparse"]}
    for case, (hi, lo) in inputs.items():
        ph, pl = tscan.pair_max_scan_plain(_bits(hi), _bits(lo))
        want = (ph.numpy().view(np.uint32), pl.numpy().view(np.uint32))
        enc = (jnp.asarray(hi).astype(jnp.uint64) << 32) \
            | jnp.asarray(lo).astype(jnp.uint64)
        u64 = np.asarray(jax.lax.cummax(enc))
        np.testing.assert_array_equal((u64 >> 32).astype(np.uint32), want[0])
        np.testing.assert_array_equal((u64 & 0xFFFFFFFF).astype(np.uint32),
                                      want[1])
        if n < 8192 and case == "sparse":
            kh, kl = pk.pair_max_scan(jnp.asarray(hi), jnp.asarray(lo))
            np.testing.assert_array_equal(np.asarray(kh), want[0])
            np.testing.assert_array_equal(np.asarray(kl), want[1])
        runs = [(PAIR_SPLIT, 0.5)]
        if n < PAIR_SPLIT - 1:
            runs = [(PAIR_SPLIT, 0.5), (0, 0.2), (0, 0.7), (0, 1.0)]
        for split, eager in runs:
            gh, gl, three_pass = _pair_scan_model(hi, lo, split, rng, eager)
            assert three_pass == (n <= split), case
            np.testing.assert_array_equal(gh, want[0], err_msg=case)
            np.testing.assert_array_equal(gl, want[1], err_msg=case)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("n", [100, 4097])
def test_fills_match_jax(n, interpret, monkeypatch):
    """forward_fill / reverse_fill: the pair_max_scan route above the
    gate, the int64 cummax below it, against both JAX routes."""
    monkeypatch.setenv("CYLON_PALLAS", "interpret" if interpret else "0")
    rng = np.random.default_rng(n)
    mark = rng.random(n) < 0.1
    val = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32)
    for jfn, tfn in ((jkernels.forward_fill, tops.forward_fill),
                     (jkernels.reverse_fill, tops.reverse_fill)):
        want = np.asarray(jfn(jnp.asarray(mark), jnp.asarray(val)))
        got = tfn(torch.from_numpy(mark), torch.from_numpy(val))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_scan_gate_keeps_torch_below_min_size(monkeypatch):
    calls = []
    real = tscan.scan32

    def counting(x, kind):
        calls.append(x.shape[0])
        return real(x, kind)

    monkeypatch.setattr(tscan, "scan32", counting)
    before = tk.launch_counts()
    small = torch.ones(tscan.SCAN_MIN_SIZE - 1, dtype=torch.int32)
    big = torch.ones(tscan.SCAN_MIN_SIZE, dtype=torch.int32)
    assert tops.fast_cumsum(small)[-1] == small.shape[0]
    assert tops.fast_cummax(small)[-1] == 1
    assert calls == []
    assert tops.fast_cumsum(big)[-1] == big.shape[0]
    assert calls == [big.shape[0]]
    # the plain version ran: no kernel was launched
    assert tk.launch_counts() == before
    assert not tscan.scan32_ok(torch.ones(5000, dtype=torch.int64))
    assert not tscan.scan32_ok(torch.ones(5000, dtype=torch.bool))
    assert not tscan.scan32_ok(torch.ones((64, 64), dtype=torch.int32))
    assert pk.SCAN_MIN_SIZE == tscan.SCAN_MIN_SIZE


def _int64_halves(t: torch.Tensor):
    pair = t.view(torch.int32).view(-1, 2)
    return [pair[:, 0], pair[:, 1]]


def _layout(name: str):
    """(probe words, build words) of one key layout, 64 rows a side."""
    keys = torch.arange(64, dtype=torch.int64) * 0x100000001
    other = keys.flip(0).clone()
    if name == "int64":
        return _int64_halves(keys), _int64_halves(other)
    if name == "int64_row_slice":   # rows 1.., still 8-byte aligned
        return _int64_halves(keys[1:]), _int64_halves(other[1:])
    if name == "row_words_int64":   # what the hash join hands the probe
        return (thash._row_words([keys], None),
                thash._row_words([other], None))
    if name == "swapped":
        return _int64_halves(keys)[::-1], _int64_halves(other)[::-1]
    if name == "offset":   # hi of one row and lo of the next: 4-byte aligned
        flat = torch.cat([keys, keys[:1]]).view(torch.int32)[1:-1]
        pair = flat.view(-1, 2)
        return [pair[:, 0], pair[:, 1]], _int64_halves(other)
    if name == "every_other_row":   # stride 4
        quad = keys.view(torch.int32).view(-1, 4)
        return [quad[:, 0], quad[:, 1]], _int64_halves(other[:32])
    if name == "validity_word":
        valid = torch.arange(64) % 7 != 0
        return (thash._row_words([keys], [valid]),
                thash._row_words([other], [valid]))
    if name == "two_int32":
        a = torch.arange(64, dtype=torch.int32)
        return [a, a + 1], [a + 2, a + 3]
    if name == "one_side_only":
        a = torch.arange(64, dtype=torch.int32)
        return _int64_halves(keys), [a, a + 1]
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("int64", True), ("int64_row_slice", True), ("row_words_int64", True),
    ("swapped", False), ("offset", False), ("every_other_row", False),
    ("validity_word", False), ("two_int32", False), ("one_side_only", False)])
def test_one_int64_key_detector(name, want):
    """bucket_probe compares with one 8-byte load a side only where both
    sides' words are the (lo, hi) halves of one 8-byte-aligned int64
    column read in place; every other layout compares word by word."""
    pw, bw = _layout(name)
    assert tbucket.one_int64_key(pw, bw) is want


# (cap, nb, width, bucket id range, overflows): clean builds within and
# past one 8 x 128 Pallas tile, and an overflowing one (few buckets); one
# entry a bucket, thirty, and nb below the tile the width allows (16
# buckets at width 16, where 64 KB hold 1024)
BUILD_CASES = [(700, 1024, 8, 1024, False), (1500, 2048, 16, 2048, False),
               (900, 64, 3, 8, True), (800, 512, 1, 512, True),
               (1200, 256, 30, 256, False), (300, 16, 16, 16, True)]


@pytest.mark.parametrize("cap,nb,width,hi,overflows", BUILD_CASES)
def test_bucket_build_plain_matches_pallas(cap, nb, width, hi, overflows,
                                           pallas_interpret):
    rng = np.random.default_rng(cap + width)
    bids = rng.integers(-1, hi, cap).astype(np.int32)   # -1: skipped rows
    want_t, want_o = pk.bucket_build(jnp.asarray(bids), nb, width)
    twin_t, twin_o = jhj._build_jnp(jnp.asarray(bids), nb, width)
    np.testing.assert_array_equal(np.asarray(twin_t), np.asarray(want_t))
    assert int(twin_o) == int(want_o)
    got_t, got_o = tk.bucket_build(torch.from_numpy(bids), nb, width)
    assert got_t.dtype == torch.int32 and got_o.dtype == torch.int32
    assert tuple(got_t.shape) == (width, nb) and got_o.dim() == 0
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert int(got_o) == int(want_o)
    assert (int(got_o) > 0) == overflows


@pytest.mark.parametrize("width", [1, 16, 30])
@pytest.mark.parametrize("nb", [16, 17, 1024, 3 << 20, 64 << 20, 1 << 30])
def test_build_plan_tiles_fit_shared_memory(nb, width):
    """T is a power of two, at most nb, and a tile's table fits its
    shared-memory budget; the chunks cover the rows; a shared histogram
    only where its counters fit; scratch sized for every row."""
    for cap in (0, 1, 4097, 16 << 20):
        plan = tbucket.build_plan(cap, nb, width)
        t = plan.tile
        assert t & (t - 1) == 0 and 1 <= t <= nb
        assert plan.tile_bytes == 4 * width * t <= tbucket.TILE_BYTES
        # the largest such power of two
        assert 2 * t > nb or 8 * width * t > tbucket.TILE_BYTES
        assert plan.tiles == -(-nb // t) and (plan.tiles - 1) * t < nb
        assert plan.chunk % tbucket.CHUNK_ALIGN == 0
        assert plan.chunk >= tbucket.MIN_CHUNK
        assert plan.chunks * plan.chunk >= cap > (plan.chunks - 1) * plan.chunk \
            or cap == 0 and plan.chunks == 1
        assert plan.chunks <= tbucket.TARGET_CHUNKS
        assert plan.shared_hist == (plan.tiles <= tbucket.HIST_TILES)
        if plan.shared_hist:
            # two scatter levels of at most 128 digits each
            fan = 1 << plan.fine_bits
            assert plan.hist_bytes == 4 * plan.tiles <= 64 * 1024
            assert fan <= 128 and plan.coarse <= 128
            assert plan.coarse == -(-plan.tiles // fan)
            assert plan.groups <= tbucket.GROUPS
            assert (plan.groups - 1) * plan.group_chunks < plan.chunks \
                <= plan.groups * plan.group_chunks
            cmat, fmat = plan.coarse * plan.chunks, plan.tiles * plan.groups
            assert plan.count_words == cmat + 2 * fmat
            assert plan.scan_len == max(cmat, fmat)
        else:
            assert plan.hist_bytes == 0 and plan.scan_len == plan.tiles
            assert plan.count_words == 2 * plan.tiles
        assert plan.staging % 2 == 0 and plan.staging >= max(cap, 2)


def test_build_plan_main_shape():
    """The hash join's 16M build: 1024-bucket tiles of 64 KB, 16384
    tiles counted in shared memory over 261 chunks."""
    plan = tbucket.build_plan(16 << 20, 16 << 20, 16)
    assert (plan.tile, plan.tiles, plan.chunks) == (1024, 16384, 261)
    assert plan.shared_hist and plan.tile_bytes == 64 * 1024
    # nb = 64M at width 16: too many tiles for shared counters
    assert not tbucket.build_plan(1 << 20, 64 << 20, 16).shared_hist
    with pytest.raises(ValueError):
        tbucket.build_plan(10, 0, 4)


_EMPTY = 0xFFFFFFFF


def _partitioned_build(bids: np.ndarray, nb: int, width: int, seed: int):
    """A numpy model of the CUDA build's passes, with the orders the card
    leaves open drawn at random: the order rows take their slots in a
    run of the staging buffers, and the order a tile's rows are carried
    in."""
    cap = bids.shape[0]
    plan = tbucket.build_plan(cap, nb, width)
    t_sz = plan.tile
    rng = np.random.default_rng(seed)
    over = int((bids >= nb).sum())                 # count: ids >= nb
    rows = np.flatnonzero((bids >= 0) & (bids < nb))
    tile_of = bids[rows] // t_sz
    chunk_of = rows // plan.chunk

    def scatter(entries, runs, starts, size):
        """Each entry to the next free slot of its run, in any order."""
        out = np.zeros((max(size, 1), 2), np.int64)
        cursor = starts.copy()
        for k in rng.permutation(len(runs)):
            out[cursor[runs[k]]] = entries[k]
            cursor[runs[k]] += 1
        return out

    if plan.shared_hist:
        # count: [coarse digit, chunk] and [tile, group] counts, scanned
        digit_of = tile_of >> plan.fine_bits
        group_of = chunk_of // plan.group_chunks
        coarse = np.zeros((plan.coarse, plan.chunks), np.int64)
        np.add.at(coarse, (digit_of, chunk_of), 1)
        fine = np.zeros((plan.tiles, plan.groups), np.int64)
        np.add.at(fine, (tile_of, group_of), 1)
        cends = np.cumsum(coarse.ravel())
        ends = np.cumsum(fine.ravel())
        # coarse scatter: (row, bucket id) into [digit, chunk] runs
        a = scatter(np.stack([rows, bids[rows]], 1),
                    digit_of * plan.chunks + chunk_of,
                    cends - coarse.ravel(), rows.shape[0])
        # fine scatter: block (digit, group) reads its runs of a
        b_rows, b_runs = [], []
        for d in range(plan.coarse):
            for g in range(plan.groups):
                j0 = g * plan.group_chunks
                j1 = min(j0 + plan.group_chunks, plan.chunks)
                lo = 0 if d * plan.chunks + j0 == 0 \
                    else cends[d * plan.chunks + j0 - 1]
                hi = cends[d * plan.chunks + j1 - 1]
                for row, bid in a[lo:hi]:
                    b_rows.append((row, bid % t_sz))
                    b_runs.append((bid // t_sz) * plan.groups + g)
        staging = scatter(np.array(b_rows).reshape(-1, 2), np.array(b_runs),
                          ends - fine.ravel(), rows.shape[0])
        stride = plan.groups
    else:                                          # global tile counters
        counts = np.bincount(tile_of, minlength=plan.tiles)
        ends = np.cumsum(counts)
        staging = scatter(np.stack([rows, bids[rows] % t_sz], 1), tile_of,
                          ends - counts, rows.shape[0])
        stride = 1
    table = np.full((width, nb), -1, np.int64)
    for t in range(plan.tiles):                    # tile build
        lo = 0 if t == 0 else int(ends[t * stride - 1])
        hi = int(ends[(t + 1) * stride - 1])
        tile = np.full((width, t_sz), _EMPTY, np.int64)
        for k in lo + rng.permutation(hi - lo):
            v, lb = staging[k]
            placed = False
            for e in range(width):
                if v > tile[width - 1, lb]:        # never placed: stop
                    break
                old = tile[e, lb]
                tile[e, lb] = min(old, v)
                v = max(old, v)
                if v == _EMPTY:
                    placed = True
                    break
            over += not placed
        n = min(t_sz, nb - t * t_sz)
        part = tile[:, :n]
        table[:, t * t_sz:t * t_sz + n] = np.where(part == _EMPTY, -1, part)
    return table.astype(np.int32), over


# (cap, nb, width, bucket id range, TILE_BYTES, HIST_TILES): every case
# has a hot bucket that overflows; ids >= nb mixed with -1 rows where the
# range passes nb; widths 1, 16 and 30; small tile budgets, so that a
# small build spans many tiles; nb not a power of two (a partial last
# tile); several chunks, and chunk groups of two; the global-counter
# path (few HIST_TILES)
MODEL_CASES = [(1500, 2048, 16, 2048, 64 << 10, 16 << 10),
               (1200, 64, 16, 8, 64 << 10, 16 << 10),
               (800, 512, 1, 512, 256, 16 << 10),
               (900, 512, 1, 600, 256, 16 << 10),
               (1000, 128, 30, 128, 1024, 16 << 10),
               (1000, 128, 30, 160, 1024, 16 << 10),
               (700, 42, 30, 46, 1024, 16 << 10),
               (9000, 1024, 16, 1100, 4096, 16 << 10),
               (40000, 4096, 16, 4200, 4096, 16 << 10),
               (1300, 2048, 1, 2048, 1024, 4),
               (1100, 256, 16, 300, 1024, 4)]


@pytest.mark.parametrize("cap,nb,width,hi,tile_bytes,hist_tiles",
                         MODEL_CASES)
def test_partitioned_build_model_matches_pallas(cap, nb, width, hi,
                                                tile_bytes, hist_tiles,
                                                monkeypatch,
                                                pallas_interpret):
    """The four passes give the reference's table and overflow count bit
    for bit whatever order the rows arrive in: the carry's
    order-independence, on the CPU. The reference is the Pallas kernel
    in interpret mode where every id is below nb (past nb its table
    writes are out of bounds), and its jnp twin and the plain version
    always."""
    monkeypatch.setattr(tbucket, "TILE_BYTES", tile_bytes)
    monkeypatch.setattr(tbucket, "HIST_TILES", hist_tiles)
    plan = tbucket.build_plan(cap, nb, width)
    assert plan.tiles > 1 or nb <= 64
    assert plan.shared_hist == (hist_tiles > 4)
    rng = np.random.default_rng(cap * 31 + width)
    bids = rng.integers(-1, hi, cap).astype(np.int32)
    bids[rng.random(cap) < 0.1] = 3    # a hot bucket
    want_t, want_o = jhj._build_jnp(jnp.asarray(bids), nb, width)
    want_t, want_o = np.asarray(want_t), int(want_o)
    if hi <= nb:
        kern_t, kern_o = pk.bucket_build(jnp.asarray(bids), nb, width)
        np.testing.assert_array_equal(np.asarray(kern_t), want_t)
        assert int(kern_o) == want_o
    plain_t, plain_o = tbucket.bucket_build_plain(torch.from_numpy(bids), nb,
                                                  width)
    np.testing.assert_array_equal(plain_t.numpy(), want_t)
    assert int(plain_o) == want_o
    for seed in range(2):
        got_t, got_o = _partitioned_build(bids, nb, width, seed)
        np.testing.assert_array_equal(got_t, want_t)
        assert got_o == want_o
    assert want_o > 0


@pytest.mark.parametrize("nwords", [1, 2, 3])
def test_bucket_probe_plain_matches_pallas(nwords, pallas_interpret):
    """Probe rows past the valid prefix carry -1; the words of a 64-bit
    key are strided views, as ``_row_words`` gives them."""
    rng = np.random.default_rng(nwords)
    nb, width, bcap, pcap = 64, 16, 150, 1100
    bkeys = rng.integers(0, 40, (bcap, nwords)).astype(np.uint32)
    pkeys = rng.integers(0, 40, (pcap, nwords)).astype(np.uint32)
    bbids = (bkeys.sum(1) % nb).astype(np.int32)
    pbids = (pkeys.sum(1) % nb).astype(np.int32)
    pbids[1000:] = -1
    table, ovf = pk.bucket_build(jnp.asarray(bbids), nb, width)
    assert int(ovf) == 0
    jb = [jnp.asarray(bkeys[:, j]) for j in range(nwords)]
    jp = [jnp.asarray(pkeys[:, j]) for j in range(nwords)]
    want = np.asarray(pk.bucket_probe(jnp.asarray(pbids), jp, table, jb))
    np.testing.assert_array_equal(
        np.asarray(jhj._probe_jnp(jnp.asarray(pbids), jp, table, jb)), want)
    assert want.max() > 0 and (want[1000:] == 0).all()

    tb = _bits(bkeys)   # [rows, nwords]: column j is a strided view
    tp = _bits(pkeys)
    got = tk.bucket_probe(torch.from_numpy(pbids),
                          [tp[:, j] for j in range(nwords)],
                          torch.from_numpy(np.array(table)),
                          [tb[:, j] for j in range(nwords)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_kernels_reject_bad_operands():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.bucket_build(ids, 16, 31)   # mask bits must fit an int32
    with pytest.raises(ValueError):
        tk.bucket_build(ids.to(torch.int64), 16, 4)
    table, _ = tk.bucket_build(ids, 16, 4)
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.bucket_probe(ids, [w, w], table, [w])
    with pytest.raises(ValueError):
        tk.bucket_probe(ids, [w[:5]], table, [w])


#: gather_rows' widths: one word to past one 16-byte piece, odd and even
GATHER_WIDTHS = (1, 2, 3, 4, 5, 8, 17)


def _gather_index(kind: str, cap: int, rng) -> np.ndarray:
    n = {"empty": 0, "one": 1}.get(kind, 4097)
    if kind == "monotone":
        return np.sort(rng.integers(0, cap, n))
    if kind in ("out_of_range", "cap1"):
        return rng.integers(-cap, 2 * cap, n)
    return rng.integers(0, cap, n)


@pytest.mark.parametrize("kind", ["monotone", "random", "out_of_range",
                                  "empty", "one", "cap1"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("w", GATHER_WIDTHS)
def test_gather_rows_plain_matches_clamped_take(w, dtype, kind):
    """The plain version is ``index_select`` of the clamped index: equal
    to numpy's take of the clipped index and to the JAX package's
    ``jnp.take(mode="clip")``, at every width and index kind, on no rows
    and from a one-row source. A CPU tensor takes it, counts its rows in
    ``gather.rows{route=plain}`` and launches nothing."""
    rng = np.random.default_rng(w * 7 + len(kind))
    cap = 1 if kind == "cap1" else 300
    words = rng.integers(-2 ** 31, 2 ** 31, (cap, w)).astype(np.int32)
    idx = _gather_index(kind, cap, rng)
    want = np.take(words, np.clip(idx, 0, cap - 1), axis=0)
    np.testing.assert_array_equal(
        np.asarray(jnp.take(jnp.asarray(words), jnp.asarray(idx), axis=0,
                            mode="clip")), want)
    t_words = torch.from_numpy(words)
    t_idx = torch.from_numpy(idx).to(dtype)
    launches = tk.gather_rows.launches
    before = tel.snapshot()
    got = tk.gather_rows(t_words, t_idx)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(idx), w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tk.gather_rows.plain(t_words, t_idx).numpy(), want)
    assert tk.gather_rows.launches == launches
    rows = {d["labels"]["route"]: d["value"]
            for d in tel.delta(before).values() if d["name"] == "gather.rows"}
    assert rows.get("plain", 0) == len(idx) and not rows.get("kernel")


@pytest.mark.parametrize("words, idx, error", [
    (torch.zeros((8, 6), dtype=torch.int32)[:, ::2], torch.arange(3),
     ValueError),                                    # not contiguous
    (torch.zeros((8, 3), dtype=torch.int32).t(), torch.arange(3),
     ValueError),                                    # transposed
    (torch.zeros((8, 3), dtype=torch.int64), torch.arange(3), TypeError),
    (torch.zeros((8, 3), dtype=torch.float32), torch.arange(3), TypeError),
    (torch.zeros(8, dtype=torch.int32), torch.arange(3), TypeError),
    (torch.zeros((8, 3), dtype=torch.int32), torch.zeros((3, 1),
                                                         dtype=torch.int64),
     TypeError),                                     # a 2-D index
    (torch.zeros((8, 3), dtype=torch.int32), torch.zeros(3), TypeError),
    (torch.zeros((0, 3), dtype=torch.int32), torch.arange(3), ValueError),
])
def test_gather_rows_rejects_bad_operands(words, idx, error):
    """The word matrix must be a contiguous [cap, w] int32 matrix, the
    index 1-D int32 or int64, and a gather of rows needs a row to read."""
    with pytest.raises(error):
        tk.gather_rows(words, idx)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it (``meta`` stands in for a device
    with no kernel)."""
    x = torch.empty(5000, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.row_hash([x])
    with pytest.raises(ValueError):
        tk.scan32(x, "add")
    with pytest.raises(ValueError):
        tk.pair_max_scan(x, x)
    with pytest.raises(ValueError):
        tk.bucket_build(x, 16, 4)
    with pytest.raises(ValueError):
        tk.bucket_probe(x, [x], torch.full((4, 16), -1, dtype=torch.int32,
                                           device="meta"), [x])
    with pytest.raises(ValueError):
        tk.gather_rows(x.view(1000, 5), x)
