"""The port's row hashing against ``cylon_tpu.ops.hash``, bit for bit.

Both JAX routes are references: the jnp chain (``CYLON_PALLAS=0``) and
the Pallas ``row_hash`` kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import hash as jhash
from cylon_tpu_torch.ops import hash as thash

N = 1000   # not a multiple of the 8 x 1024 hash tile


def _columns(rng, n):
    """(name, numpy data, validity or None) of every dtype the path
    hashes, floats with their awkward values."""
    f64 = rng.normal(size=n)
    f64[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    f32 = rng.normal(size=n).astype(np.float32)
    f32[:3] = [-0.0, np.nan, np.inf]
    valid = rng.random(n) < 0.8
    return [
        ("int64", rng.integers(-2 ** 62, 2 ** 62, n), None),
        ("int32", rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32), None),
        ("float64", f64, None),
        ("float32", f32, None),
        ("bool", rng.random(n) < 0.5, None),
        ("int8", rng.integers(-128, 128, n, dtype=np.int8), None),
        ("int64_nullable", rng.integers(0, 50, n), valid),
        ("float64_nullable", f64.copy(), ~valid),
    ]


def _both(arrays, validities):
    jarr = [jnp.asarray(a) for a in arrays]
    jval = [None if v is None else jnp.asarray(v) for v in validities]
    tarr = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    tval = [None if v is None else torch.from_numpy(v) for v in validities]
    return jarr, jval, tarr, tval


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("col", range(8))
def test_hash_columns_matches_jax(col, mode, monkeypatch):
    monkeypatch.setenv("CYLON_PALLAS", mode)
    rng = np.random.default_rng(col)
    name, data, validity = _columns(rng, N)[col]
    jarr, jval, tarr, tval = _both([data], [validity])
    want = np.asarray(jhash.hash_columns(jarr, jval))
    got = thash.hash_columns(tarr, tval)
    assert got.dtype == torch.int32, name
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("nparts", [1, 4, 7])
def test_partition_ids_multi_column_matches_jax(nparts, mode, monkeypatch):
    monkeypatch.setenv("CYLON_PALLAS", mode)
    rng = np.random.default_rng(nparts)
    cols = _columns(rng, N)
    arrays = [c[1] for c in cols]
    validities = [c[2] for c in cols]
    jarr, jval, tarr, tval = _both(arrays, validities)
    want = np.asarray(jhash.partition_ids(jarr, nparts, jval))
    got = thash.partition_ids(tarr, nparts, tval)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= got.min() and got.max() < nparts


def test_equal_values_hash_equally():
    """Canonicalisation: -0.0 hashes as 0.0, every NaN payload as the
    canonical NaN, and a null's payload is ignored."""
    nan2 = np.array([0x7FF8000000000001], np.uint64).view(np.float64)[0]
    a = torch.tensor([0.0, np.nan, 1.5, 7.0], dtype=torch.float64)
    b = torch.tensor([-0.0, nan2, 1.5, -3.0], dtype=torch.float64)
    v = torch.tensor([True, True, True, False])
    ha = thash.hash_columns([a], [v])
    hb = thash.hash_columns([b], [v])
    assert torch.equal(ha, hb)


@pytest.mark.parametrize("mode", ["0", "interpret"])
@pytest.mark.parametrize("ncols,nullable,nwords", [(9, False, 18),
                                                   (11, True, 33)])
def test_wide_keys_hash_like_jax(ncols, nullable, nwords, mode,
                                 monkeypatch):
    """Keys of more than 16 u32 words (nine int64 columns are 18 words,
    eleven nullable ones 33; the CUDA kernel takes them in chunks of 16)
    hash as the JAX package hashes them."""
    monkeypatch.setenv("CYLON_PALLAS", mode)
    rng = np.random.default_rng(nwords)
    arrays = [rng.integers(-2 ** 62, 2 ** 62, N) for _ in range(ncols)]
    validities = [rng.random(N) < 0.9 if nullable else None
                  for _ in range(ncols)]
    jarr, jval, tarr, tval = _both(arrays, validities)
    assert len(thash._row_words(tarr, tval)) == nwords
    want = np.asarray(jhash.hash_columns(jarr, jval))
    got = thash.hash_columns(tarr, tval)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want = np.asarray(jhash.partition_ids(jarr, 7, jval))
    np.testing.assert_array_equal(thash.partition_ids(tarr, 7, tval).numpy(),
                                  want)
