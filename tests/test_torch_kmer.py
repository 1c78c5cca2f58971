"""The port's k-mer seed tables (bowtie2_server_tpu_torch/index/kmer.py)
against the JAX package's: equal host tables, equal (start, cnt) from both
device lookups, and the three cache faults fixed in the port."""
import gc
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bowtie2_server_tpu.index import kmer as jk  # noqa: E402
from bowtie2_server_tpu_torch.index import kmer as tk  # noqa: E402

SEED_LEN = 22


@pytest.fixture(scope="module")
def genome():
    """30 kbp with repeats, so some keys occur many times."""
    rng = np.random.default_rng(2024)
    g = rng.integers(0, 4, 30_000).astype(np.uint8)
    g[10_000:10_400] = g[2_000:2_400]
    for k in range(8):
        g[20_000 + 50 * k : 20_000 + 50 * k + 40] = g[500:540]
    return g


@pytest.fixture(scope="module")
def tables(genome):
    return (jk.build_cuckoo_table(genome, SEED_LEN),
            tk.build_cuckoo_table(genome, SEED_LEN),
            jk.build_kmer_table(genome, SEED_LEN),
            tk.build_kmer_table(genome, SEED_LEN))


def _queries(genome):
    """Every window of the genome plus random (mostly absent) keys."""
    hi, lo, _, _ = jk.pack_keys(genome, SEED_LEN)
    n_k = len(genome) - SEED_LEN + 1
    rng = np.random.default_rng(7)
    r_hi = rng.integers(0, 1 << 32, 2000, dtype=np.uint64).astype(np.uint32)
    r_lo = rng.integers(0, 1 << 12, 2000, dtype=np.uint64).astype(np.uint32)
    return (np.concatenate([hi[:n_k], r_hi, [0xFFFFFFFF]]).astype(np.uint32),
            np.concatenate([lo[:n_k], r_lo, [0xFFF]]).astype(np.uint32))


def test_tables_equal(tables):
    jc, tc, js, ts = tables
    assert jc is not None and tc is not None
    np.testing.assert_array_equal(tc.table, jc.table)
    np.testing.assert_array_equal(tc.pos, jc.pos)
    assert (tc.tbits, tc.salt, tc.n_hi, tc.n_lo) == \
        (jc.tbits, jc.salt, jc.n_hi, jc.n_lo)
    np.testing.assert_array_equal(ts.bucket_start, js.bucket_start)
    np.testing.assert_array_equal(ts.keys, js.keys)
    np.testing.assert_array_equal(ts.pos, js.pos)
    assert (ts.bbits, ts.search_steps) == (js.bbits, js.search_steps)


def test_buckets_equal_numpy(tables):
    jc = tables[0]
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    hi[:3] = 0xFFFFFFFF
    want = jk._buckets(hi, lo, jc.salt, jc.tbits, np)
    got = tk._buckets_torch(torch.from_numpy(hi.astype(np.int64)),
                            torch.from_numpy(lo.astype(np.int64)),
                            jc.salt, jc.tbits)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cuckoo_lookup_equal(genome, tables):
    jc, tc = tables[0], tables[1]
    q_hi, q_lo = _queries(genome)
    want = jk.cuckoo_lookup(jk.cuckoo_to_device(jc), jnp.asarray(q_hi),
                            jnp.asarray(q_lo), jc.tbits, jc.salt)
    got = tk.cuckoo_lookup(tk.cuckoo_to_device(tc, "cpu"),
                           torch.from_numpy(q_hi.astype(np.int64)),
                           torch.from_numpy(q_lo.astype(np.int64)),
                           tc.tbits, tc.salt)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] > 1).sum()) > 100      # the repeats were found


def test_sorted_lookup_equal(genome, tables):
    js, ts = tables[2], tables[3]
    q_hi, q_lo = _queries(genome)
    want = jk.lookup_body(jk.to_device(js), jnp.asarray(q_hi),
                          jnp.asarray(q_lo), js.n_hi, js.bbits,
                          js.search_steps)
    got = tk.lookup_body(tk.to_device(ts, "cpu"),
                         torch.from_numpy(q_hi.astype(np.int64)),
                         torch.from_numpy(q_lo.astype(np.int64)),
                         ts.n_hi, ts.bbits, ts.search_steps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cache_roundtrip(tmp_path, genome, tables):
    tc = tables[1]
    base = str(tmp_path / "idx")
    tk.save_cuckoo_table(tc, base, joined=genome)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        back = tk.load_cuckoo_table(base, SEED_LEN, joined=genome)
    np.testing.assert_array_equal(back.table, tc.table)
    np.testing.assert_array_equal(back.pos, tc.pos)
    assert (back.tbits, back.salt) == (tc.tbits, tc.salt)


def test_cache_save_unwritable_dir_is_not_an_error(tmp_path, tables):
    """Fault 1: mkstemp sat outside the try, so a cache directory that
    cannot be written raised out of save."""
    base = str(tmp_path / "missing" / "idx")
    with pytest.raises(OSError):
        jk.save_cuckoo_table(tables[0], base)
    tk.save_cuckoo_table(tables[1], base)      # no exception, no file
    assert not (tmp_path / "missing").exists()


def test_cache_staleness_covers_whole_genome(tmp_path, tables):
    """Fault 2: the staleness checksum sampled a stride of the genome, so
    an edit between samples left a stale table looking valid."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 200_000).astype(np.uint8)
    b = a.copy()
    b[1] = (b[1] + 1) % 4          # off the reference's sampling stride
    assert jk._joined_sig(a) == jk._joined_sig(b)
    assert tk._joined_sig(a) != tk._joined_sig(b)
    base = str(tmp_path / "idx")
    tk.save_cuckoo_table(tables[1], base, joined=a)
    assert tk.load_cuckoo_table(base, SEED_LEN, joined=a) is not None
    assert tk.load_cuckoo_table(base, SEED_LEN, joined=b) is None


def test_cache_corrupt_file_returns_none(tmp_path):
    """Fault 3: a damaged zip raised BadZipFile, and the file handle was
    never closed."""
    base = str(tmp_path / "idx")
    path = tk.cuckoo_cache_path(base, SEED_LEN)
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04" + b"\x00" * 64)
    leaks = []
    hook = sys.unraisablehook
    sys.unraisablehook = leaks.append     # unclosed-file warnings land here
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always", ResourceWarning)
            assert tk.load_cuckoo_table(base, SEED_LEN) is None
            gc.collect()
    finally:
        sys.unraisablehook = hook
    assert not leaks
    jpath = jk.cuckoo_cache_path(base, SEED_LEN)
    with open(jpath, "wb") as f:
        f.write(b"PK\x03\x04" + b"\x00" * 64)
    import zipfile
    with pytest.raises(zipfile.BadZipFile):
        jk.load_cuckoo_table(base, SEED_LEN)
