"""The port's pure-Python LMDB backend (``iisan_tpu_torch/data/lmdbfile.py``)
against the JAX package's (``iisan_tpu/data/lmdbfile.py``).

For each structural case of ``tests/test_lmdbfile.py`` (a multilevel tree,
overflow values and the inline / overflow boundary, an empty DB, a
non-default page size, the directory form, meta-txnid election after a
second commit) both packages write the same key-value set: the files must
be byte-identical, and each package must read the other's file back to
the same key-value set, in key order, with the same ``stat``.  A
truncated overflow chain must raise in both readers.
"""

import os
import random
import struct

import pytest

from iisan_tpu.data import lmdbfile as jlmdb
from iisan_tpu_torch.data import lmdbfile as tlmdb


def _items(case):
    rng = random.Random(7)
    if case == "multilevel":
        return {f"key{i:05d}".encode(): f"val{i}".encode() for i in range(600)}
    if case == "overflow":
        return {b"big": rng.randbytes(150_000), b"exact": b"x" * (4096 - 16),
                b"small": b"s", b"edge": b"y" * 2032}
    if case == "boundary":
        return {b"keyA": b"a" * 2028, b"keyB": b"b" * 2029}
    if case == "empty":
        return {}
    if case == "fuzz":
        out = {}
        for _ in range(200):
            k = rng.randbytes(rng.randint(1, 40))
            out[k] = rng.randbytes(rng.choice([0, 1, 7, 2039, 2040, 2041, 60_000]))
        return out
    return {f"k{i:03d}".encode(): rng.randbytes(i * 37 % 5000)
            for i in range(1, 120)}


def _write(module, path, items, *, subdir=False, commits=1):
    """Write ``items`` through ``module``'s lmdb API in ``commits`` write
    transactions (keys split in order)."""
    env = module.open(path, subdir=subdir)
    keys = sorted(items)
    step = max(1, -(-len(keys) // commits))
    for c in range(commits):
        with env.begin(write=True) as txn:
            for k in keys[c * step:(c + 1) * step]:
                txn.put(k, items[k])
    env.close()


def _read(module, path, subdir=False):
    env = module.open(path, subdir=subdir, readonly=True)
    try:
        txn = env.begin()
        rows = list(txn.cursor().iternext())
        got = {k: txn.get(k) for k, _ in rows}
        return rows, got, env.stat()
    finally:
        env.close()


def _data_file(path, subdir):
    return os.path.join(path, "data.mdb") if subdir else path


CASES = [  # (case, subdir, commits, page size for write_db or None)
    ("multilevel", False, 1, None),
    ("overflow", False, 1, None),
    ("boundary", False, 1, None),
    ("empty", False, 1, None),
    ("fuzz", False, 1, None),
    ("page_size", False, 1, 16384),
    ("directory_form", True, 1, None),
    ("txnid_election", False, 2, None),
]


@pytest.mark.parametrize("case,subdir,commits,psize", CASES,
                         ids=[c[0] for c in CASES])
def test_files_byte_identical_and_read_both_ways(tmp_path, case, subdir,
                                                commits, psize):
    items = _items(case)
    paths = {}
    for name, module in (("jax", jlmdb), ("port", tlmdb)):
        path = str(tmp_path / f"{name}.mdb")
        if psize:
            module.write_db(path, items, psize=psize)
        else:
            _write(module, path, items, subdir=subdir, commits=commits)
        paths[name] = path
    raw = {n: open(_data_file(p, subdir), "rb").read() for n, p in paths.items()}
    assert raw["jax"] == raw["port"]
    for reader in (jlmdb, tlmdb):
        for path in paths.values():
            rows, got, stat = _read(reader, path, subdir)
            assert [k for k, _ in rows] == sorted(items)
            assert got == items and dict(rows) == items
            assert stat["entries"] == len(items)
            if psize:
                assert stat["psize"] == psize
    if case == "multilevel":
        assert stat["depth"] >= 2 and stat["branch_pages"] >= 1
    if case == "boundary":
        assert stat["overflow_pages"] == 1
    if case == "txnid_election":
        env = tlmdb.open(paths["port"], subdir=False, readonly=True)
        assert env._tree.meta.txnid == 2
        env.close()
        # a stale meta 0 (txnid 0): both readers elect meta 1
        stale = bytearray(raw["port"])
        struct.pack_into("<Q", stale, 16 + 24 + 96 + 8, 0)
        path = tmp_path / "stale.mdb"
        path.write_bytes(bytes(stale))
        for reader in (jlmdb, tlmdb):
            assert _read(reader, str(path))[1] == items


@pytest.mark.parametrize("fault", ["file_cut", "chain_past_end"])
def test_truncated_overflow_chain_raises_in_both(tmp_path, fault):
    """The file cut inside the chain (the leaf after it lost too), or the
    chain's page count pointing past the end of the file."""
    val = os.urandom(30_000)
    path = str(tmp_path / "t.mdb")
    _write(tlmdb, path, {b"k": val})
    npages = (16 - 1 + len(val)) // 4096 + 1
    raw = bytearray(open(path, "rb").read())
    if fault == "file_cut":
        raw = raw[:npages * 4096]
    else:  # the overflow chain starts at page 2; its pb_pages at byte 12
        struct.pack_into("<I", raw, 2 * 4096 + 12, npages + 3)
    with open(path, "wb") as f:
        f.write(bytes(raw))
    for module in (jlmdb, tlmdb):
        env = module.open(path, subdir=False, readonly=True)
        with pytest.raises(module.Error, match="truncated|beyond end"):
            env.begin().get(b"k")
        env.close()
