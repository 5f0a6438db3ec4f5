"""tools/kernel_bounds.py, the one definition of each kernel's bound that
chip_smoke.py and tools/full_index_probe.py share, on the CPU.

* The probes' row counts agree with each other and with a row count made
  here bucket by bucket in numpy: KB's over a whole table, KI's over its
  one row block at D = 1, and KI[count]'s over the non-EMPTY queries.
* max_abs_err walks tuples and dicts, counts a differing bool plane as 1
  and raises on a shape mismatch.
"""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.index import device_table as dt
from danbing_tk_tpu_torch.parallel import sharded_index as si
from danbing_tk_tpu_torch.tools import kernel_bounds as kbd


@pytest.fixture(scope="module")
def table():
    """A three-level-or-more table (lam 7.5 overflows level 0) and 4,096
    queries, half of them its keys, a tenth EMPTY."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 42, 30_000, dtype=np.uint64))
    vals = rng.integers(0, 1 << 31, len(keys), dtype=np.uint64).astype(
        np.uint32)
    tab = dt.DevTable.upload(dt.build_bucket_table(keys, vals, lam=7.5),
                             "cpu")
    q = np.where(rng.random(4096) < 0.5, rng.choice(keys, 4096),
                 rng.integers(0, 1 << 42, 4096, dtype=np.uint64))
    q = q.astype(np.int64)
    q[rng.random(4096) < 0.1] = -1
    return tab, torch.from_numpy(q)


def _rows_np(tab, q):
    """Distinct rows a query reads up to its first hit, level by level."""
    found = dt.lookup_bucket_plain(tab, q)[0].numpy()
    rows, need = 0, np.ones(len(q), dtype=bool)
    for t, salt in zip(tab.levels, tab.salts):
        lo = (q.numpy() & 0xFFFFFFFF).astype(np.uint32)
        hi = ((q.numpy() >> 32) & 0xFFFFFFFF).astype(np.uint32)
        b = dt._salted_hash_np(lo, hi, None, salt) & np.uint32(
            t.shape[0] - 1)
        rows += len(np.unique(b[need]))
        one = dt.DevTable([t], [salt], tab.composite, tab.nval)
        need &= ~dt.lookup_bucket_plain(one, q)[0].numpy()
    assert not need[found].any()
    return rows


def test_probe_rows_agree(table):
    tab, q = table
    assert len(tab.levels) >= 2
    nbytes, rows, reads = kbd.probe_bytes(tab, q)
    assert rows == _rows_np(tab, q) and reads >= q.numel()
    assert nbytes == rows * kbd.row_bytes(tab) + q.numel() * 25
    blk, meta = si.row_blocks(tab, 1)[0]
    obytes, orows = kbd.owned_bytes(blk, meta, q)
    assert orows == rows and obytes == rows * kbd.row_bytes(tab) \
        + q.numel() * 20
    # D = 4: every level-0 row belongs to one block; a block sees only
    # its own hits, so its queries may read on at deeper levels
    per = [kbd.owned_bytes(b, m, q)[1] for b, m in si.row_blocks(tab, 4)]
    assert sum(per) >= rows
    qc = q.reshape(-1, 4)
    cbytes, crows = kbd.owned_count_bytes(blk, meta, qc)
    real = q[q != -1]
    assert crows == _rows_np(tab, real)
    assert cbytes == 8 * q.numel() + 4 * qc.shape[0] \
        + crows * kbd.row_bytes(tab)
    assert kbd.bound_ms(kbd.HBM_BYTES_PER_MS) == 1.0


def test_max_abs_err():
    a = torch.tensor([1, 5, -3])
    b = torch.tensor([1, 2, -3])
    assert kbd.max_abs_err(a, a) == 0 and kbd.max_abs_err(a, b) == 3
    assert kbd.max_abs_err({"x": (a, a), "y": a}, {"x": (a, b), "y": a}) == 3
    t = torch.tensor([True, False])
    assert kbd.max_abs_err(t, ~t) == 1 and kbd.max_abs_err(t, t) == 0
    assert kbd.max_abs_err(a[:0], b[:0]) == 0
    with pytest.raises(AssertionError, match="shape"):
        kbd.max_abs_err(a, b[:2])
