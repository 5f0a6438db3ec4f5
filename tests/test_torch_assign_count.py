"""KD's plain version (assign_count_plain) on reads built by hand, whose
assignTRkmc fields and counts are derived here by hand; the seeded
adversarial generator that tests/test_torch_gpu.py holds KD against on the
card, and a check that it reaches every branch of the state machine.

Torch only (no JAX): the plain version is held against the JAX step in
test_torch_device_align.py.
"""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da

NAN32 = 0xFFFFFFFF
NM_TR = 5


def kd_cases(seed: int, P: int, NKW: int, nloci: int = 40,
             nm_tr: int = NM_TR) -> dict:
    """Seeded KD inputs (numpy) for P pairs of NKW positions, built to
    reach every branch of KD: reads with no known position, TR only,
    flank-TR-flank, annotations
    alternating every position, 1-4 transitions after bs = 1 or 2 (with
    and without a zero gap before each), a 2-run of nm_tr - 1 or nm_tr
    k-mers between two 1-runs, annotation 3, kf == 1 and bait-filtered
    pairs, dev_pair false, dst0 = nloci (loff's clamp) and NAN32, reads
    whose TR k-mers all hit one slot, slots past the table (dropped),
    counts one below the u32 wrap, single-locus dbi hits beside trfl
    answers and kvalid holes.  Returns the planes of assign_count_plain's
    arguments (bool planes as bool) and its state (int32 bit patterns)."""
    rng = np.random.default_rng([seed, NKW])
    R = 2 * P
    sizes = rng.integers(1, 48, nloci)
    loff = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nslots = int(loff[-1])
    dst0 = rng.integers(0, nloci, P).astype(np.int64)
    sp = rng.random(P)
    dst0[sp < 0.1] = nloci
    dst0[(sp >= 0.1) & (sp < 0.13)] = NAN32
    dev_pair = rng.random(P) < 0.85
    bf_pair = rng.random(P) < 0.06
    kf = (rng.random(R) < 0.06).astype(np.int32)
    nk = np.minimum(rng.integers(NKW // 2, NKW + 40, R), NKW).astype(
        np.int32)
    ann = np.zeros((R, NKW), np.int64)
    rank = np.zeros((R, NKW), np.int64)
    for r in range(R):
        d = int(dst0[r // 2])
        size = int(sizes[d]) if d < nloci else 1
        mode = r % 8
        if mode == 0:                           # no known position
            pass
        elif mode == 1:                         # alternating every position
            ann[r] = np.where(np.arange(NKW) % 2 == rng.integers(2), 1, 2)
            if rng.random() < 0.3:
                ann[r, rng.random(NKW) < 0.2] = 0
        elif mode in (2, 3):                    # k transitions after bs
            bs, k = 1 + (r // 40) % 2, (r // 8) % 5
            seq = [0] * int(rng.integers(0, 4))
            v = bs
            for j in range(k + 1):
                seq += [v] * int(rng.integers(1, max(2, NKW // (k + 2))))
                if j < k and rng.random() < 0.5:
                    seq += [0] * int(rng.integers(1, 4))
                v = 3 if rng.random() < 0.1 else 3 - v if v < 3 else 1
            seq = (seq + [0] * NKW)[:NKW]
            ann[r] = seq
        elif mode == 4:                         # 1, 2 x (nm_tr - 1 | nm_tr), 1
            n2 = nm_tr - int(rng.integers(0, 2))
            a = int(rng.integers(0, 3))
            seq = [0] * a + [1] * 2 + [0] * int(rng.integers(0, 2)) \
                + [2] * n2 + [1] * 3
            ann[r] = (seq + [0] * NKW)[:NKW]
        elif mode == 5:                         # random annotations
            ann[r] = rng.choice(4, NKW, p=[0.4, 0.25, 0.3, 0.05])
        elif mode == 6:                         # flank, a long TR, flank
            cut = np.sort(rng.integers(0, NKW + 1, 2))
            ann[r] = np.where(np.arange(NKW) < cut[0], 1,
                              np.where(np.arange(NKW) < cut[1], 2, 1))
        else:                                   # TR only, with holes
            ann[r] = np.where(rng.random(NKW) < 0.1, 0, 2)
        if rng.random() < 0.15:                 # one slot for the read
            rank[r] = int(rng.integers(0, size))
        else:
            rank[r] = rng.integers(0, size, NKW)
            rank[r, rng.random(NKW) < 0.02] += 1000   # past the table
    in_tr = rng.random((R, NKW)) < 0.3
    av = (rank << 3) | (in_tr.astype(np.int64) << 2) | ann
    kvalid = rng.random((R, NKW)) < 0.97
    kvalid[ann > 0] = True
    # where ann is 0: no trfl answer, or one whose low bits are 0, or a
    # kvalid hole over a non-zero answer
    zero = ann == 0
    pick = rng.random((R, NKW))
    hole = zero & (pick < 0.1)
    kvalid[hole] = False
    av[hole] |= 1 + rng.integers(0, 3, (R, NKW))[hole]
    afound_t = ~zero | (pick > 0.6)
    # a third of the positions answer through a single-locus dbi hit at
    # dst0 (val even), the rest through the trfl probe (val odd, or even
    # at another locus)
    dst_r = np.repeat(dst0, 2)[:, None]
    ev = (rng.random((R, NKW)) < 0.33) & (dst_r < (1 << 31))
    found = ev | (rng.random((R, NKW)) < 0.5)
    other = (dst_r + 1 + rng.integers(0, 5, (R, NKW))) & 0x7FFFFFFF
    val = np.where(ev, dst_r << 1,
                   np.where(rng.random((R, NKW)) < 0.5,
                            (rng.integers(0, 1 << 30, (R, NKW)) << 1) | 1,
                            other << 1))
    annv = np.where(ev, av, rng.integers(0, 1 << 32, (R, NKW)))
    aval_t = np.where(ev, rng.integers(0, 1 << 32, (R, NKW)), av)
    afound_t &= ~ev | (rng.random((R, NKW)) < 0.5)
    found &= kvalid
    counts = rng.integers(-(1 << 31), 1 << 31, nslots + 1)
    near = rng.choice(nslots, max(1, nslots // 4), replace=False)
    counts[near] = -1 - rng.integers(0, 2, len(near))    # u32 0xFFFFFFFF-
    return dict(
        found=found, val=val, annv=annv, kvalid=kvalid, afound_t=afound_t,
        aval_t=aval_t, dst0=dst0, dev_pair=dev_pair, kf=kf, nk=nk,
        loff=loff, nloci=nloci, nm_tr=nm_tr, bf_pair=bf_pair,
        counts=counts.astype(np.int32),
        nmapread=rng.integers(-(1 << 31), 1 << 31, nloci + 1).astype(
            np.int32),
        kmc=np.full(nloci + 1, -3, np.int32))


def kd_run(case: dict, device="cpu", threading=False, annot=False,
           bait=True, fn=None):
    """Runs assign_count (or ``fn``) on a kd_cases dict on ``device``:
    returns (fields dict, state dict)."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    state = {k: T(case[k].copy()) for k in ("counts", "nmapread", "kmc")}
    fn = fn or da.assign_count
    out = fn(state, *[T(case[k]) for k in (
        "found", "val", "annv", "kvalid", "afound_t", "aval_t", "dst0",
        "dev_pair", "kf", "nk", "loff")], case["nloci"], case["nm_tr"],
        threading, T(case["bf_pair"]) if bait else None, annot)
    return out, state


def walk(ann_row):
    """The reference's sequential scan of one read's annotations: raw nt,
    bs, ntr, and whether each of the first two transitions follows a zero
    (adj)."""
    lk, nt, bs, ntr, adj = 0, 0, 0, 0, []
    prev = 0
    for a in ann_row:
        if a > 0 and lk > 0 and a != lk:
            nt += 1
            if nt <= 2:
                adj.append(prev == 0)
        if a > 0 and bs == 0:
            bs = a
        ntr += a == 2
        if a > 0:
            lk = a
        prev = a
    return nt, bs, ntr, adj


def _hand(rows, dev=True, kf=(0, 0), bf=False, nk=None, dst=3, nm_tr=NM_TR,
          counts=None, rank=None):
    """One pair from two annotation rows (trfl answers, rank 0 unless
    ``rank``), at locus ``dst`` of 5 loci with 4 slots each."""
    NKW = len(rows[0])
    ann = np.array(rows, np.int64)
    rk = np.zeros_like(ann) if rank is None else np.array(rank, np.int64)
    T = torch.from_numpy
    state = dict(counts=T(np.zeros(21, np.int32) if counts is None
                          else np.array(counts, np.int32)),
                 nmapread=torch.zeros(6, dtype=torch.int32),
                 kmc=torch.zeros(6, dtype=torch.int32))
    out = da.assign_count_plain(
        state, torch.zeros((2, NKW), dtype=torch.bool),
        torch.zeros((2, NKW), dtype=torch.int64),
        torch.zeros((2, NKW), dtype=torch.int64),
        torch.ones((2, NKW), dtype=torch.bool), T(ann > 0),
        T((rk << 3) | ann), torch.tensor([dst]), torch.tensor([dev]),
        torch.tensor(kf, dtype=torch.int32),
        torch.tensor(nk or [NKW, NKW], dtype=torch.int32),
        torch.arange(0, 24, 4), 5, nm_tr, False, torch.tensor([bf]))
    return {k: v.tolist() for k, v in out.items()}, \
        {k: v.tolist() for k, v in state.items()}


def test_hand_built_reads():
    # mate 0: flank 1 at 2-3, a zero at 4, TR 2 at 5-9, flank 1 at 10-11:
    #   bs 1, transitions at 5 (prev 0: si1 = 3 + 1 = 4, ei1 = 5) and 10
    #   (prev 2: no gap), nt 2, ntr 5 = nm_tr -> kept; si = mid1 = 4,
    #   ei = mid2 = ti2 = 10, si_ = ei1 = 5, ei_ = ti2 = 10
    # mate 1: TR 2 from 0 to 5, then flank 1: bs 2, nt 1 at 6 (prev 2),
    #   si = 0, ei = mid1 = ti1 = 6, si_ = 0, ei_ = ti1 = 6
    m0 = [0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 1, 1]
    m1 = [2, 2, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0]
    out, st = _hand([m0, m1], nk=[12, 9])
    assert out["rm"] == [0, 0] and out["af"] == [0, 0]
    assert out["nt"] == [2, 1] and out["bs"] == [1, 2]
    assert out["ti"] == [5, 6]
    assert (out["si"], out["ei"]) == ([4, 0], [10, 6])
    assert (out["si_"], out["ei_"]) == ([5, 0], [10, 6])
    # counted: 5 + 6 TR k-mers on slot loff[3] + 0 = 12, the other 13 of
    # 24 positions in the trash slot 20; nmate 2, kmc (10-4) + (6-0)
    assert st["counts"][12] == 11 and st["counts"][20] == 13
    assert sum(st["counts"]) == 24
    assert st["nmapread"][3] == 2 and st["kmc"][3] == 12

    # the same mate 0 with its TR run one short of nm_tr: af (removed),
    # and mate 1 alone is counted (nmate 1)
    m0s = [0, 0, 1, 1, 0, 2, 2, 2, 2, 0, 1, 1]
    out, st = _hand([m0s, m1])
    assert out["af"] == [1, 0] and out["rm"] == [1, 0]
    assert out["nt"] == [2, 1] and out["si"] == [-1, 0]
    assert st["counts"][12] == 6 and st["counts"][20] == 18
    assert st["nmapread"][3] == 1 and st["kmc"][3] == 6

    # nt_rec's early stop: bs 2 stops at 2 transitions, bs 1 at 3; both
    # removed (af), so the pair is not counted: every position is trash
    out, st = _hand([[2, 1, 2, 1, 2, 1], [1, 2, 1, 2, 1, 2]])
    assert out["nt"] == [2, 3] and out["bs"] == [2, 1]
    assert out["af"] == [1, 1] and out["ti"] == [1, 1]
    assert st["counts"][20] == 12 and st["nmapread"] == [0] * 6

    # no known position: nt 0, bs 0 -> af (nt 0 and bs != 2)
    out, _ = _hand([[0] * 6, [2] * 6])
    assert out["nt"] == [0, 0] and out["bs"] == [0, 2]
    assert out["af"] == [1, 0] and out["si"] == [-1, 0]
    assert out["ei"] == [-1, 6] and out["ti"] == [-1, -1]

    # kf == 1 (rm_entry): rm 1, nt / bs / ti -1, si.. -1; dev_pair false:
    # rm 1, af 0, fields kept but si.. -1, nothing counted
    out, _ = _hand([m0, m1], kf=(1, 0))
    assert out["rm"] == [1, 0] and out["nt"] == [-1, 1]
    assert out["bs"] == [-1, 2] and out["si"] == [-1, 0]
    out, st = _hand([m0, m1], dev=False)
    assert out["rm"] == [1, 1] and out["af"] == [0, 0]
    assert out["nt"] == [0, 0] and out["si"] == [-1, -1]
    assert st["counts"][20] == 24 and st["nmapread"] == [0] * 6
    # bf_pair: both mates enter removed
    out, st = _hand([m0, m1], bf=True)
    assert out["rm"] == [1, 1] and out["nt"] == [-1, -1]
    assert st["counts"][20] == 24

    # dst0 = nloci: loff clamps to loff[5] = 20, so rank 0 counts into the
    # trash slot itself and rank 1 (slot 21) is dropped
    rk = [[0] * 12, [1] * 6 + [0] * 6]
    out, st = _hand([m0, m1], dst=5, rank=rk)
    assert st["counts"][20] == 5 + 13 and sum(st["counts"]) == 18
    assert st["nmapread"][5] == 2

    # u32 wrap: slot 12 at 0xFFFFFFFE takes 11 -> 9
    c = [0] * 21
    c[12] = -2
    _, st = _hand([m0, m1], counts=c)
    assert st["counts"][12] == 9


@pytest.mark.parametrize("NKW", [1, 31, 33, 140, 172, 300])
def test_generator_reaches_every_branch(NKW):
    """kd_cases at each NKW the card tests use reaches every branch: the
    plain version's fields agree with a sequential walk of its ann plane,
    and every case listed in kd_cases occurs."""
    P = 160
    case = kd_cases(5, P, NKW)
    out, st = kd_run(case, annot=True)
    ann = out["ann"].numpy()
    rm_entry = (case["kf"] == 1) | np.repeat(case["bf_pair"], 2)
    devr = np.repeat(case["dev_pair"], 2)
    seen = set()
    for r in range(2 * P):
        nt, bs, ntr, adj = walk(ann[r])
        if rm_entry[r] and devr[r]:
            assert int(out["nt"][r]) == -1
            seen.add("rm_entry_kf" if case["kf"][r] else "rm_entry_bf")
            continue
        assert int(out["bs"][r]) == bs
        rec = 2 if bs == 2 and nt >= 2 else 3 if bs == 1 and nt >= 3 else nt
        assert int(out["nt"][r]) == rec
        if not devr[r]:
            seen.add("dev_false")
            continue
        seen.add(("bs", bs, "nt", min(nt, 4)))
        if bs == 0:
            seen.add("no_known")
        if nt > 3 * 4:
            seen.add("alternating")
        if nt == 2 and bs == 1:
            seen.add(("ntr", "below" if ntr < NM_TR else "at_or_above"))
        for a in adj:
            seen.add(("adj", a))
        if (ann[r] == 3).any():
            seen.add("ann3")
    cnt_p = case["counts"].view(np.uint32).astype(np.int64)
    cnt_a = st["counts"].numpy().view(np.uint32).astype(np.int64)
    if (cnt_a < cnt_p)[:-1].any():
        seen.add("wrap")
    counted = case["dev_pair"] & ~out["rm"].numpy().reshape(P, 2).all(1)
    if (counted & (case["dst0"] == case["nloci"])).any():
        seen.add("dst0_nloci")
    slot = kd_run(case, threading=True)[0]["slot"].numpy()
    rm = out["rm"].numpy()
    for r in range(2 * P):
        tr = slot[r][ann[r] == 2]
        if counted[r // 2] and not rm[r] and len(tr) > 3 \
                and np.unique(tr).size == 1:
            seen.add("one_slot")
    need = {"dev_false", "rm_entry_kf", "rm_entry_bf"}
    if NKW >= 31:
        need |= {"no_known", ("ntr", "below"), ("ntr", "at_or_above"),
                 ("adj", True), ("adj", False), "ann3", "wrap",
                 "dst0_nloci", "one_slot"}
        need |= {("bs", b, "nt", n) for b in (1, 2) for n in range(4)}
    if NKW >= 33:
        need.add("alternating")
    assert need <= seen, sorted(map(str, need - seen))
