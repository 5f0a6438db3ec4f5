"""The port's error-correction site scorer (danbing_tk_tpu_torch/ops/
correct.py) against the Python oracle and the JAX package's scorer.

Every comparison is exact: the counters are integers and the edit
decisions lists.  Sites come from walks over the golden panel's locus
graphs with an injected substitution, NAN64 hole, truncation or NAN64
node, at mes 1 and 2 (as tests/test_correct_jax.py makes them).  The JAX scorer runs on
the CPU (conftest), jitted once at B = 128.
"""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu.ops import correct_jax as cj
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine import threading as thr
from danbing_tk_tpu_torch.engine.host_align import RPGG
from danbing_tk_tpu_torch.kernels import build
from danbing_tk_tpu_torch.ops import correct as cr

K = 21
RMASK = (1 << (2 * (K - 1))) - 1
B = 128
NPAD = 16
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def panel():
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    rp.load_graphs()
    return rp


def _sites(panel, rng, nsites):
    """[(locus, kmers, ki, mes)]: a walk of up to 60 steps from a random
    node of a locus graph, then a substitution at ki, a NAN64 hole at
    ki + 2, a truncation after ki, a NAN64 node at ki - 1 or nothing."""
    out = []
    for li in rng.integers(0, panel.nloci, 20 * nsites):
        g = panel.graphs[int(li)]
        if not g:
            continue
        nodes = list(g)
        cur = node = int(nodes[int(rng.integers(0, len(nodes)))])
        kmers = [node]
        for _ in range(60):
            bits = g.get(cur, 0)
            if not bits:
                break
            b = int(rng.integers(0, 4))
            while not (bits >> b) & 1:
                b = (b + 1) % 4
            cur = ((cur & RMASK) << 2) | b
            kmers.append(cur)
        if len(kmers) < 13:
            continue
        mode = int(rng.integers(0, 5))
        ki = int(rng.integers(1, len(kmers)))
        if mode == 0 and ki + 2 < len(kmers):
            kmers[ki] ^= int(rng.integers(1, 4))
        elif mode == 1 and ki + 3 < len(kmers):
            kmers[ki + 2] = cr.NAN64
        elif mode == 2:
            kmers = kmers[: ki + int(rng.integers(1, 6))]
        elif mode == 3:
            kmers[ki - 1] = cr.NAN64
        if ki >= len(kmers):
            continue
        out.append((int(li), kmers, ki, 1 if rng.random() < 0.3 else 2))
        if len(out) == nsites:
            break
    assert len(out) == nsites, "site generator starved"
    return out


def _gbits(g):
    def gbits(km):
        v = g.get(km)
        return (v is not None, v or 0)
    return gbits


def _counters_from_txt(txt):
    out = np.zeros(cr.NCHAINS, dtype=np.int64)
    for name in ("nem1", "ned1", "nem2", "nemd", "ned2", "nemi"):
        v = getattr(txt, name)
        out[cr._OFF[name]:cr._OFF[name] + len(v)] = v
    out[cr._OFF["nei1"]] = txt.nei1
    out[cr._OFF["nei2"]] = txt.nei2
    return out


def test_score_site_np_matches_oracle_and_jax(panel):
    """The port's score_site_np against the port's error_correction_forward
    counter for counter, its get_edit_from_counters against
    ThreadExt.get_edit, and both against the JAX package's copies."""
    rng = np.random.default_rng(11)
    checked = 0
    for li, kmers, ki, mes in _sites(panel, rng, 400):
        g = panel.graphs[li]
        node = kmers[ki - 1]
        if node == cr.NAN64 or node not in g:
            continue
        nnds, nts0 = thr.get_out_nodes(g, node, K)
        txt = thr.ThreadExt(mes, False)
        thr.error_correction_forward(nnds, g, kmers, ki, nts0, txt, mes, K,
                                     RMASK)
        got = cr.score_site_np(_gbits(g), kmers, ki, K, mes)
        np.testing.assert_array_equal(got, _counters_from_txt(txt))
        np.testing.assert_array_equal(
            got, cj.score_site_np(_gbits(g), kmers, ki, K, mes))
        # a fresh ThreadExt scans the same counters (get_edit mutates
        # score even without edits)
        txt2 = thr.ThreadExt(mes, False)
        for name in ("nem1", "ned1", "nem2", "nemd", "ned2", "nemi"):
            setattr(txt2, name, list(getattr(txt, name)))
        txt2.nei1, txt2.nei2 = txt.nei1, txt.nei2
        txt2.get_edit()
        decision = cr.get_edit_from_counters(got, mes)
        assert decision == (txt2.score, txt2.edits)
        assert decision == cj.get_edit_from_counters(got, mes)
        checked += 1
    assert checked >= 100


@pytest.fixture(scope="module")
def models(panel):
    """Each package's DeviceRPGG with its graph table, built from its own
    RPGG of the golden panel."""
    jr = JRPGG(os.path.join(GOLDEN, "pan"))
    jd = jda.DeviceRPGG.build(jr, with_tre=False)
    jd.add_graph(jr)
    td = tda.DeviceRPGG.build(panel, with_tre=False)
    td.add_graph(panel)
    return jd, td


@pytest.fixture(scope="module")
def batch(panel):
    """B - NPAD golden sites in a batch of B (the last NPAD rows pad)."""
    sites = _sites(panel, np.random.default_rng(23), B - NPAD)
    return sites, [(kmers, ki, li) for li, kmers, ki, _ in sites]


def test_graph_tables_byte_equal(models):
    jd, td = models
    assert len(jd.graph_tab.levels) == len(td.graph_tab.levels)
    for (a, s), (b, t) in zip(jd.graph_tab.levels, td.graph_tab.levels):
        assert s == t and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mes", [2, 1])
def test_plain_scorer_matches_jax(panel, models, batch, mes):
    """score_sites_plain (the port's tensor transcription) against JAX's
    make_site_scorer on the same bytes, pad rows included: jitted at
    mes = 2, unjitted at mes = 1.  Each real row also equals the port's
    score_site_np."""
    jd, td = models
    sites, batch_sites = batch
    halves = cr.sites_to_batch(batch_sites, k=K, B=B)
    for a, b in zip(halves, cj.sites_to_batch(batch_sites, k=K, B=B)):
        np.testing.assert_array_equal(a, b)
    w_lo, w_hi, nkrem, loc = halves
    want = np.asarray(cj.make_site_scorer(jd, B, k=K, mes=mes,
                                          jit=mes == 2)(w_lo, w_hi, nkrem,
                                                        loc))
    gtab = td.tables("cpu", graph=True)["graph"]
    got = cr.score_sites_plain(gtab, torch.from_numpy(cr.join_w(w_lo, w_hi)),
                               torch.from_numpy(nkrem),
                               torch.from_numpy(loc), K, mes)
    assert got.dtype == torch.int32 and got.shape == (B, cr.NCHAINS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[B - NPAD:].any() and got.any()
    for i, (li, kmers, ki, _) in enumerate(sites):
        np.testing.assert_array_equal(
            got[i].numpy(),
            cr.score_site_np(_gbits(panel.graphs[li]), kmers, ki, K, mes))


@pytest.mark.parametrize("mes", [2, 1])
def test_live_probes_suffice(panel, models, batch, mes):
    """The probes KJ makes (site_probes: the early-exit walk's) are enough:
    a graph that answers only those gives every site the same counters,
    and a site needs far fewer than JAX's 21 + 62 k."""
    _, td = models
    sites, batch_sites = batch
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(batch_sites, k=K, B=B)
    args = (td.tables("cpu", graph=True)["graph"],
            torch.from_numpy(cr.join_w(w_lo, w_hi)), torch.from_numpy(nkrem),
            torch.from_numpy(loc), K, mes)
    cnt = cr.score_sites_plain(*args)
    site, q = cr.site_probes(*args)
    assert int(site.max()) < B - NPAD       # pad rows probe nothing
    assert 0 < len(q) < (B - NPAD) * (21 + 62 * K) // 4
    live = {}
    for s_, q_ in zip(site.tolist(), q.tolist()):
        live.setdefault(s_, set()).add(q_ & 0xFFFFFFFFFFFFFFFF)
    for i, (li, kmers, ki, _) in enumerate(sites):
        g, seen = panel.graphs[li], live.get(i, set())

        def gbits(km, g=g, seen=seen):
            v = g.get(km) if km in seen else None
            return (v is not None, v or 0)

        np.testing.assert_array_equal(
            cnt[i].numpy(), cr.score_site_np(gbits, kmers, ki, K, mes))


def test_make_site_scorer_device(models, batch, monkeypatch):
    """On the CPU, make_site_scorer runs the plain version and launches
    no kernel; with no device given and no card it raises."""
    _, td = models
    _, batch_sites = batch
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(batch_sites, k=K, B=B)
    w = cr.join_w(w_lo, w_hi)
    build.reset_launch_counts()
    got = cr.make_site_scorer(td, B, k=K, mes=2, device="cpu")(w, nkrem, loc)
    assert build.launch_counts()["KJ"] == 0
    want = cr.score_sites_plain(td.tables("cpu", graph=True)["graph"],
                                torch.from_numpy(w), torch.from_numpy(nkrem),
                                torch.from_numpy(loc), K, 2)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        cr.make_site_scorer(td, B + 1, k=K, device="cpu")(w, nkrem, loc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cr.make_site_scorer(td, B)
