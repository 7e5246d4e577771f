"""The port's continuous-batching service, in the reference's tests.

The port's forms of every test in ``tests/test_serve_continuous.py`` and
of ``test_coloring_service_round_trip`` and
``test_service_stats_counters_consistent`` in ``tests/test_serve.py``, on
the CPU (``device="cpu"``): under any interleaving of admissions every
accepted job's engine result is bitwise a solo ``pipeline_sim`` of the
same engine-padded member with the same request-id-folded keys; futures,
SLO and queue-bound sheds, per-lane fault isolation, K=0 lanes, counters
and engine reuse as the reference's.  The ``cuda`` cases run a short
script on the card.  ``test_torch_serve_parity.py`` holds the port's
service to the reference's, script by script.
"""
import os

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import rng
from repro_torch.launch.serve_coloring import (
    ColoringService, FakeClock, JobError, ServeConfig, ShedError,
    default_config)
from repro_torch.launch.serve_harness import (
    Arrival, mid_flight_admissions, random_script, run_script)
from test_torch_threads import one_torch_thread  # noqa: F401

P = 2
MC = 512


def _cfg(M=T, scheme: str = "sparse", n_iters: int = 3, patience: int = 1,
         rand_every: int = 0):
    return M.PipelineConfig(
        color=M.ColorConfig(max_colors=64, superstep=32, selection="random_x",
                            random_x=10, scheme=scheme),
        recolor=M.RecolorConfig(max_colors=64, scheme=scheme),
        n_iters=n_iters, patience=patience, rand_every=rand_every)


def _pool(M=T):
    """A small mixed pool: >= 2 shape buckets at P=2."""
    return [M.rmat.rmat_good(4, 8, seed=1), M.rmat.rmat_bad(4, 8, seed=2),
            M.rmat.rmat_er(5, 8, seed=3), M.rmat.grid2d(8, 8, 5)]


def _clique(M, n: int):
    ind, indptr = [], [0]
    for u in range(n):
        ind += [v for v in range(n) if v != u]
        indptr.append(len(ind))
    return M.Graph(n=n, indptr=np.array(indptr), indices=np.array(ind))


def _svc(cfg=None, *, validate=True, device="cpu", **serve_kw):
    return ColoringService(P=P, cfg=cfg or _cfg(), validate=validate,
                           clock=FakeClock(), serve=ServeConfig(**serve_kw),
                           device=device)


def _assert_bitwise(svc, results: dict) -> int:
    """Every engine-route result == the port's solo pipeline_sim of its
    padded member (same folded keys, same resolved config) on the
    service's device — colors, history and iteration count bitwise."""
    n = 0
    for jid, r in results.items():
        if r["route"] != "engine" or "error" in r:
            continue
        m, rcfg = r["member"], r["cfg"]
        view, solo = T.pipeline_sim(
            m, T.compute_order(m, svc.order_kind), rcfg,
            color_key=rng.fold_in(rng.key(rcfg.color.seed), jid),
            recolor_key=rng.fold_in(rng.key(rcfg.seed), jid),
            device=svc.device)
        colors = m.gather_global_colors(
            view.cpu().numpy()[:, :m.n_local_max])
        np.testing.assert_array_equal(colors, r["colors"], err_msg=str(jid))
        assert solo["history"] == r["history"], jid
        assert solo["n_iters_run"] == r["n_iters_run"], jid
        n += 1
    return n


# ------------------------------------- tests/test_serve_continuous.py forms --

def test_continuous_round_trip():
    """A mixed queue, flushed: every job valid, engine-routed and bitwise
    its solo run; pending/stats transitions consistent."""
    svc = _svc(lanes=2, chunk_iters=1, solo_warm=False)
    graphs = _pool()
    ids = [svc.submit(g) for g in graphs + graphs[::-1]]
    assert svc.pending == len(ids)
    res = svc.flush()
    assert sorted(res) == ids
    assert svc.pending == 0
    for i in ids:
        assert res[i]["check"]["valid"], (i, res[i]["check"])
        assert res[i]["route"] == "engine"
        assert res[i]["latency_s"] >= 0
    assert _assert_bitwise(svc, res) == len(ids)
    st = svc.stats()
    assert st["lane"] == len(ids) and st["n_shed"] == 0
    assert st["queued"] == st["running"] == 0


def test_futures_resolve_without_flush():
    """submit_async futures resolve by driving poll() — no flush call."""
    svc = _svc(lanes=2)
    futs = [svc.submit_async(g) for g in _pool()]
    outs = [f.result() for f in futs]
    for f, out in zip(futs, outs):
        assert f.done() and f.exception() is None
        assert out["check"]["valid"]
    assert svc.pending == 0


def test_mid_flight_admission_bitwise():
    """Arrivals that land while earlier lanes are mid-run: the admission
    must not perturb a neighbour lane (bitwise)."""
    graphs = _pool()
    svc = _svc(lanes=2, chunk_iters=1, solo_warm=False)
    script = [Arrival(float(t), graphs[t % len(graphs)]) for t in range(8)]
    out = run_script(svc, script)
    assert not out.shed and not out.failed
    assert out.polls > 4
    # a job entered an engine while a neighbour lane kept running
    assert mid_flight_admissions(out.poll_log) > 0, out.poll_log
    assert _assert_bitwise(svc, out.results) == len(script)


def test_engine_reuse_no_retrace():
    """A second service running the same script reuses every cached
    engine program: no new program-cache builds."""
    graphs = _pool()
    script = [Arrival(float(t), graphs[t % len(graphs)]) for t in range(6)]
    run_script(_svc(lanes=2, solo_warm=False, validate=False), script)
    before = T.program_cache_stats()["traces"]
    out = run_script(_svc(lanes=2, solo_warm=False, validate=False), script)
    assert len(out.results) == len(script)
    assert T.program_cache_stats()["traces"] == before


def test_slo_shed_deterministic():
    """One lane, three simultaneous arrivals, SLO 1.5 virtual seconds: the
    lane takes 3 ticks, so exactly the two waiting jobs shed."""
    g = _pool()[0]
    svc = _svc(_cfg(n_iters=3, patience=0), lanes=1, chunk_iters=1,
               slo_s=1.5, solo_warm=False)
    out = run_script(svc, [Arrival(0.0, g)] * 3)
    ids = sorted(out.futures)
    assert out.shed == ids[1:]
    assert sorted(out.results) == ids[:1]
    for jid in out.shed:
        with pytest.raises(ShedError):
            out.futures[jid].result()
    st = svc.stats()
    assert st["n_shed"] == 2
    assert st["n_deferred"] == 2
    assert _assert_bitwise(svc, out.results) == 1


def test_queue_bound_sheds_at_submit():
    """Submits past max_queue shed at once with a ShedError future."""
    svc = _svc(lanes=1, max_queue=2, solo_warm=False)
    g = _pool()[0]
    ids = [svc.submit(g) for _ in range(4)]
    st = svc.stats()
    assert st["n_shed"] == 2 and st["queued"] == 2
    assert svc.pending == 2
    for jid in ids[2:]:
        assert isinstance(svc.future(jid).exception(), ShedError)
    res = svc.flush()
    assert sorted(res) == ids[:2]


def test_fault_isolation_saturated_lane():
    """A lane whose graph saturates the color ids (K80 needs 80 > 64
    colors) fails only its own job; the engine drains the others."""
    svc = _svc(_cfg(n_iters=2, patience=0), validate=False, lanes=2,
               solo_warm=False)
    assert svc.cfg.color.max_colors == 64
    graphs = [_clique(T, 80)] + _pool()[:3]
    futs = [svc.submit_async(g) for g in graphs]
    res = svc.flush()
    bad_id = futs[0].id
    with pytest.raises(JobError):
        futs[0].result()
    assert "error" in res[bad_id]
    assert res[bad_id]["check"]["valid"] is False
    for f in futs[1:]:
        assert "error" not in f.result()
    st = svc.stats()
    assert st["n_failed"] == 1 and st["lane"] == len(graphs) - 1
    assert _assert_bitwise(svc, res) == len(graphs) - 1


def test_n_iters_zero_lane():
    """K=0 lanes complete on their first step with an empty history, and
    still match the solo run."""
    svc = _svc(_cfg(n_iters=0), lanes=2, solo_warm=False)
    for g in _pool()[:2]:
        svc.submit(g)
    res = svc.flush()
    for r in res.values():
        assert r["history"] == [] and r["n_iters_run"] == 0
        assert r["check"]["valid"]
    assert _assert_bitwise(svc, res) == 2


def _run_random_script(k: int, graphs):
    """One seeded random scenario (arrivals, lanes, chunking, SLO)."""
    gen = np.random.default_rng(10_000 + k)
    svc = _svc(lanes=int(gen.choice([1, 2, 4])),
               chunk_iters=int(gen.choice([1, 2])),
               slo_s=(None if gen.random() < 0.5
                      else float(gen.uniform(4.0, 12.0))),
               solo_warm=bool(gen.random() < 0.3), validate=False)
    script = random_script(gen, graphs, n=int(gen.integers(5, 12)),
                           mean_gap=float(gen.uniform(0.3, 3.0)))
    out = run_script(svc, script)
    assert len(out.results) + len(out.shed) == len(script)
    assert not out.failed
    assert svc.pending == 0
    st = svc.stats()
    assert st["n_shed"] == len(out.shed)
    assert st["lane"] + st["solo"] == len(out.results)
    _assert_bitwise(svc, out.results)
    return svc, out


def test_stress_random_scripts():
    """Across ``$SERVE_STRESS_SCRIPTS`` seeded scripts (default 8) every
    accepted job is bitwise its solo run and the accounting balances."""
    graphs = _pool()
    n = sum(len(_run_random_script(k, graphs)[1].results)
            for k in range(int(os.environ.get("SERVE_STRESS_SCRIPTS", "8"))))
    assert n > 0


def test_property_hypothesis_scripts():
    """The same property, hypothesis-driven."""
    hyp = pytest.importorskip("hypothesis")
    st_h = pytest.importorskip("hypothesis.strategies")
    graphs = _pool()

    @hyp.settings(max_examples=8, deadline=None)
    @hyp.given(seed=st_h.integers(min_value=0, max_value=2**20),
               lanes=st_h.sampled_from([1, 2, 4]),
               chunk=st_h.sampled_from([1, 2]),
               slo=st_h.sampled_from([None, 5.0, 10.0]))
    def prop(seed, lanes, chunk, slo):
        gen = np.random.default_rng(seed)
        svc = _svc(lanes=lanes, chunk_iters=chunk, slo_s=slo,
                   solo_warm=False, validate=False)
        out = run_script(svc, random_script(gen, graphs,
                                            n=int(gen.integers(4, 10)),
                                            mean_gap=1.0))
        assert len(out.results) + len(out.shed) == len(out.futures)
        _assert_bitwise(svc, out.results)

    prop()


# -------------------------------------------------- tests/test_serve.py forms --

def _mix(M=T):
    return [M.rmat.rmat_good(6, 8, seed=1), M.rmat.rmat_bad(6, 8, seed=2),
            M.rmat.rmat_good(8, 8, seed=3), M.rmat.grid2d(16, 16, 9)]


def test_coloring_service_round_trip():
    """Submit/flush returns valid colorings keyed by request id."""
    svc = ColoringService(
        P=2, validate=True, device="cpu",
        cfg=default_config(max_colors=MC, n_iters=2, patience=0))
    graphs = _mix()
    ids = [svc.submit(g) for g in graphs]
    assert svc.pending == len(graphs)
    res = svc.flush()
    assert svc.pending == 0 and sorted(res) == sorted(ids)
    for g, i in zip(graphs, ids):
        assert res[i]["check"]["valid"]
        assert res[i]["n_colors"] == res[i]["check"]["n_colors"]


@pytest.mark.parametrize("mode", ["flush", "continuous"])
def test_service_stats_counters_consistent(mode):
    """``stats()`` always reports the shed/deferral counters, ``pending``
    == queued + running in every state, and completions by route sum to
    the results returned."""
    svc = ColoringService(
        P=2, validate=True, clock=FakeClock(), device="cpu",
        cfg=default_config(max_colors=MC, n_iters=2, patience=0),
        serve=ServeConfig(mode=mode, lanes=2, max_queue=3))
    st = svc.stats()
    for key in ("n_shed", "n_deferred", "n_failed", "solo", "batch",
                "lane", "queued", "running", "engines"):
        assert key in st, key
    assert st["queued"] == st["running"] == svc.pending == 0
    graphs = _mix()
    ids = [svc.submit(g) for g in graphs]
    st = svc.stats()
    assert st["queued"] + st["running"] == svc.pending
    n_shed = st["n_shed"]
    assert n_shed == (len(graphs) - 3 if mode == "continuous" else 0)
    assert svc.pending == len(graphs) - n_shed
    res = svc.flush()
    st = svc.stats()
    assert svc.pending == st["queued"] == st["running"] == 0
    assert len(res) == len(graphs) - n_shed
    assert st["solo"] + st["batch"] + st["lane"] == len(res)
    assert st["n_shed"] == n_shed and st["n_failed"] == 0
    for i in ids[:len(graphs) - n_shed]:
        assert res[i]["check"]["valid"]


def test_service_needs_one_device():
    """A mesh needs axis names and an initialised world (the mesh route
    runs in ``tests/test_torch_sharded_serve.py``), and without a mesh the
    default device is CUDA."""
    from repro_torch.launch.mesh import MeshSpec
    with pytest.raises(ValueError, match="axis names"):
        ColoringService(P=2, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="init_world"):
        ColoringService(P=2, mesh=MeshSpec.worker(2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ColoringService(P=2)


# ------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2])
def test_cuda_script_bitwise_solo(cuda_device, chunk):
    """A short script on the card: every engine result bitwise its solo
    run on the card, and equal to the same script on the CPU."""
    graphs = _pool()
    script = [Arrival(float(t), graphs[t % len(graphs)]) for t in range(8)]
    cfg = _cfg(n_iters=4, patience=1, rand_every=2)
    outs = []
    for dev in (cuda_device, "cpu"):
        svc = _svc(cfg, lanes=2, chunk_iters=chunk, solo_warm=False,
                   device=dev)
        out = run_script(svc, script)
        assert not out.shed and not out.failed
        assert _assert_bitwise(svc, out.results) == len(script)
        outs.append(out)
    for jid, r in outs[1].results.items():
        np.testing.assert_array_equal(outs[0].results[jid]["colors"],
                                      r["colors"])
        assert outs[0].results[jid]["history"] == r["history"]
