"""The port's continuous-batching service against the reference's,
script by script.

Seeded ``random_script``s run through both services, each on its own
``FakeClock`` with both program caches cleared first (the warm solo route
depends on them), must resolve every request the same way — routes,
engine ids, shed and failed ids, polls, ``latency_s`` — with bitwise
equal colors, histories and ``n_iters_run`` (the reference runs live
under ``jax_threefry_partitionable=True``).  One script makes graphs of
different content take the same engine lane in turn; one runs the flush
mode's batch waves.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
R = pytest.importorskip("repro.core")
import repro.launch.serve_coloring as RS  # noqa: E402
import serve_harness as RH  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.launch.serve_harness import (  # noqa: E402
    Arrival, random_script, run_script)
from test_torch_serve import P, _assert_bitwise, _cfg, _pool, _svc  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _both(serve_kw, cfg=_cfg, *, validate=False):
    """(reference service, port service), each on its own FakeClock, both
    program caches cleared."""
    R.program_cache_clear()
    T.program_cache_clear()
    ref = RS.ColoringService(P=P, cfg=cfg(R), validate=validate,
                             clock=RS.FakeClock(),
                             serve=RS.ServeConfig(**serve_kw))
    port = _svc(cfg(T), validate=validate, **serve_kw)
    return ref, port


def _assert_same(ref_out, port_out):
    """Both services resolved every request the same way."""
    assert port_out.polls == ref_out.polls
    assert port_out.shed == ref_out.shed
    assert port_out.failed == ref_out.failed
    assert sorted(port_out.results) == sorted(ref_out.results)
    for jid, r in ref_out.results.items():
        t = port_out.results[jid]
        assert t["route"] == r["route"], jid
        assert t["latency_s"] == r["latency_s"], jid
        assert t["bucket"] == r["bucket"], jid
        np.testing.assert_array_equal(t["colors"], np.asarray(r["colors"]))
        assert t["history"] == r["history"], jid
        assert t["n_iters_run"] == r["n_iters_run"], jid
        assert t["n_colors"] == r["n_colors"], jid


@pytest.mark.parametrize("k", range(6))
def test_script_parity_with_reference(k):
    """Seeded random scripts (lanes, chunk, SLO, warm solo route, ND or
    ND-RAND%2 drawn per script) through both services."""
    gen = np.random.default_rng(20_000 + k)
    serve_kw = dict(lanes=int(gen.choice([1, 2, 4])),
                    chunk_iters=int(gen.choice([1, 2, 3])),
                    slo_s=(None if gen.random() < 0.5
                           else float(gen.uniform(3.0, 10.0))),
                    solo_warm=bool(gen.random() < 0.4))
    rand_every = int(gen.choice([0, 2]))
    n = int(gen.integers(6, 12))
    gap = float(gen.uniform(0.3, 2.5))
    cfg = lambda M: _cfg(M, n_iters=4, patience=1, rand_every=rand_every)
    ref, port = _both(serve_kw, cfg)
    ref_out = RH.run_script(ref, RH.random_script(
        np.random.default_rng(k), _pool(R), n=n, mean_gap=gap))
    port_out = run_script(port, random_script(
        np.random.default_rng(k), _pool(T), n=n, mean_gap=gap))
    _assert_same(ref_out, port_out)
    if serve_kw["solo_warm"]:
        # a second pass of the same script finds the solo entries cached
        ref_out = RH.run_script(ref, RH.random_script(
            np.random.default_rng(k), _pool(R), n=n, mean_gap=gap))
        port_out = run_script(port, random_script(
            np.random.default_rng(k), _pool(T), n=n, mean_gap=gap))
        _assert_same(ref_out, port_out)


def test_script_parity_same_lane_different_graphs():
    """Graphs of different content but one engine shape take the same
    lane in turn (the exchange map is the lane's new graph's), under
    ND-RAND%2 with staggered arrivals."""
    def graphs(M):
        return [M.rmat.rmat_good(7, 4, seed=s) for s in (1, 2, 3, 4, 5, 6)]

    cfg = lambda M: _cfg(M, n_iters=4, patience=0, rand_every=2)
    ref, port = _both(dict(lanes=2, chunk_iters=1, solo_warm=False), cfg,
                      validate=True)
    script = lambda M: [RH.Arrival(float(t), g) if M is R else
                        Arrival(float(t), g)
                        for t, g in enumerate(graphs(M) * 2)]
    ref_out = RH.run_script(ref, script(R))
    port_out = run_script(port, script(T))
    _assert_same(ref_out, port_out)
    # some (engine, lane) ran two graphs of different content
    content = {jid: i % 6 for i, jid in enumerate(sorted(port_out.futures))}
    seen = {}
    for running in port_out.poll_log:
        for eid, b, jid in running:
            seen.setdefault((eid, b), set()).add(content[jid])
    assert any(len(s) > 1 for s in seen.values()), seen
    assert _assert_bitwise(port, port_out.results) == len(port_out.results)


def test_flush_mode_parity_with_reference():
    """The batch-synchronous router: the same routes, buckets, colors and
    histories as the reference's (a cold wave, then a warm one)."""
    ref, port = _both(dict(mode="flush"),
                      lambda M: _cfg(M, n_iters=3, rand_every=2))
    for _ in range(2):
        ids_r = [ref.submit(g) for g in _pool(R)]
        ids_t = [port.submit(g) for g in _pool(T)]
        assert ids_r == ids_t
        res_r, res_t = ref.flush(), port.flush()
        ref.prewarm(_pool(R)[:2])
        port.prewarm(_pool(T)[:2])
        for i in ids_r:
            r, t = res_r[i], res_t[i]
            assert (t["route"], t["bucket"]) == (r["route"], r["bucket"])
            np.testing.assert_array_equal(t["colors"],
                                          np.asarray(r["colors"]))
            assert t["history"] == r["history"]
            assert t["n_iters_run"] == r["n_iters_run"]
    assert port.stats()["solo"] == ref.stats()["solo"] > 0
