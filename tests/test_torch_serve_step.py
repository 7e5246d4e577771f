"""The port's stepped recolor loop against the reference's, chunk by chunk.

An engine of B lanes is driven through the engine programs of both
packages (``engine_init_program`` → put into a lane → ``engine_step_program``
per chunk, ``mesh=None``) by the same admission script: one request is
admitted per step while a lane is free, so lanes sit at different
iterations (under ND-RAND%2, different permutation kinds share a step),
some lanes are empty and some done, and different graphs take the same
lane in turn.  After every chunk the port's carry must equal the
reference's (run live under ``jax_threefry_partitionable=True``): the view
of every lane, ``it``, ``best``, ``stall``, the history rows, the class
sizes, the out-of-range counts and the ``done`` mask, bit for bit.
Every drained lane must also equal the port's solo ``pipeline_sim`` of its
padded member with the same keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

R = pytest.importorskip("repro.core")
import repro_torch.core as T  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core.graph import arrays_from_numpy  # noqa: E402
from repro.core.speculative import _apply_partial  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

P, MC = 2, 64


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _d1_pool(M):
    return [M.rmat.rmat_good(4, 8, seed=1), M.rmat.rmat_bad(4, 8, seed=2),
            M.rmat.rmat_er(5, 8, seed=3), M.rmat.grid2d(8, 8, 5)]


def _d2_pool(M):
    return [M.rmat.grid2d(8, 8, 9), M.rmat.grid2d(8, 6, 9),
            M.rmat.rmat_good(4, 8, seed=1)]


def _cfg(M, *, distance=1, scheme="sparse", n_iters=5, patience=2,
         rand_every=2, partial=False):
    return M.PipelineConfig(
        color=M.ColorConfig(max_colors=MC, superstep=32, tile=16,
                            selection="random_x", random_x=10,
                            scheme=scheme, distance=distance,
                            max_rounds=256, partial=partial),
        recolor=M.RecolorConfig(max_colors=MC, scheme=scheme,
                                distance=distance),
        n_iters=n_iters, patience=patience, rand_every=rand_every)


def _members(M, pool, halo):
    """The pool's partitions (package ``M``) padded to their widest dims,
    as one bucket (so every graph fits every lane), with the bucket's
    union schedule."""
    pgs = [M.partition_graph(g, P, halo=halo) for g in pool(M)]
    dims = ("n_local_max", "max_ghost", "max_boundary", "m_local_max",
            "maxd", "maxd2")
    wide = {d: max(getattr(pg, d) for pg in pgs) for d in dims}
    return M.GraphBucket(indices=tuple(range(len(pgs))), members=tuple(
        M.pad_partition(pg, **wide) for pg in pgs))


def _marked(pg):
    """Even global ids, in the (P, n_local_max) block layout."""
    out = np.zeros((pg.P, pg.n_local_max), bool)
    for p in range(pg.P):
        nl, lo = int(pg.n_local[p]), int(pg.offs[p])
        out[p, :nl] = (np.arange(lo, lo + nl) % 2) == 0
    return out


class _Pair:
    """A reference engine and a port engine of B lanes over one bucket."""

    def __init__(self, bucket, bucket_t, cfg_r, cfg_t, B, chunk):
        self.bucket, self.bucket_t = bucket, bucket_t
        self.cfg_r, self.cfg_t = cfg_r, cfg_t
        self.B, self.chunk = B, chunk
        sparse = cfg_r.needs_sparse_plan
        self.ps = bucket.plan_static if sparse else None
        self.host = [bucket.member_arrays(j, sparse=sparse)
                     for j in range(bucket.B)]
        self.ref = self.port = None
        self.rkeys_r, self.rkeys_t = [None] * B, [None] * B

    def admit(self, b: int, j: int, job_id: int) -> None:
        m = self.bucket.members[j]
        order = R.compute_order(m, R.ordering.INTERNAL_FIRST)
        order = np.asarray(_apply_partial(
            order, self.cfg_r.color,
            _marked(m) if self.cfg_r.color.partial else None))
        ck = jax.random.fold_in(jax.random.key(self.cfg_r.color.seed), job_id)
        rk = jax.random.fold_in(jax.random.key(self.cfg_r.seed), job_id)
        # the reference
        arrs = {k: jnp.asarray(v) for k, v in self.host[j].items()}
        init = R.engine_init_program(P, self.cfg_r, self.ps, arrs)
        carry, cstats = init(arrs, jnp.asarray(order), ck)
        cstats_r = {k: int(np.asarray(v).max())
                    for k, v in jax.device_get(cstats).items()}
        if self.ref is None:
            rep = lambda x: jnp.repeat(x[None], self.B, axis=0)
            stacked = jax.tree.map(rep, carry)
            self.ref = (jax.tree.map(rep, arrs),
                        (stacked[0], jnp.full_like(stacked[1],
                                                   self.cfg_r.n_iters + 1))
                        + tuple(stacked[2:]), jax.tree.map(rep, cstats))
        put = R.engine_put_program(P, self.cfg_r, self.ps, arrs, self.B)
        self.ref = put(self.ref, (arrs, carry, cstats), b)
        self.rkeys_r[b] = rk
        self.rkeys_r = [rk if k is None else k for k in self.rkeys_r]
        # the port
        arrs = arrays_from_numpy(self.host[j], "cpu")
        init = T.engine_init_program(P, self.cfg_t, self.ps, arrs)
        carry, cstats = init(arrs, torch.as_tensor(order),
                             rng.fold_in(rng.key(self.cfg_t.color.seed),
                                         job_id))
        assert cstats == cstats_r
        if self.port is None:
            B = self.B
            self.port = (
                {k: v.repeat((B,) + (1,) * (v.dim() - 1))
                 for k, v in arrs.items()},
                T.RecolorCarry(
                    view=carry.view.repeat(B, 1),
                    it=[self.cfg_t.n_iters + 1] * B, best=carry.best * B,
                    stall=carry.stall * B,
                    hist=np.repeat(carry.hist, B, axis=0),
                    sizes=carry.sizes.repeat(B, 1),
                    n_oor=carry.n_oor.repeat(B)),
                [dict(cstats) for _ in range(B)])
        put = T.engine_put_program(P, self.cfg_t, self.ps, arrs, self.B)
        put(self.port, (arrs, carry, cstats), b)
        self.rkeys_t[b] = rng.fold_in(rng.key(self.cfg_t.seed), job_id)
        self.rkeys_t = [self.rkeys_t[b] if k is None else k
                        for k in self.rkeys_t]

    def step(self):
        arrs_r, carry_r, cstats_r = self.ref
        prog = R.engine_step_program(P, self.cfg_r, self.ps, arrs_r, self.B,
                                     self.chunk)
        carry_r, done_r = prog(arrs_r, carry_r, jnp.stack(self.rkeys_r))
        self.ref = (arrs_r, carry_r, cstats_r)
        arrs_t, carry_t, _ = self.port
        prog = T.engine_step_program(P, self.cfg_t, self.ps, arrs_t, self.B,
                                     self.chunk)
        carry_t, done_t = prog(arrs_t, carry_t, torch.stack(self.rkeys_t))
        done_r = np.asarray(done_r).all(axis=1)
        self.check(done_r, done_t)
        return done_t

    def check(self, done_r, done_t):
        view, it, best, stall, hist, sizes, n_oor = jax.device_get(
            self.ref[1])
        c = self.port[1]
        np.testing.assert_array_equal(
            c.view.numpy(), np.asarray(view).reshape(c.view.shape))
        assert c.it == np.asarray(it)[:, 0].tolist()
        assert c.best == np.asarray(best)[:, 0].tolist()
        assert c.stall == np.asarray(stall)[:, 0].tolist()
        np.testing.assert_array_equal(c.hist, np.asarray(hist).max(axis=1))
        np.testing.assert_array_equal(c.sizes.numpy(),
                                      np.asarray(sizes)[:, 0])
        np.testing.assert_array_equal(c.n_oor.numpy(),
                                      np.asarray(n_oor)[:, 0])
        np.testing.assert_array_equal(done_t, done_r)


def _drive(pool, halo, cfg, *, B=3, chunk=1, n_jobs=6):
    """Admit one job per step into a free lane (graphs taken round-robin
    from the pool) and step both engines until every job drained; every
    drained lane also equals the port's solo ``pipeline_sim``.  Returns
    the (iteration of each running lane) per step, for the caller's
    staggering checks."""
    bucket = _members(R, pool, halo)
    cfg_r, cfg_t = cfg(R), cfg(T)
    pair = _Pair(bucket, _members(T, pool, halo), cfg_r, cfg_t, B, chunk)
    lanes = [None] * B
    queue = list(range(n_jobs))
    stagger, by_lane = [], {}
    while queue or any(ln is not None for ln in lanes):
        free = [b for b, ln in enumerate(lanes) if ln is None]
        if queue and free:
            job = queue.pop(0)
            j = job % bucket.B
            pair.admit(free[0], j, job)
            lanes[free[0]] = (job, j)
            by_lane.setdefault(free[0], []).append(j)
        stagger.append([pair.port[1].it[b] for b, ln in enumerate(lanes)
                        if ln is not None])
        done = pair.step()
        for b, ln in enumerate(lanes):
            if ln is not None and done[b]:
                _check_solo(pair, b, *ln)
                lanes[b] = None
    return stagger, by_lane


def _check_solo(pair, b, job, j):
    """Lane ``b`` == the port's solo ``pipeline_sim`` of its member."""
    m = pair.bucket_t.members[j]
    cfg = pair.cfg_t
    marked = _marked(m) if cfg.color.partial else None
    view, solo = T.pipeline_sim(
        m, T.compute_order(m, T.ordering.INTERNAL_FIRST), cfg,
        marked=marked,
        color_key=rng.fold_in(rng.key(cfg.color.seed), job),
        recolor_key=rng.fold_in(rng.key(cfg.seed), job), device="cpu")
    c = pair.port[1]
    assert torch.equal(c.view[b * P:(b + 1) * P], view)
    assert c.history(b) == solo["history"]
    assert c.it[b] - 1 == solo["n_iters_run"]


@pytest.mark.parametrize("chunk,rand_every", [(1, 2), (2, 3), (3, 2)])
def test_step_d1_nd_rand_staggered(chunk, rand_every):
    """D1, sparse union schedule, ND-RAND%x with patience: lanes at
    different iterations share steps, so RAND and ND lanes rank together
    (x is chosen so that the staggered lanes' kinds differ in a step)."""
    cfg = lambda M: _cfg(M, rand_every=rand_every)
    stagger, by_lane = _drive(_d1_pool, 1, cfg, chunk=chunk)
    kinds = cfg(T).kind_ids
    mixed = [its for its in stagger for k in range(chunk)
             if len({kinds[i + k - 1] for i in its
                     if i + k <= len(kinds)}) > 1]
    assert mixed, stagger             # RAND and ND lanes in one step
    assert any(len(set(js)) > 1 for js in by_lane.values())


def test_step_d1_nd_allgather():
    """D1 under the all-gather exchange, ND, patience 1."""
    _drive(_d1_pool, 1, lambda M: _cfg(M, scheme="allgather", n_iters=4,
                                       patience=1, rand_every=0), chunk=2)


@pytest.mark.parametrize("chunk", [2, 3])
def test_step_d2_nd_rand(chunk):
    """Distance 2 on halo-2 partitions, ND-RAND%2."""
    _drive(_d2_pool, 2, lambda M: _cfg(M, distance=2, n_iters=4),
           chunk=chunk, n_jobs=5)


def test_step_partial_d2():
    """Partial distance 2 (even global ids marked)."""
    _drive(_d2_pool, 2, lambda M: _cfg(M, distance=2, n_iters=3,
                                       partial=True), chunk=1, n_jobs=4)


def test_step_k0():
    """K=0: a lane is done on its first step with an empty history."""
    _drive(_d1_pool, 1, lambda M: _cfg(M, n_iters=0), chunk=1, n_jobs=4)
