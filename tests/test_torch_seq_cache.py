"""Batch-1 decode over a cache whose slots the plan splits over ``data``
(``models.attention``: each rank holds a block of the ring buffer, the
rank that owns slot ``pos % S`` writes it, the ranks' partial softmax
merged by a max and a sum over ``data``), on gloo worlds ``(2, 1)``,
``(4, 1)`` and ``(2, 2)`` (``data`` x ``model``).

``qwen3-0.6b`` (GQA), ``minicpm3-4b`` (MLA) and ``jamba-v0.1-52b``
(smoke: attention at layers 2 and 6 between Mamba layers) prefill a
prompt of ``PROMPT`` tokens into a cache of ``CACHE`` slots and then
decode ``GEN`` steps fed the reference's greedy tokens, so the writes
wrap the ring buffer, the owning rank changes, and at first some ranks
hold no filled slot.  Held:

- the logits of the prefill and of every step against the reference's
  (``repro.models.model.prefill`` / ``decode_step`` at the same cache
  length, run live on the same parameters) within ``LOGIT_TOL`` of the
  largest logit (``tests/test_torch_tp.py``'s 1.6e-6; ``jamba-v0.1-52b``
  3.9e-6, twice its largest gap, 1.902e-6 on ``(4, 1)``: without the
  sequence split the port's Mamba scan alone measures 1.841e-6), and the
  port's greedy tokens equal to the reference's up to the first
  near-tie;
- the cache, gathered, bitwise equal to the port's run on the same
  ``model`` split without the sequence split (one process; the ``(1, 2)``
  world for ``(2, 2)``) after the prefill, and after the decode in the
  first attention layer (whose new K/V come before any merged softmax);
  every other leaf within ``CACHE_TOL`` of its largest value (the merge
  sums in another order than one softmax, which moves later layers'
  inputs by rounding);
- each rank's cache leaves at the reference's per-rank shapes
  (``plan.spec`` of every dim: the slots split over ``data``).

``CACHE_TOL`` is twice the largest gap measured, rounded up (CPU, gloo,
three architectures, three worlds: 1.525e-6, ``jamba-v0.1-52b`` on
``(4, 1)``).
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_world as W
import torch_mesh_cases as C
from repro.configs import NO_SHARDING as R_NO_SHARDING
from repro.configs.base import ShardingPlan as RPlan
from repro.models import model as RM
from repro.models.layers import ParamDef as RParamDef
from repro_torch.configs import plan_for_mesh
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.serve import serve_inputs
from test_torch_lm_serve import TIE
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import configs, ref_params, rel_err

LOGIT_TOL = {"qwen3-0.6b": 1.6e-6, "minicpm3-4b": 1.6e-6,
             "jamba-v0.1-52b": 3.9e-6}
CACHE_TOL = 3.1e-6
PROMPT, CACHE, GEN, SEED = 6, 16, 14, 0
AXES = ("data", "model")
ARCHS = ["qwen3-0.6b", "minicpm3-4b", "jamba-v0.1-52b"]
WORLDS = [(2, 1), (4, 1), (2, 2)]

_REF: dict = {}
_PLAIN: dict = {}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = W.World(2, tmp_path_factory.mktemp("seq2"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = W.World(4, tmp_path_factory.mktemp("seq4"))
    yield w
    w.close()


def reference(name: str) -> dict:
    """The reference's batch-1 greedy serving of ``name`` (smoke) on its
    own parameters: the prompt, the parameters, the last logits of the
    prefill and every step, the tokens."""
    if name in _REF:
        return _REF[name]
    rcfg, cfg = configs(name)
    p0 = ref_params(rcfg)
    prompt = serve_inputs(cfg, batch=1, prompt_len=PROMPT, seed=SEED,
                          device="cpu")["tokens"].numpy()
    prefill = jax.jit(lambda p, t: RM.prefill(p, {"tokens": t}, rcfg,
                                              R_NO_SHARDING, CACHE))
    step = jax.jit(lambda p, c, t: RM.decode_step(p, c, t, rcfg,
                                                  R_NO_SHARDING))
    cache, lg = prefill(p0, jax.numpy.asarray(prompt))
    logits = [np.asarray(lg[0, -1])]
    toks = []
    for _ in range(GEN):
        toks.append(int(logits[-1].argmax()))
        cache, lg = step(p0, cache, jax.numpy.asarray([[toks[-1]]],
                                                      dtype=np.int32))
        logits.append(np.asarray(lg[0, -1]))
    _REF[name] = dict(p0=p0, prompt=prompt, logits=np.stack(logits),
                      tokens=np.asarray([toks], dtype=np.int32))
    return _REF[name]


def plain(name: str) -> dict:
    """The port's run without a mesh, in this process."""
    if name not in _PLAIN:
        ref = reference(name)
        _PLAIN[name] = C.seq_decode(None, AXES, name, ref["p0"],
                                    ref["prompt"], CACHE, ref["tokens"])
    return _PLAIN[name]


def ref_cache_shapes(name: str, shape) -> dict:
    """Per-rank shapes of the reference's batch-1 cache leaves, by path."""
    rcfg, _ = configs(name)
    spec = MeshSpec(tuple(shape), AXES)
    plan = plan_for_mesh(spec)
    rplan = RPlan(**{k: getattr(plan, k) for k in (
        "batch", "fsdp", "tp", "exp", "seq", "act_seq")},
        mesh_shape=dict(zip(spec.axes, spec.shape)))
    amesh = AbstractMesh(tuple(spec.shape), spec.axes)
    out = {}

    def walk(tree, path):
        if isinstance(tree, RParamDef):
            s = NamedSharding(amesh, P(*rplan.spec(tree.dims, tree.shape)))
            out[path] = tuple(s.shard_shape(tree.shape))
            return
        for k, v in tree.items():
            walk(v, f"{path}/{k}" if path else k)
    walk(RM.cache_defs(rcfg, 1, CACHE), "")
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _first_attention(name: str) -> str:
    """The path prefix of the first run with an attention mixer."""
    _, cfg = configs(name)
    from repro_torch.models.model import layer_runs
    for r, (spec, _) in enumerate(layer_runs(cfg)):
        if spec.mixer in ("gqa", "mla"):
            return f"run{r}/mixer/"
    raise AssertionError(name)


def check_tokens(got_logits, ref: dict) -> None:
    """The port's greedy choice at every step equals the reference's
    tokens up to the first near-tie of the reference's logits."""
    want = ref["tokens"][0]
    for i in range(GEN):
        lg = ref["logits"][i].astype(np.float64)
        top = np.sort(lg)[-2:]
        if (top[1] - top[0]) / np.abs(lg).max() < TIE:
            break
        assert int(got_logits[i].argmax()) == want[i], (i, want)


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_decode_over_a_split_cache(world2, world4, name, shape):
    ref = reference(name)
    world = world2 if np.prod(shape) == 2 else world4
    outs = world.run(C.seq_decode, shape, AXES, name, ref["p0"],
                     ref["prompt"], CACHE, ref["tokens"])
    if shape[1] == 1:
        base = plain(name)
    else:                     # the same model split, no sequence split
        base = world2.run(C.seq_decode, (1, shape[1]), AXES, name,
                          ref["p0"], ref["prompt"], CACHE, ref["tokens"])[0]
    want_shapes = ref_cache_shapes(name, shape)
    first = _first_attention(name)
    gaps = dict(logits=0.0, cache=0.0)
    for got in outs:
        assert {k: tuple(v) for k, v in _flat(got["cache_shapes"]).items()
                } == want_shapes, (name, shape)
        gaps["logits"] = max(gaps["logits"], max(
            rel_err(a, b) for a, b in zip(got["logits"], ref["logits"])))
        check_tokens(got["logits"], ref)
        pre, end = _flat(got["prefill_cache"]), _flat(got["cache"])
        bpre, bend = _flat(base["prefill_cache"]), _flat(base["cache"])
        for k in bpre:
            np.testing.assert_array_equal(pre[k], bpre[k], err_msg=k)
            if k.startswith(first):       # the run's first layer
                np.testing.assert_array_equal(end[k][0], bend[k][0],
                                              err_msg=k)
            gaps["cache"] = max(gaps["cache"], rel_err(end[k], bend[k]))
    plain_gap = max(rel_err(a, b) for a, b in zip(base["logits"],
                                                  ref["logits"]))
    print(f"{name} {shape}: logits {gaps['logits']:.3e} (without the "
          f"sequence split {plain_gap:.3e}), cache after decode "
          f"{gaps['cache']:.3e}")
    assert gaps["logits"] <= LOGIT_TOL[name], (name, shape, gaps)
    assert gaps["cache"] <= CACHE_TOL, (name, shape, gaps)
    seq = [s for k, s in want_shapes.items() if k.endswith(("/k", "/c_kv"))]
    assert seq and all(s[2] == CACHE // shape[0] for s in seq), seq


def test_serve_with_a_batch_of_one_splits_the_cache_over_data(world2):
    """``launch.serve.serve`` of one prompt on ``(2, 1)``: both data ranks
    hold the whole prompt (the plan leaves the batch of one whole) and
    half of the cache's slots; the tokens and the prefill's logits are
    the one-process run's."""
    name = "qwen3-0.6b"
    kw = dict(batch=1, prompt_len=16, gen=8, seed=SEED)
    want_t, want_l = C.serve(None, AXES, name, *kw.values())
    for got_t, got_l in world2.run(C.serve, (2, 1), AXES, name,
                                   *kw.values()):
        assert rel_err(got_l, want_l) <= LOGIT_TOL[name]
        np.testing.assert_array_equal(got_t, want_t)
