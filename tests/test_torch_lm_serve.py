"""The port's LM serving (``repro_torch.launch.serve``) against the
reference's ``repro.launch.serve.serve`` with the same parameters (the
reference's own serving initialiser, carried across) and the same seed.

Greedy tokens must be equal up to each row's first near-tie: the first step
at which the top two logits of that row lie within ``TIE`` of each other
(twice the logit tolerance of ``test_torch_lm_models.py``, 1e-5 of the
logits' scale, since each side may move by it).  The test finds those steps
itself, by replaying the reference's tokens through the port's prefill and
decode and reading the margins; it does not choose seeds that avoid ties.
Past a near-tie the two may pick different tokens and then diverge.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.configs import plan_for_mesh as r_plan_for_mesh
from repro.configs import smoke_of as r_smoke_of
from repro.launch import serve as RS
from repro.launch.mesh import make_local_mesh
from repro.models import param_defs as r_param_defs
from repro.models.layers import ParamDef as RParamDef
from repro.train.trainer import init_params_sharded
from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.launch import serve as PS
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import decode_step, params_from_numpy, prefill
from test_torch_threads import one_torch_thread  # noqa: F401

TIE = 2e-5


def ref_serve(name: str, batch: int, prompt_len: int, gen: int, seed: int):
    """The reference's serve with its own parameters; returns (tokens,
    the parameters as numpy)."""
    arch = r_smoke_of(r_get_arch(name))
    mesh = make_local_mesh()
    plan = r_plan_for_mesh(mesh)
    pdefs = r_param_defs(arch)
    specs = jax.tree.map(lambda d: plan.spec(d.dims, d.shape), pdefs,
                         is_leaf=lambda t: isinstance(t, RParamDef))
    params = init_params_sharded(pdefs, mesh, specs, seed)
    tokens, _ = RS.serve(arch, mesh, plan, batch=batch, prompt_len=prompt_len,
                         gen=gen, seed=seed, params=params)
    return np.asarray(tokens), jax.tree.map(np.asarray, params)


def margins(arch, params, tokens: np.ndarray, *, batch: int, prompt_len: int,
            seed: int) -> np.ndarray:
    """(batch, gen) top-two logit margins, over the logits' scale, of the
    port's prefill and decode fed the given greedy tokens."""
    plan = plan_for_mesh(MeshSpec.local())
    inputs = PS.serve_inputs(arch, batch=batch, prompt_len=prompt_len,
                             seed=seed, device="cpu")
    cache, logits = prefill(params, inputs, arch, plan, prompt_len)
    out = []
    for i in range(tokens.shape[1]):
        lg = logits[:, -1].double()
        top = torch.topk(lg, 2, dim=-1).values
        out.append(((top[:, 0] - top[:, 1]) / lg.abs().amax(-1)).numpy())
        if i + 1 < tokens.shape[1]:
            tok = torch.from_numpy(tokens[:, i:i + 1].copy())
            cache, logits = decode_step(params, cache, tok, arch, plan)
    return np.stack(out, axis=1)


def check_tokens(got: np.ndarray, want: np.ndarray, margin: np.ndarray):
    """Equal up to each row's first near-tie (equal everywhere if none)."""
    assert got.shape == want.shape
    for b in range(want.shape[0]):
        ties = np.flatnonzero(margin[b] < TIE)
        upto = int(ties[0]) + 1 if ties.size else want.shape[1]
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto],
                                      err_msg=f"row {b} (first near-tie at "
                                              f"step {upto - 1})")


@pytest.mark.parametrize("name,batch,prompt_len,gen", [
    # the reference example's two calls (examples/serve_decode.py)
    ("qwen3-0.6b", 4, 64, 24), ("minicpm3-4b", 2, 32, 8)])
def test_serve_matches_the_reference(name, batch, prompt_len, gen):
    want, rp = ref_serve(name, batch, prompt_len, gen, seed=0)
    arch = smoke_of(get_arch(name))
    params = params_from_numpy(rp, "cpu")
    mesh = MeshSpec.local()
    got, stats = PS.serve(arch, mesh, plan_for_mesh(mesh), batch=batch,
                          prompt_len=prompt_len, gen=gen, seed=0,
                          params=params, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (batch, gen)
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    check_tokens(got.numpy(), want, margins(
        arch, params, want, batch=batch, prompt_len=prompt_len, seed=0))


@pytest.mark.parametrize("name", r_list_archs())
def test_every_architecture_serves_as_the_reference(name):
    """Every architecture, a short serve whose decode wraps the ring buffer
    (gen > prompt_len), seed 1."""
    batch, prompt_len, gen = 2, 8, 10
    want, rp = ref_serve(name, batch, prompt_len, gen, seed=1)
    arch = smoke_of(get_arch(name))
    params = params_from_numpy(rp, "cpu")
    got, _ = PS.serve(arch, None, plan_for_mesh(MeshSpec.local()),
                      batch=batch, prompt_len=prompt_len, gen=gen, seed=1,
                      params=params, device="cpu")
    check_tokens(got.numpy(), want, margins(
        arch, params, want, batch=batch, prompt_len=prompt_len, seed=1))


def test_the_same_inputs_as_the_reference():
    """serve_inputs draws what the reference's serve draws for a seed."""
    for name in ("whisper-small", "qwen2-vl-72b"):
        arch = smoke_of(get_arch(name))
        got = PS.serve_inputs(arch, batch=3, prompt_len=16, seed=5,
                              device="cpu")
        rng = np.random.default_rng(5)
        want = {"tokens": rng.integers(0, arch.vocab_size, (3, 16))}
        if arch.enc_dec:
            want["enc_embeds"] = rng.normal(0, 1, (3, arch.enc_len,
                                                   arch.d_model))
        if arch.n_patches:
            want["patch_embeds"] = rng.normal(0, 0.02, (3, arch.n_patches,
                                                        arch.d_model))
            want["pos3"] = np.broadcast_to(np.arange(16)[None, None],
                                           (3, 3, 16))
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(
                got[k].numpy(), v.astype(got[k].numpy().dtype), err_msg=k)


def test_own_weights_are_seeded():
    """Without ``params`` the port draws its weights from the seed: the
    same seed serves the same tokens."""
    arch = smoke_of(get_arch("gemma-2b"))
    plan = plan_for_mesh(MeshSpec.local())
    a, _ = PS.serve(arch, None, plan, batch=2, prompt_len=8, gen=4, seed=3,
                    device="cpu")
    b, _ = PS.serve(arch, None, plan, batch=2, prompt_len=8, gen=4, seed=3,
                    device="cpu")
    assert torch.equal(a, b)


def test_main_smoke_cli(capsys):
    tokens, stats = PS.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "16",
                             "--gen", "5"])
    out = capsys.readouterr().out
    assert "generated shape: (2, 5)" in out
    assert tokens.shape == (2, 5) and stats["tok_per_s"] > 0


def test_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.serve(smoke_of(get_arch("qwen3-0.6b")), None,
                 plan_for_mesh(MeshSpec.local()), batch=1, prompt_len=4,
                 gen=2)
