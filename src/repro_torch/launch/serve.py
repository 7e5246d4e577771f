"""Batched serving: prefill a prompt batch, then greedy-decode (the
port of ``repro.launch.serve``).

CPU-scale:  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \
                --device cpu --batch 4 --prompt-len 64 --gen 32

The prompt tokens (and whisper's encoder frames, qwen2-vl's patch
embeddings) are drawn from ``np.random.default_rng(seed)`` as the reference
draws them, so one seed gives both packages the same inputs.  The weights
are drawn on the device from a ``torch.Generator`` seeded with ``seed``
unless the caller passes ``params``.  The cache holds ``prompt_len`` slots
(the reference's choice), so each decode step overwrites slot
``pos % prompt_len`` of the ring buffer.  Greedy tokens are the argmax over
the padded vocabulary, ties to the lowest id.

On a built ``DeviceMesh`` each rank keeps its shards of the weights (drawn
leaf by leaf from the same generator, so the gathered weights are the
one-device weights), its rows of the prompt batch and its block of the
caches under the plan; the layers gather their weights as they run
(``parallel.shard``), and the generated tokens are gathered over the batch
ranks.  A batch the plan does not split over ``data`` (batch 1 on a mesh
with ``data`` > 1) is whole on every data rank, and the attention caches'
slots are split over ``data`` instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.data.pipeline import batch_spec, mesh_device
from repro_torch.launch.mesh import MeshSpec
from repro_torch.parallel.shard import (as_rank_mesh, batch_rows, set_mesh,
                                      shard_of, unshard)
from repro_torch.models import decode_step, init_params, param_defs, prefill
from repro_torch.models.layers import flatten, specs_of


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_inputs(arch, *, batch: int, prompt_len: int, seed: int,
                 device) -> dict:
    """The prompt batch of ``seed``: numpy draws in the reference's order."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, arch.vocab_size, (batch, prompt_len)).astype(np.int32))}
    if arch.enc_dec:
        out["enc_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (batch, arch.enc_len, arch.d_model)).astype(np.float32))
    if arch.n_patches:
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            0, 0.02, (batch, arch.n_patches, arch.d_model)).astype(
                np.float32))
        out["pos3"] = torch.arange(prompt_len, dtype=torch.int32)[
            None, None].expand(3, batch, prompt_len)
    return {k: v.to(device) for k, v in out.items()}


def init_params_placed(arch, plan, seed: int, mesh=None, device=None):
    """The serving weights of ``seed`` (one generator, sorted leaf order):
    whole on a ``MeshSpec``'s or no mesh's device, this rank's shards on a
    built ``DeviceMesh``."""
    device = mesh_device(mesh, device)
    rm = as_rank_mesh(mesh)
    defs = param_defs(arch)
    place = None
    if rm is not None:
        specs = flatten(specs_of(defs, plan))

        def place(name, t):
            return shard_of(t, specs[name], rm)
    gen_ = torch.Generator(device=device).manual_seed(seed)
    return init_params(defs, gen_, device, place=place)


def serve(arch, mesh, plan, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, params=None, device=None):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen - 1`` more greedy tokens.  Returns (tokens (batch, gen) int32,
    stats: prefill_s, decode_s, tok_per_s).  Runs on CUDA unless
    ``device`` says otherwise (raises when CUDA is missing).  ``mesh`` is
    the mesh the plan was made for: a ``MeshSpec`` (one device, whole
    weights) or a built ``DeviceMesh`` (``params``, if given, are this
    rank's shards; the tokens come back whole on every rank)."""
    device = mesh_device(mesh, device)
    rm = as_rank_mesh(mesh)
    if params is None:
        params = init_params_placed(arch, plan, seed, mesh, device)
    batch_in = {k: batch_rows(v, batch_spec(k, v.shape, plan), rm)
                for k, v in serve_inputs(arch, batch=batch,
                                         prompt_len=prompt_len, seed=seed,
                                         device=device).items()}

    with set_mesh(rm):
        t0 = time.perf_counter()
        cache, logits = prefill(params, batch_in, arch, plan, prompt_len,
                                batch)
        # whole logits on every rank (gathered over a split vocabulary):
        # argmax takes the lowest index among equal values, as ever
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            cache, logits = decode_step(params, cache, tok, arch, plan,
                                        global_batch=batch,
                                        cache_len=prompt_len)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    if rm is not None:
        tokens = unshard(tokens, batch_spec("tokens", (batch, gen), plan), rm)
    return tokens, dict(
        prefill_s=t_prefill, decode_s=t_decode,
        tok_per_s=batch * (gen - 1) / max(t_decode, 1e-9))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the CPU)")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_of(arch)
    mesh = MeshSpec.local()
    plan = plan_for_mesh(mesh)
    tokens, stats = serve(arch, mesh, plan, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          device=args.device)
    print("generated shape:", tuple(tokens.shape))
    print({k: round(v, 4) for k, v in stats.items()})
    return tokens, stats


if __name__ == "__main__":
    main()
