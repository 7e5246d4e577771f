"""Batched serving on the PyTorch/CUDA port: prefill a prompt batch, then
greedy-decode against KV caches.

Serves the reduced qwen3 config (``smoke_of``), then the reduced minicpm3,
whose MLA decode runs against the compressed latent cache (absorbed form).
The same steps as ``examples/serve_decode.py``, on the card by default.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.serve import serve


def main(device=None) -> dict:
    mesh = MeshSpec.local()
    plan = plan_for_mesh(mesh)
    arch = smoke_of(get_arch("qwen3-0.6b"))
    tokens, stats = serve(arch, mesh, plan, batch=4, prompt_len=64, gen=24,
                          device=device)
    print("generated:", tuple(tokens.shape), "first row:",
          tokens[0][:10].tolist())
    print(f"prefill {stats['prefill_s'] * 1e3:.0f} ms, "
          f"decode {stats['decode_s'] * 1e3:.0f} ms "
          f"({stats['tok_per_s']:.1f} tok/s on {tokens.device})")

    # MLA architecture: decode runs against the compressed latent cache
    arch2 = smoke_of(get_arch("minicpm3-4b"))
    tokens2, stats2 = serve(arch2, mesh, plan, batch=2, prompt_len=32, gen=8,
                            device=device)
    print(f"minicpm3 (MLA absorbed decode): {tuple(tokens2.shape)}, "
          f"{stats2['tok_per_s']:.1f} tok/s")
    return {"qwen3": (tokens, stats), "minicpm3": (tokens2, stats2)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default CUDA; 'cpu' runs on the CPU")
    main(device=ap.parse_args().device)
