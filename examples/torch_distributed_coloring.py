"""The paper's "speed" vs "quality" presets (§4.3) on the PyTorch/CUDA
port, and the sharded path on a ``torch.distributed`` world.

- "speed"  : First Fit + Internal-First ordering, no recoloring
- "quality": Random-10 Fit + Internal-First + 1 ND recoloring iteration

Both run with all shards on one device.  Under ``torchrun`` (one process
per GPU, NCCL; gloo with ``--device cpu``) the script also colors the
graph with one shard per rank (``color_graph_sharded`` on
``MeshSpec.worker(N)``); without a world it prints how to start one.
The same steps as ``examples/distributed_coloring.py``.

Run:  PYTHONPATH=src python examples/torch_distributed_coloring.py
      PYTHONPATH=src torchrun --nproc-per-node=4 \\
          examples/torch_distributed_coloring.py [--device cpu]
"""
import argparse
import os
import time

from repro_torch.core import (ColorConfig, check_coloring, color_graph_sharded,
                              colors_from_views, compute_order, ordering,
                              partition_graph, presets, rmat)


def sharded(g, device) -> tuple:
    """``color_graph_sharded`` with one shard per rank of the world (joined
    here unless the caller has): ``(view, stats)``, the same on every
    rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import MeshSpec, init_world
    cpu = device is not None and str(device) == "cpu"
    if not dist.is_initialized():
        init_world("gloo" if cpu else None)
    n = dist.get_world_size()
    pg = partition_graph(g, n)
    mesh = MeshSpec.worker(n).build("cpu" if cpu else None)
    order = compute_order(pg, ordering.INTERNAL_FIRST)
    view, stats = color_graph_sharded(
        pg, order, ColorConfig(max_colors=1024, superstep=512), mesh)
    colors = colors_from_views(pg, view.cpu().numpy())
    if dist.get_rank() == 0:
        print(f"\ncolor_graph_sharded over {n} rank(s): {stats['n_colors']} "
              f"colors, valid={check_coloring(g, colors)['valid']}")
    return colors, stats


def main(device=None, scale: int = 14, P: int = 8) -> dict:
    g = rmat.rmat_er(scale, 8, seed=1)
    pg = partition_graph(g, P)
    print(f"graph: |V|={g.n:,} |E|={g.m:,} maxdeg={g.max_degree}, P={P}\n")
    out = {}
    for preset in (presets.speed(), presets.quality(x=10)):
        t0 = time.time()
        view, log = presets.run_preset(pg, preset, device=device)
        dt = time.time() - t0
        colors = colors_from_views(pg, view.cpu().numpy())
        st = check_coloring(g, colors)
        print(f"preset={preset.name!r:10s} -> {st['n_colors']:3d} colors, "
              f"valid={st['valid']}, {dt:.2f}s")
        for entry in log:
            entry = dict(entry)
            stage = entry.pop("stage")
            print(f"   {stage}: "
                  f"{ {k: v for k, v in entry.items() if isinstance(v, (int, str))} }")
        out[preset.name] = (colors, log)

    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        out["sharded"] = sharded(g, device)
    else:
        print("\n(no torch.distributed world — rerun under torchrun "
              "--nproc-per-node=N for the sharded path; add --device cpu "
              "for gloo ranks on the CPU)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default CUDA; 'cpu' runs the plain kernels")
    main(device=ap.parse_args().device)
