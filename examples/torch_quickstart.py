"""Quickstart on the PyTorch/CUDA port: graph coloring with recoloring.

Colors an RMAT graph on 8 shards of one device with the paper's "quality"
preset — Random-X Fit seeding + ND recoloring — through ``pipeline_sim``:
the speculative coloring, then up to 5 recoloring iterations with an
adaptive stop, the kernels on the card (``--device cpu``: their plain
PyTorch versions).  The same steps as ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import (check_coloring, colors_from_views,
                              compute_order, partition_graph, pipeline_sim,
                              presets, rmat)


def main(device=None, scale: int = 14, P: int = 8, n_iters: int = 5,
         patience: int = 2) -> dict:
    # 1. a graph (power-law degrees) partitioned over P shards
    g = rmat.rmat_good(scale, 8, seed=1)
    pg = partition_graph(g, P)
    print(f"graph: |V|={g.n:,} |E|={g.m:,} maxdeg={g.max_degree}")

    # 2. the paper's "quality" parameter set (§4.3): Random-X Fit,
    #    Internal-First ordering, ND recoloring, as one pipeline config
    preset = presets.quality(x=10)
    cfg = presets.pipeline_config(preset, n_iters=n_iters, patience=patience)
    order = compute_order(pg, preset.ordering)

    # 3. speculative coloring + up to n_iters recoloring iterations
    #    (adaptive stop after `patience` non-improving ones)
    view, res = pipeline_sim(pg, order, cfg, device=device)
    print(f"initial: {res['color']['n_colors_distinct']} colors in "
          f"{res['color']['n_rounds']} rounds "
          f"({res['color']['n_exchanges']} boundary exchanges)")
    for h in res["history"]:
        print(f"  RC iter {h['iteration']} ({h['perm']}): "
              f"{h['n_colors_distinct']} colors, "
              f"{h['n_exchanges']}/{h['n_steps']} exchanges executed")

    colors = colors_from_views(pg, view.cpu().numpy())
    final = check_coloring(g, colors)
    print(f"final: {final['n_colors']} colors after {res['n_iters_run']} "
          f"iterations, valid={final['valid']}")
    return dict(colors=colors, result=res, check=final)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default CUDA; 'cpu' runs the plain kernels")
    main(device=ap.parse_args().device)
