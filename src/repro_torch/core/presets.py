"""The paper's two recommended parameter sets (§4.3, §5).

  "speed"   — FIxxND0: First Fit, Internal-First ordering, no recoloring.
  "quality" — R(5–10)IxxND1: Random-X Fit (X=5..10), Internal-First ordering,
              one (or more) ND recoloring iterations.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops

from . import ordering
from .pipeline import PipelineConfig, pipeline_sim
from .recolor import ND, RecolorConfig
from .speculative import ColorConfig, color_graph_sim


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    ordering: str
    color_cfg: ColorConfig
    recolor_iters: int
    recolor_perm: str = ND


def speed(max_colors: int = 1024, superstep: int = 512) -> Preset:
    return Preset(
        name="speed", ordering=ordering.INTERNAL_FIRST,
        color_cfg=ColorConfig(max_colors=max_colors, superstep=superstep,
                              selection=ops.FIRST_FIT),
        recolor_iters=0,
    )


def quality(x: int = 10, max_colors: int = 1024, superstep: int = 512,
            iters: int = 1) -> Preset:
    return Preset(
        name="quality", ordering=ordering.INTERNAL_FIRST,
        color_cfg=ColorConfig(max_colors=max_colors, superstep=superstep,
                              selection=ops.RANDOM_X, random_x=x),
        recolor_iters=iters,
    )


def pipeline_config(preset: Preset, *, n_iters: int | None = None,
                    patience: int = 0, seed: int = 0) -> PipelineConfig:
    """A preset as one pipeline config (``pipeline_sim``-ready).

    ``n_iters`` overrides the preset's recoloring budget (``patience`` adds
    the adaptive stop on top).
    """
    return PipelineConfig(
        color=dataclasses.replace(preset.color_cfg, seed=seed),
        recolor=RecolorConfig(max_colors=preset.color_cfg.max_colors,
                              seed=seed),
        n_iters=preset.recolor_iters if n_iters is None else n_iters,
        base_perm=preset.recolor_perm, patience=patience, seed=seed)


def run_preset(pg, preset: Preset, seed: int = 0, *, device=None):
    """Initial coloring + recoloring per the preset; returns (view, log).

    ``log`` is one dict per stage: ``stage="initial"`` with the coloring
    stats, then one ``stage="recolor"`` entry per executed iteration.
    """
    order = ordering.compute_order(pg, preset.ordering)
    if not preset.recolor_iters:
        cfg = dataclasses.replace(preset.color_cfg, seed=seed)
        view, stats = color_graph_sim(pg, order, cfg, device=device)
        return view, [dict(stage="initial", **stats)]
    view, res = pipeline_sim(pg, order, pipeline_config(preset, seed=seed),
                             device=device)
    log = [dict(stage="initial", **res["color"])]
    log += [dict(stage="recolor", **h) for h in res["history"]]
    return view, log
