"""Architecture configs (one per assigned architecture) + sharding plans
(the port of ``repro.configs``)."""
from . import archs  # noqa: F401  — populates the registry
from .archs import smoke_of
from .base import (NO_SHARDING, SHAPES, ArchConfig, ShapeConfig, ShardingPlan,
                   get_arch, list_archs, plan_for_mesh, shape_applicable)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "ShardingPlan", "get_arch",
           "list_archs", "plan_for_mesh", "shape_applicable", "smoke_of",
           "NO_SHARDING"]
