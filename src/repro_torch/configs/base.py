"""Architecture configs + sharding plan (the port of ``repro.configs.base``).

Every assigned architecture is an ``ArchConfig``; the distribution strategy is
a ``ShardingPlan`` mapping *logical* axes to mesh axes:

  logical axis   meaning                          production mapping
  ------------   -------------------------------  -------------------------
  "batch"        activation batch dim (DP)        ("pod", "data")
  "fsdp"         weight d_model-ish dim (FSDP)    ("pod", "data")
  "tp"           weight hidden/head dim (TP)      ("model",)
  "exp"          MoE expert dim (EP)              ("model",)
  "seq"          KV/state sequence dim (SP)       ("data",)

Non-divisible dims fall back gracefully: axes are dropped right-to-left until
the dim divides.  ``ShardingPlan.spec`` returns a plain tuple with one entry
per dim (``None``, one mesh axis name, or a tuple of names): the entries of
the reference's ``PartitionSpec``.  The port's serving path runs on one
device, where every spec is all ``None`` and placement is a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

# --------------------------------------------------------------------------
# Sharding plan


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Logical-axis -> mesh-axes mapping (tuple entries = combined axes)."""

    batch: tuple[str, ...] = ()
    fsdp: tuple[str, ...] = ()
    tp: tuple[str, ...] = ()
    exp: tuple[str, ...] = ()
    seq: tuple[str, ...] = ()
    act_seq: tuple[str, ...] = ()  # Megatron-SP: residual S dim over "model"
    mesh_shape: dict[str, int] = dataclasses.field(default_factory=dict)

    def _axes(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return getattr(self, logical)

    def _size(self, axes: tuple[str, ...]) -> int:
        return int(np.prod([self.mesh_shape.get(a, 1) for a in axes],
                           initial=1))

    def spec(self, dims: tuple[str | None, ...],
             shape: tuple[int, ...] | None = None) -> tuple:
        """Mesh axes per dim for logical ``dims``.

        Drops mesh axes that do not divide the dim (right-to-left) and never
        reuses a mesh axis across dims (first logical dim wins) — e.g. decode
        shapes shard batch over "data" and then leave the KV sequence dim
        replicated, while long-context (batch=1) shards the sequence instead.
        """
        entries: list[Any] = []
        used: set[str] = set()
        for i, d in enumerate(dims):
            axes = tuple(a for a in self._axes(d) if a not in used)
            if shape is not None:
                while axes and shape[i] % self._size(axes) != 0:
                    axes = axes[:-1]
            used.update(axes)
            if len(axes) == 0:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        return tuple(entries)


def _mesh_geometry(mesh) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Axis names and sizes of a ``MeshSpec`` or a ``DeviceMesh``."""
    if hasattr(mesh, "axes"):                       # launch.mesh.MeshSpec
        return tuple(mesh.axes), tuple(int(s) for s in mesh.shape)
    return (tuple(mesh.mesh_dim_names),             # a built DeviceMesh
            tuple(int(s) for s in mesh.mesh.shape))


def plan_for_mesh(mesh) -> ShardingPlan:
    """Production plan from a mesh with axes ("pod",)? ("data", "model")."""
    names, sizes = _mesh_geometry(mesh)
    shape = dict(zip(names, sizes))
    dp = tuple(a for a in names if a in ("pod", "data"))
    tp = ("model",) if "model" in names else ()
    return ShardingPlan(batch=dp, fsdp=dp, tp=tp, exp=tp,
                        seq=("data",) if "data" in names else (),
                        act_seq=tp, mesh_shape=shape)


NO_SHARDING = ShardingPlan()


# --------------------------------------------------------------------------
# Architecture config


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact values from the assignment table)."""

    name: str
    family: str                   # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention flavour
    attn_kind: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    m_rope: bool = False          # qwen2-vl M-RoPE (3 position streams)
    # MLA dims (deepseek-v3 / minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # FFN flavour
    ffn_kind: str = "swiglu"      # swiglu | geglu | rwkv | mlp
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0             # expert hidden dim (d_ff used for dense FFN)
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_kind: str = ""            # rwkv6 | mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    attn_every: int = 0           # jamba: one attn layer per `attn_every`
    moe_every: int = 0            # jamba: MoE FFN every `moe_every` layers
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500
    # multimodal stub
    n_patches: int = 0            # qwen2-vl: patch embeddings prepended
    # numerics / training
    scale_embed: bool = False     # gemma: embed * sqrt(d_model)
    # Megatron-style SP for the residual stream (training only; an opt-in
    # knob kept for parity with the reference's configs)
    seq_parallel_acts: bool = False
    grad_accum: int = 1           # microbatches per step (activation memory)
    opt_state_dtype: str = "float32"  # bf16 halves optimizer memory
    params_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    # bookkeeping
    sub_quadratic: bool = False   # may run long_500k
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def vocab_padded(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def _flat_defs(self) -> dict[str, Any]:
        from repro_torch.models.layers import flatten
        from repro_torch.models.model import param_defs  # no import cycle
        return flatten(param_defs(self))

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND."""
        return int(sum(np.prod(d.shape) for d in self._flat_defs().values()))

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        total = 0
        for name, d in self._flat_defs().items():
            sz = int(np.prod(d.shape))
            if "/experts/" in name:
                sz = sz * self.n_experts_per_tok // max(self.n_experts, 1)
            total += sz
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs; reason when skipped."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "O(S^2) full attention at 512k — skipped per assignment"
    return True, ""


_REGISTRY: dict[str, Any] = {}


def register(cfg_fn):
    _REGISTRY[cfg_fn.__name__.replace("_cfg", "")] = cfg_fn
    return cfg_fn


def get_arch(name: str, **overrides) -> ArchConfig:
    """Resolve an architecture by assignment id (e.g. 'qwen3-0.6b')."""
    from repro_torch import configs  # noqa: F401  (registers the archs)
    key = name.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[key]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> list[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
