"""POSITIVE id-overflow fixtures: every marked line must fire."""
import torch


def packed_edge_key(u, v, n):
    return u * n + v                        # FIRE: int32 ids packed


def grid_vertex_id(ii, jj, cols):
    return ii * cols + jj                   # FIRE: unpromoted 2D packing


def grid3d_vertex_id(ii, jj, kk, ny, nz):
    return ii * ny * nz + jj * nz + kk      # FIRE: nested 3D packing


def cell_key(cid, grid_n):
    return cid[:, 0] * grid_n + cid[:, 1]   # FIRE: subscripted id operands


def promoted_then_demoted(u, v, n):
    return (u.long() * n + v).to(torch.int32)   # FIRE: cast back to int32


def demoted_by_int(src, dst, n_global):
    return (src.to(torch.int64) * n_global + dst).int()  # FIRE: .int()
