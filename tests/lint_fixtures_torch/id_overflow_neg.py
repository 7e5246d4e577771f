"""NEGATIVE id-overflow fixtures: nothing here may fire."""
import numpy as np
import torch


def promoted_long(u, v, n):
    return u.long() * n + v                 # explicit 64-bit promotion


def promoted_to(u, v, n):
    return u.to(torch.int64) * n + v


def promoted_dtype_kw(v, n, m):
    base = torch.arange(m, dtype=torch.int64)
    return base * n + v.long()


def size_by_size(n_local_max, maxd, n):
    return n_local_max * maxd + n           # sizes only, no id operand


def plain_sum(u, v):
    return u + v                            # no multiplicative packing


def policy_packing(u, v, n, pol):
    return u.astype(pol.id_dtype) * n + v   # the id policy picks the width


def policy_cast(u, v, n, id_dtype):
    return (u.long() * n + v).to(id_dtype)  # cast to the policy's dtype


def int32_of_slots(slots, lo):
    return (slots - lo).to(torch.int32)     # no packing in the cast


def numpy_promoted(u, v, n):
    return u.astype(np.int64) * n + v
