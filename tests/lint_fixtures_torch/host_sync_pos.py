"""POSITIVE host-sync fixtures (linted under a virtual kernels/ path)."""
import torch


def leaky_wrapper(view, active):
    n = int(active.sum())                   # FIRE: tensor -> python int
    rows = view[:n].tolist()                # FIRE: device -> host list
    return rows


def reads_back(out, flags):
    if flags.any().item():                  # FIRE: .item()
        out = out.cpu()                     # FIRE: .cpu()
    return out


def numpy_copy(colors: torch.Tensor):
    return colors.numpy()                   # FIRE: .numpy()


def truth_of_a_tensor(t):
    return bool(t.max() > 0)                # FIRE: bool(tensor)
