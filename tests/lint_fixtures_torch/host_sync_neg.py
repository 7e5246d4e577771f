"""NEGATIVE host-sync fixtures (linted under a virtual kernels/ path)."""
import torch


def static_shapes(view, nbr):
    rows = int(view.shape[0])               # a shape: no read
    width = int(nbr.size(1))
    return torch.zeros((rows, width))


def flags(view, staggered, selection, *, x):
    # host flags and counts passed to a launch: no tensor is read
    return (int(staggered), int(selection == "least_used"), int(x),
            view.data_ptr())


def launch_args(t, first_step: int, n_steps: int):
    return [int(first_step), int(n_steps), t.numel(), len(t.shape)]
