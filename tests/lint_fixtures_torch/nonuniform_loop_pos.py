"""POSITIVE nonuniform-loop fixtures (virtual core/ path)."""
import torch


def local_trip_count(view: torch.Tensor, comm):
    for _ in range(int(view.sum())):                       # FIRE
        view = comm.psum(view)
    return view


def local_while(view: torch.Tensor, exchange):
    while (view == 0).any().item():                        # FIRE
        view, _ = exchange(view)
        view = view + 1
    return view


def local_break(view: torch.Tensor, comm):
    while True:                                            # FIRE
        n_conf = int((view < 0).sum())    # this rank's count, not reduced
        if n_conf == 0:
            break
        view = comm.pmax(view)
    return view


def local_list(view: torch.Tensor, comm):
    todo = [r for r in range(view.shape[0]) if view[r].any().item()]
    for r in todo:                                         # FIRE
        comm.all_gather(view[r])
    return view


def local_rounds(view: torch.Tensor, comm):
    return [comm.psum(view) for _ in range(view.max().item())]  # FIRE
