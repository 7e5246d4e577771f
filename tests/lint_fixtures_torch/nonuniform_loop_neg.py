"""NEGATIVE nonuniform-loop fixtures (virtual core/ path)."""
import torch


def static_schedule(view: torch.Tensor, comm, shifts: tuple):
    for k in shifts:                         # a static round schedule
        view = comm.psum(view + k)
    return view


def reduced_break(view: torch.Tensor, comm):
    while True:
        n_conf = int(comm.psum((view < 0).sum(dim=1)).sum())  # reduced
        if n_conf == 0:
            break
        view = comm.pmax(view)
    return view


def reduced_bound(view: torch.Tensor, comm):
    n_steps = int(comm.pmax(view.amax(dim=1)).max())
    for _ in range(n_steps):
        view = comm.psum(view)
    return view


def local_loop_without_collective(view: torch.Tensor, comm):
    for _ in range(int(view.sum())):         # per-shard, but no collective
        view = view - 1
    return comm.psum(view)


def lane_uniform_loop(view: torch.Tensor, comm, active: list):
    while comm.lane_uniform(any(active)):
        view = comm.psum(view)
        active = [False]
    return view


def rows_of_a_tensor(view: torch.Tensor, comm):
    for row in view:                         # a tensor's length is its shape
        comm.all_gather(row)
    return view
