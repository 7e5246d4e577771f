"""POSITIVE divergent-collective fixtures (virtual core/ path)."""
import torch


def shard_gated_exchange(view: torch.Tensor, comm):
    # the test reads this rank's own coordinate
    if int(comm.index()[0]) == 0:                          # FIRE
        view = comm.psum(view)
    return view


def data_gated_exchange(view: torch.Tensor, exchange):
    # a host read of local data, never reduced
    if bool((view == 0).any()):                            # FIRE
        view, _ = exchange(view)
    return view


def received_gated(view: torch.Tensor, comm, ring):
    got = comm.ppermute(view, ring)
    return comm.pmax(view) if got.sum().item() else view   # FIRE


def skips_the_rest(view: torch.Tensor, comm, n: int):
    for _ in range(n):
        if view.max().item() > 3:                          # FIRE
            continue
        view = comm.psum(view)
    return view


def written_under_a_local_test(view: torch.Tensor, comm):
    due = False
    if view.sum().item() > 0:                # an implicit flow into `due`
        due = True
    if due:                                                # FIRE
        view = comm.pmax(view)
    return view


def local_helper(counts: torch.Tensor):
    return counts.tolist()


def helper_result(view: torch.Tensor, comm):
    flags = local_helper(view.amax(dim=1))
    if any(flags):                                         # FIRE
        comm.wait_lanes()
    return view


def match_on_local(view: torch.Tensor, comm):
    match int(view[0, 0]):                                 # FIRE
        case 0:
            return comm.psum(view)
        case _:
            return view
