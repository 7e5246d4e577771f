"""NEGATIVE divergent-collective fixtures (virtual core/ path)."""
import torch

from repro_torch.core.comm import shard_uniform


def reduced_gate(view: torch.Tensor, comm):
    # the test reads a reduction: every rank agrees
    pending = comm.pmax((view == 0).any(dim=1).long())
    if bool(pending.any()):
        view = comm.psum(view)
    return view


def contract_gate(view: torch.Tensor, mask: torch.Tensor, comm):
    # uniform by construction, asserted where it is read
    due = shard_uniform(mask.tolist())
    if due[0]:
        view = comm.psum(view)
    return view


def local_branch_without_collective(view: torch.Tensor, comm):
    # a per-shard test, but nothing collective under it
    if int(comm.index()[0]) == 0:
        view = view + 1
    return comm.psum(view)


def static_config_branch(view: torch.Tensor, cfg: "RecolorConfig", comm):
    if cfg.piggyback:
        view = comm.pmax(view)
    return view


def lane_decision(view: torch.Tensor, active: list, comm):
    if not comm.lane_uniform(any(active)):
        return view
    return comm.psum(view)


def dict_key_test(arrs: dict, comm):
    # which arrays the device dict holds is its structure, not its data
    if "shift_to_round" not in arrs:
        return 0
    return comm.pmax(arrs["shift_to_round"])


def gathered_flags(done: torch.Tensor, comm):
    flags = comm.gather_objects(done.tolist())
    if any(flags):
        comm.wait_lanes()
    return flags
