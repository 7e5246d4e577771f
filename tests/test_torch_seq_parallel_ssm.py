"""The sequence-parallel residual (``cfg.seq_parallel_acts``) for the
sub-quadratic blocks, as ``tests/test_torch_seq_parallel.py`` holds the
attention and MoE blocks: ``rwkv6-1.6b`` (RWKV-6's token shift and its
chunked recurrence, the channel mix's token shift, all on the whole
sequence after the gather; smoke: 2 heads of 64, split over ``model=2``)
and ``jamba-v0.1-52b`` (Mamba's causal conv and scan on the whole
sequence, its attention and MoE layers) on ``(1, 2)``, against the
reference's one-device step run live with the same override, with
``tests/test_torch_tp_ssm.py``'s harness and tolerances (``TOL``: the
port's own gap to the reference for these two, stated and measured
there), each rank's cache shapes included.
"""
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import world2  # noqa: F401
from test_torch_tp_ssm import check

SP = {"seq_parallel_acts": True}


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_sequence_split_matches_the_reference(world2, name):  # noqa: F811
    check(world2, name, (1, 2), SP)
