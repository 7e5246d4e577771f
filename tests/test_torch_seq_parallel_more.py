"""The sequence-parallel residual (``cfg.seq_parallel_acts``) for the MoE
and the encoder-decoder, held as ``tests/test_torch_seq_parallel.py``
holds the dense and MLA blocks, at ``tests/test_torch_tp.py``'s
tolerances: ``moonshot-v1-16b-a3b`` (the router, its top-k and its
load-balance term on every token of the rank's rows after the gather, the
experts and the shared experts split over ``model``) and
``whisper-small`` (the encoder's residual split too, its output gathered
whole for the decoder's cross-attention, in training and in prefill) on
``(1, 2)``.
"""
import pytest

from test_torch_seq_parallel import SP
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import check_split, world2  # noqa: F401


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "whisper-small"])
def test_sequence_split_matches_the_reference(world2, name):  # noqa: F811
    check_split(world2, name, (1, 2), SP)
