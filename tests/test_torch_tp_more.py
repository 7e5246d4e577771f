"""The compute split along ``model`` for the MoE and the encoder-decoder:
``moonshot-v1-16b-a3b`` (8 smoke experts split over ``model``, the
shared experts' hidden columns split like the MLP, the router whole) and
``whisper-small`` (the encoder's and the decoder's heads, the
cross-attention's K/V of the encoder, a cache of every KV head), on the
worlds of ``tests/test_torch_tp.py`` and held to the reference within
its tolerances (stated and measured there).
"""
import numpy as np
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import WORLDS, check_split, world2, world4  # noqa: F401


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "whisper-small"])
def test_split_matches_the_reference(world2, world4, name, shape):  # noqa: F811
    check_split(world2 if np.prod(shape) == 2 else world4, name, shape)
