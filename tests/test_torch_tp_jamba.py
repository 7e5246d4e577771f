"""``jamba-v0.1-52b``'s split along ``model`` (Mamba's ``di`` channels,
its attention heads and its experts) on the worlds of
``tests/test_torch_tp.py``, with ``tests/test_torch_tp_ssm.py``'s harness
and tolerances (``TOL``, stated and measured there): the reference's
one-device step run live, each rank's cache shapes against the
reference's ``NamedSharding.shard_shape``, and Mamba's ``conv`` cache at
``di / m`` channels a rank.
"""
import numpy as np
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tp import WORLDS, world2, world4  # noqa: F401
from test_torch_tp_ssm import ARCHS, check


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS[1:])
def test_split_matches_the_reference(world2, world4, name,  # noqa: F811
                                     shape):
    want = check(world2 if np.prod(shape) == 2 else world4, name, shape)
    # di 256 over m
    convs = [s for k, s in want.items() if k.endswith("mixer/conv")]
    assert convs and all(s[-1] == 256 // shape[1] for s in convs), convs
