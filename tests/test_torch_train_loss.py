"""The port's training loss and its gradients against the reference's,
first half of the ten architectures (the second half is
``tests/test_torch_train_loss_more.py``; the two files split one
parametrisation so each stays well inside the per-file time).

For each architecture at smoke size: ``loss_fn``'s loss and metrics
within ``LOSS_TOL`` and each gradient leaf within ``GRAD_TOL`` of its own
largest |g| (``tests/test_torch_train_parts.py`` states both), against
``jax.value_and_grad(repro.models.loss_fn)`` on carried parameters and a
batch of the reference's ``host_batch`` (B=2, S=64, with the
architecture's encoder frames or patch embeddings).
"""
import pytest

from repro_torch.configs import list_archs
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train_parts import check_loss_and_grads

ARCHS = list_archs()[:5]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_the_reference(name):
    print(check_loss_and_grads(name))
