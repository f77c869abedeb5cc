"""One full train step of the port against the JAX package's under
``NNDET_IN_STATS=two_pass`` (exact instance-norm statistics), for the
``no_sampler`` head and the ``hnm`` head with the JAX draws injected: the
``plane_sub:8`` case of ``test_torch_trainer.py`` with the other schedule,
in a file of its own so that each file's JAX compiles fit its time."""
import pytest
import torch

from tests.test_torch_trainer import HEADS, check_train_step_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("head", HEADS)
def test_train_step_matches_jax_two_pass(monkeypatch, head):
    check_train_step_matches_jax(monkeypatch, head, "two_pass")
