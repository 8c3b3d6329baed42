"""C8 with ``twoPlayer`` on (obs 188, both humanoids' rewards and one-shot
flags): the port's env step against the JAX package's, within the C8
gates of ``tools/parity_tpu.py:63-65``; see ``tests/test_torch_c8.py``.
"""

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from tests.test_torch_c8 import C8, check_step_parity, make_pair


@pytest.fixture(scope="module")
def pair():
    return make_pair(C8, twoPlayer=True)


def test_env_step_matches_within_the_parity_gates(pair, monkeypatch):
    check_step_parity(pair, monkeypatch, 188)
