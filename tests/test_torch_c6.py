"""C6 (HumanoidPingpongTiltG1, K2): the port's env step against the JAX
package's, within the C6 gates of ``tools/parity_tpu.py:60-62``; see
``tests/test_torch_c8.py``.
"""

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from tests.test_torch_c8 import C6, check_step_parity, make_pair


@pytest.fixture(scope="module")
def pair():
    return make_pair(C6)


def test_env_step_matches_within_the_parity_gates(pair, monkeypatch):
    check_step_parity(pair, monkeypatch, 80)
