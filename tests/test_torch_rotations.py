"""The port's rotation library (``isaacgym_tpu_torch/utils/rotations.py``)
against the JAX package's (``isaacgym_tpu/utils/rotations.py``): every
public function of both on the same seeded numpy batches, within two float32
ulps plus 1e-6 (angle-axis and exp-map inputs kept away from the angle pi,
where the wrap flips the sign), plus the closed-form properties
``tests/test_rotations.py`` checks of the JAX package.
"""

import inspect

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax.numpy as jnp

from isaacgym_tpu.utils import rotations as J
from isaacgym_tpu_torch.utils import rotations as R

N = 64
ULP2 = 2 * np.finfo(np.float32).eps


def _quats(seed, n=N):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(seed, n=N, scale=1.0):
    return (np.random.RandomState(seed).randn(n, 3) * scale).astype(np.float32)


def _away_from_pi(q):
    """Unit quats whose rotation angle is at least 0.2 rad from pi."""
    angle = 2.0 * np.arccos(np.clip(np.abs(q[:, 3]), 0.0, 1.0))
    return q[np.abs(angle - np.pi) > 0.2]


def _rotmats(seed):
    return np.asarray(J.quat_to_rotmat(jnp.asarray(_quats(seed))))


_LO, _HI = np.float32(-2.0), np.float32(6.0)
_U = np.random.RandomState(30).uniform(-1.0, 1.0, (N, 7)).astype(np.float32)
_ANG = np.random.RandomState(31).uniform(-7.0, 7.0, N).astype(np.float32)

# name -> numpy arguments (the same for both packages)
CASES = {
    "quat_unit": lambda: (np.random.RandomState(1).randn(N, 4).astype(np.float32),),
    "quat_from_angle_axis": lambda: (_ANG, _vecs(2)),
    "quat_from_euler_xyz": lambda: tuple(np.random.RandomState(3).uniform(
        -3.0, 3.0, (3, N)).astype(np.float32)),
    "quat_mul": lambda: (_quats(4), _quats(5)),
    "quat_conjugate": lambda: (_quats(6),),
    "quat_rotate": lambda: (_quats(7), _vecs(8)),
    "my_quat_rotate": lambda: (_quats(7), _vecs(8)),
    "quat_rotate_inverse": lambda: (_quats(9), _vecs(10)),
    "quat_apply": lambda: (_quats(11), _vecs(12)),
    "quat_to_rotmat": lambda: (_quats(13),),
    "rotmat_to_quat": lambda: (_rotmats(14),),
    "calc_heading": lambda: (_quats(15),),
    "calc_heading_quat": lambda: (_quats(16),),
    "calc_heading_quat_inv": lambda: (_quats(17),),
    "exp_map_to_quat": lambda: (np.concatenate([_vecs(18, scale=0.9), np.zeros((2, 3), np.float32)]),),
    "quat_to_angle_axis": lambda: (_away_from_pi(_quats(19, 256)),),
    "quat_to_exp_map": lambda: (_away_from_pi(_quats(20, 256)),),
    "quat_to_tan_norm": lambda: (_quats(21),),
    "normalize_angle": lambda: (_ANG,),
    "scale": lambda: (_U, _LO, _HI),
    "unscale": lambda: (np.asarray(J.scale(_U, _LO, _HI)), _LO, _HI),
    "tensor_clamp": lambda: (_U * 3, np.float32(-1.5), np.float32(0.5)),
    "get_euler_xyz": lambda: (_quats(22),),
    "compute_heading_and_up": lambda: (
        _quats(23), np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (N, 1)), _vecs(24),
        np.tile(np.float32([1.0, 0.0, 0.0]), (N, 1)), np.tile(np.float32([0.0, 0.0, 1.0]), (N, 1)),
        2),
    "compute_rot": lambda: (_quats(25), _vecs(26), _vecs(27), _vecs(28, scale=3.0), _vecs(29)),
    "slerp": lambda: (_quats(32), _quats(33),
                      np.random.RandomState(34).uniform(0.0, 1.0, (N, 1)).astype(np.float32)),
}


def _to(x, mod):
    if isinstance(x, np.ndarray):
        return jnp.asarray(x) if mod is J else torch.tensor(x)
    return x


def _flat(out):
    return [out] if not isinstance(out, tuple) else list(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_the_jax_package(name):
    args = CASES[name]()
    want = _flat(getattr(J, name)(*[_to(a, J) for a in args]))
    got = _flat(getattr(R, name)(*[_to(a, R) for a in args]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=ULP2, atol=1e-6,
                                   err_msg=name)


def test_public_surface_is_the_jax_package_s():
    """Every public function of the JAX library has its counterpart but
    ``to_jnp`` (its array constructor; ``torch.as_tensor`` is the port's),
    and the constructors and draws beside CASES agree too."""
    public = lambda m: {n for n, f in vars(m).items()
                        if inspect.isfunction(f) and not n.startswith("_")}
    assert public(J) - public(R) == {"to_jnp"}
    assert public(R) == public(J) - {"to_jnp"}
    # 28 functions, less the aliases my_quat_rotate and torch_rand_float
    assert len({n for n in public(R) if getattr(R, n).__name__ == n}) == 28
    np.testing.assert_array_equal(R.quat_identity((5, 2)).numpy(),
                                  np.asarray(J.quat_identity((5, 2))))
    np.testing.assert_array_equal(R.get_axis_params(0.7, 2, x_value=0.3).numpy(),
                                  np.asarray(J.get_axis_params(0.7, 2, x_value=0.3)))
    assert R.torch_rand_float is R.rand_float and R.my_quat_rotate is R.quat_rotate


def test_rand_float_bounds_and_determinism():
    g = lambda: torch.Generator().manual_seed(7)
    x = R.torch_rand_float(g(), -0.2, 0.2, (64, 7))
    assert x.shape == (64, 7) and x.dtype == torch.float32
    assert float(x.min()) >= -0.2 and float(x.max()) < 0.2
    assert torch.equal(x, R.rand_float(g(), -0.2, 0.2, (64, 7)))
    assert not torch.equal(x, R.rand_float(torch.Generator().manual_seed(8), -0.2, 0.2, (64, 7)))


def test_closed_form_properties():
    """tests/test_rotations.py's checks, on the port."""
    t = torch.as_tensor
    q, v = t(_quats(40, 32)), t(_vecs(41, 32))
    Rm = R.quat_to_rotmat(q)
    torch.testing.assert_close(R.quat_rotate(q, v), torch.einsum("bij,bj->bi", Rm, v),
                               atol=1e-5, rtol=0)
    a, b = t(_quats(42, 16)), t(_quats(43, 16))
    torch.testing.assert_close(R.quat_to_rotmat(a) @ R.quat_to_rotmat(b),
                               R.quat_to_rotmat(R.quat_mul(a, b)), atol=1e-5, rtol=0)
    torch.testing.assert_close(R.quat_rotate(R.quat_conjugate(q), R.quat_rotate(q, v)), v,
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(R.quat_rotate_inverse(q, R.quat_rotate(q, v)), v,
                               atol=1e-5, rtol=0)
    # angle-axis and exp-map round trips (canonical representative, angle < pi)
    angle = t([0.3, 1.2, -2.0, 0.0])
    axis = t([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0, 0, 1.0]])
    a2, ax2 = R.quat_to_angle_axis(R.quat_from_angle_axis(angle, axis))
    torch.testing.assert_close(a2[:, None] * ax2, angle[:, None] * axis, atol=1e-5, rtol=0)
    raw = _vecs(44, 20)
    raw /= np.maximum(np.linalg.norm(raw, axis=-1, keepdims=True), 1e-9)
    em = t(raw * np.random.RandomState(45).uniform(0, 3.0, (20, 1)).astype(np.float32))
    torch.testing.assert_close(R.quat_to_exp_map(R.exp_map_to_quat(em)), em, atol=1e-4, rtol=0)
    # heading: a yaw of pi/2 maps x to y; tilt does not change it
    z = t([0.0, 0.0, 1.0])
    yaw = R.quat_from_angle_axis(t(np.pi / 2), z)
    assert abs(float(R.calc_heading(yaw)) - np.pi / 2) < 1e-5
    x_rot = R.quat_rotate(yaw, t([1.0, 0.0, 0.0]))
    torch.testing.assert_close(R.quat_rotate(R.calc_heading_quat_inv(yaw), x_rot),
                               t([1.0, 0.0, 0.0]), atol=1e-5, rtol=0)
    tilted = R.quat_mul(R.quat_from_angle_axis(t(0.7), z),
                        R.quat_from_angle_axis(t(0.4), t([1.0, 0.0, 0.0])))
    assert abs(float(R.calc_heading(tilted)) - 0.7) < 1e-5
    torch.testing.assert_close(R.quat_from_euler_xyz(t(0.0), t(0.0), t(np.pi / 2)),
                               t([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]).float(),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(R.quat_to_tan_norm(yaw), t([0.0, 1, 0, 0, 0, 1]),
                               atol=1e-6, rtol=0)
    q2 = R.rotmat_to_quat(R.quat_to_rotmat(t(_quats(46))))
    torch.testing.assert_close((q2 * t(_quats(46))).sum(-1).abs(), torch.ones(N),
                               atol=1e-5, rtol=0)
    lo, hi = t(-2.0), t(6.0)
    x = torch.linspace(-1, 1, 11)
    s = R.scale(x, lo, hi)
    assert float(s[0]) == -2.0 and float(s[-1]) == 6.0
    torch.testing.assert_close(R.unscale(s, lo, hi), x, atol=1e-6, rtol=0)
    ends = R.normalize_angle(t([0.0, np.pi + 0.1, -np.pi - 0.1, 4 * np.pi + 0.2]))
    torch.testing.assert_close(ends, t([0.0, -np.pi + 0.1, np.pi - 0.1, 0.2]).float(),
                               atol=1e-5, rtol=0)
    a, b = t(_quats(47, 4)), t(_quats(48, 4))
    torch.testing.assert_close(R.slerp(a, b, 0.0), a, atol=1e-5, rtol=0)
    torch.testing.assert_close((R.slerp(a, b, 1.0) * b).sum(-1).abs(), torch.ones(4),
                               atol=1e-5, rtol=0)
