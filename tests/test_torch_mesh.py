"""The port's device mesh and collectives (``repro_torch.launch.mesh``):
the collectives against numpy permutations and sums, their gradients
(each the transpose JAX gives), the axis helpers against
``repro.launch.mesh``'s, and the constructors' refusals on a host with no
card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

CPU = torch.device("cpu")


def _xs(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    return arrs, [torch.from_numpy(a.copy()) for a in arrs]


def test_mesh_shape_and_groups():
    mesh = M.make_debug_mesh((2, 4), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.group("model", (1, 2)) == [(1, 0), (1, 1), (1, 2), (1, 3)]
    assert mesh.group("data", (1, 2)) == [(0, 2), (1, 2)]
    assert mesh.group(("data", "model")) == list(np.ndindex(2, 4))
    assert mesh.along("model") == [CPU] * 4
    with pytest.raises(ValueError, match="no axis"):
        mesh.group("pod")
    with pytest.raises(ValueError, match="needs 8 devices"):
        M.make_mesh((2, 4), ("data", "model"), ["cpu"] * 7)
    with pytest.raises(ValueError, match="repeated"):
        M.Mesh(np.empty((1, 1), object), ("a", "a"))


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model"), ("model",)])
def test_axis_helpers_match_jax(axes):
    shape = (2,) * len(axes)
    mesh = M.make_debug_mesh(shape, axes, device="cpu")
    assert M.data_axes(mesh) == jmesh.data_axes(mesh)
    assert M.model_axis(mesh) == jmesh.model_axis(mesh)


@pytest.mark.parametrize("perm", [[(0, 1)], [(0, 1), (1, 2), (2, 0)],
                                  [(2, 0), (0, 2)]])
def test_ppermute_is_the_permutation(perm):
    arrs, xs = _xs(3, (2, 5))
    out = M.ppermute(xs, [CPU] * 3, perm)
    want = [np.zeros_like(a) for a in arrs]
    for src, dst in perm:
        want[dst] = arrs[src]
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), w)
    with pytest.raises(ValueError, match="permutation"):
        M.ppermute(xs, [CPU] * 3, [(0, 1), (2, 1)])


def test_all_to_all_exchanges_blocks():
    n = 4
    arrs, xs = _xs(n, (n, 3, 2))
    out = M.all_to_all(xs, [CPU] * n)
    for j in range(n):
        np.testing.assert_array_equal(
            out[j].numpy(), np.stack([arrs[i][j] for i in range(n)]))
    with pytest.raises(ValueError, match="axis size"):
        M.all_to_all(xs[:3], [CPU] * 3)


def test_psum_and_pmean_in_position_order():
    arrs, xs = _xs(5, (3, 4))
    total = arrs[0]
    for a in arrs[1:]:
        total = total + a                # position order, in fp32
    for got in M.psum(xs, [CPU] * 5):
        np.testing.assert_array_equal(got.numpy(), total)
    for got in M.pmean(xs, [CPU] * 5):
        np.testing.assert_array_equal(got.numpy(), total / np.float32(5))
    with pytest.raises(ValueError, match="positions"):
        M.psum(xs, [CPU] * 4)


def test_collectives_differentiate_as_their_transposes():
    """The gradient of ppermute is the inverse permutation, of all_to_all
    all_to_all itself, of psum the psum of the cotangents."""
    n = 3
    arrs, xs = _xs(n, (n, 2), seed=1)
    cot = [torch.from_numpy(c) for c in _xs(n, (n, 2), seed=2)[0]]
    for x in xs:
        x.requires_grad_(True)
    perm = [(0, 1), (1, 2), (2, 0)]
    out = M.ppermute(xs, [CPU] * n, perm)
    torch.autograd.backward(out, cot)
    for src, dst in perm:
        np.testing.assert_array_equal(xs[src].grad.numpy(), cot[dst].numpy())
    for x in xs:
        x.grad = None
    out = M.all_to_all(xs, [CPU] * n)
    torch.autograd.backward(out, cot)
    back = M.all_to_all(cot, [CPU] * n)
    for x, b in zip(xs, back):
        np.testing.assert_array_equal(x.grad.numpy(), b.numpy())
    for x in xs:
        x.grad = None
    torch.autograd.backward(M.psum(xs, [CPU] * n), cot)
    for x, s in zip(xs, M.psum(cot, [CPU] * n)):
        np.testing.assert_allclose(x.grad.numpy(), s.numpy(), rtol=1e-6)


def test_send_makes_no_copy_on_the_same_device():
    x = torch.ones(3)
    assert M.send(x, CPU) is x
    assert M.ppermute([x, x], [CPU, CPU], [(0, 1)])[1] is x


def test_production_mesh_refuses_this_host():
    """Never shares a card: fewer cards than 256 (512) positions raise."""
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices"):
            M.make_production_mesh(multi_pod=multi_pod)


def test_entry_points_raise_without_cuda():
    """The mesh constructors, and through them the executors, default to
    the card and raise without one unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_debug_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_mesh((2,), ("pod",), ["cuda", "cuda"])
    assert M.make_debug_mesh(device="cpu").shape == {"pod": 2, "data": 2,
                                                     "model": 2}
