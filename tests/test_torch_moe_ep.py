"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against
the JAX package's (``repro.models.moe_ep``), on the CPU, as
``tests/test_moe_ep.py`` holds JAX's: Granite-MoE ``.reduced()`` at
capacity factor 8, x (4, 16, d), a (4, 2) data x model mesh.

JAX's EP needs 8 devices, so one subprocess (``XLA_FLAGS``) runs it and
writes its weights, inputs, outputs and gradients; the port runs on a
debug mesh of the same shape whose positions all share the CPU.

* y within 1e-5 of JAX's EP y and of the port's local ``moe``; aux within
  1e-6 of JAX's EP aux and within 0.05 of the local aux.
* Grads of sum(y^2) within 1e-4 rtol / 1e-5 atol of JAX's EP grads.
* ``ep_enabled`` false at (2, 3, d); finite output at capacity factor
  1.25 (drops), close to JAX's there; two runs bitwise equal."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("router", "wg", "wu", "wd")

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import all_configs
    from repro.models import layers as L
    from repro.models import moe_ep

    cfg = dataclasses.replace(all_configs()["granite-moe-3b-a800m"].reduced(),
                              moe_capacity_factor=8.0)
    params = L.init_moe_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32) * 0.5
    out = {k: np.asarray(v) for k, v in params.items()}
    out["x"] = np.asarray(x)
    y, aux = jax.jit(lambda p, x: L.moe(cfg, p, x))(params, x)
    out["y_base"], out["aux_base"] = np.asarray(y), np.asarray(aux)

    def loss(p, x):
        y, _ = L.moe(cfg, p, x)
        return (y ** 2).sum()
    moe_ep.EP_MESH = jax.make_mesh((4, 2), ("data", "model"))
    assert moe_ep.ep_enabled(cfg, x.shape)
    y, aux = jax.jit(lambda p, x: L.moe(cfg, p, x))(params, x)
    out["y_ep"], out["aux_ep"] = np.asarray(y), np.asarray(aux)
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    for k in params:
        out["grad_" + k] = np.asarray(g[0][k])
    out["grad_x"] = np.asarray(g[1])
    cfg2 = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    y2, aux2 = jax.jit(lambda p, x: L.moe(cfg2, p, x))(params, x)
    out["y_cf125"], out["aux_cf125"] = np.asarray(y2), np.asarray(aux2)
    np.savez(sys.argv[1], **out)
    print("MOE_EP_REF_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_ep") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", SCRIPT, path],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "MOE_EP_REF_OK" in run.stdout
    return dict(np.load(path))


def _cfg(cf=8.0):
    return dataclasses.replace(all_configs()["granite-moe-3b-a800m"]
                               .reduced(), moe_capacity_factor=cf)


@pytest.fixture
def ep_mesh():
    """EP_MESH set to a (4, 2) data x model debug mesh on the CPU for the
    test, and cleared after it."""
    moe_ep.EP_MESH = M.make_debug_mesh((4, 2), ("data", "model"),
                                       device="cpu")
    try:
        yield moe_ep.EP_MESH
    finally:
        moe_ep.EP_MESH = None


def _params(ref, grad=False):
    return {k: torch.from_numpy(ref[k].copy()).requires_grad_(grad)
            for k in KEYS}


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def test_ep_output_and_aux_match_jax_and_the_local_dispatch(ref, ep_mesh):
    cfg = _cfg()
    p, x = _params(ref), torch.from_numpy(ref["x"])
    assert moe_ep.ep_enabled(cfg, x.shape)
    y, aux = TL.moe(cfg, p, x)                   # the EP branch
    y_direct, aux_direct = moe_ep.moe_expert_parallel(cfg, p, x)
    assert torch.equal(y, y_direct) and torch.equal(aux, aux_direct)
    err = _max_err(y.numpy(), ref["y_ep"])
    print(f"EP y against JAX's EP: {err:.3g} max abs")
    assert err <= 1e-5
    assert abs(float(aux) - float(ref["aux_ep"])) <= 1e-6
    moe_ep.EP_MESH = None
    y_loc, aux_loc = TL.moe(cfg, p, x)
    np.testing.assert_allclose(y.numpy(), y_loc.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y_loc.numpy(), ref["y_base"], rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(aux_loc)) < 0.05


def test_ep_grads_match_jax(ref, ep_mesh):
    cfg = _cfg()
    p = _params(ref, grad=True)
    x = torch.from_numpy(ref["x"].copy()).requires_grad_(True)
    y, _ = TL.moe(cfg, p, x)
    (y ** 2).sum().backward()
    for k in KEYS:
        np.testing.assert_allclose(p[k].grad.numpy(), ref["grad_" + k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), ref["grad_x"], rtol=1e-4,
                               atol=1e-5)


def test_ep_falls_back_and_drops_stay_bounded(ref, ep_mesh):
    cfg = _cfg()
    assert not moe_ep.ep_enabled(cfg, (2, 3, cfg.d_model))
    cfg2 = _cfg(1.25)
    p, x = _params(ref), torch.from_numpy(ref["x"])
    y2, aux2 = TL.moe(cfg2, p, x)
    assert bool(torch.isfinite(y2).all())
    # the same drops as JAX's EP at cf 1.25: the same output
    np.testing.assert_allclose(y2.numpy(), ref["y_cf125"], rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux2) - float(ref["aux_cf125"])) <= 1e-6
    again, _ = TL.moe(cfg2, p, x)
    assert torch.equal(again, y2)


def test_ep_needs_a_mesh_with_a_model_axis():
    cfg = _cfg()
    x = torch.zeros(4, 16, cfg.d_model)
    assert moe_ep.EP_MESH is None and not moe_ep.ep_enabled(cfg, x.shape)
    with pytest.raises(ValueError, match="EP_MESH"):
        moe_ep.moe_expert_parallel(cfg, {}, x)
    moe_ep.EP_MESH = M.make_debug_mesh((2,), ("data",), device="cpu")
    try:
        assert not moe_ep.ep_enabled(cfg, x.shape)
    finally:
        moe_ep.EP_MESH = None


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data",
                                                     "model")),
                                        ((1, 4), ("data", "model")),
                                        ((4,), ("model",))])
def test_ep_equals_the_local_dispatch_on_any_mesh(ref, shape, axes):
    """Drop-free capacity: EP equals the local dispatch on every mesh
    layout, the batch split over pod and data together or not at all."""
    cfg = _cfg()
    p, x = _params(ref), torch.from_numpy(ref["x"])
    y_loc, _ = TL.moe(cfg, p, x)
    moe_ep.EP_MESH = M.make_debug_mesh(shape, axes, device="cpu")
    try:
        assert moe_ep.ep_enabled(cfg, x.shape)
        y, aux = TL.moe(cfg, p, x)
    finally:
        moe_ep.EP_MESH = None
    np.testing.assert_allclose(y.numpy(), y_loc.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isfinite(aux))
