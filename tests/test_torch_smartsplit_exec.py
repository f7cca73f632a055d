"""The port's two-stage SmartSplit executor
(``repro_torch.launch.smartsplit_exec``) against the JAX package's
(``repro.launch.smartsplit_exec``), on the CPU.

JAX's executor is a ``shard_map`` over a (2,) ``pod`` mesh, so one
subprocess an architecture (``XLA_FLAGS`` with 4 host devices, as
``tests/test_two_stage.py`` runs it) computes its logits, jitted, for
every case and writes them to a file; the port runs the same cases on a
debug mesh whose two pods share the CPU.  Config: Qwen3-4B ``.reduced()``
at 4 layers, fp32, JAX's ``init_params`` at ``PRNGKey(0)`` carried across
by ``params_from_numpy``, tokens (4, 16) from a seeded numpy generator.
Cases: l1 in {1, 2, 3} un-pipelined and l1 = 2 pipelined with 2
microbatches, each on the follow, bf16 and int8 wires.

* Against JAX: logits within 1e-4 of a row's scale (follow), 2e-2 (bf16)
  and 1e-2 (int8; the measured maximum is printed).
* Within the port: the follow split equals the monolithic ``forward``
  bitwise, pipelined equals ``forward`` of each microbatch bitwise, and
  each wire equals the monolithic walk with the boundary round-tripped
  through that wire (int8: each microbatch with its own scales) bitwise.
* ``stage_params`` equals JAX's bitwise; the codec on the (B*S, d, 1)
  view (axis -1) equals jitted ``quantize_jnp`` / ``dequantize_jnp``
  bitwise, whole batch and per microbatch.
* zamba2 is refused, as JAX refuses it.
* RWKV6 and Granite-MoE (capacity factor 16, drop-free) as ``slow``
  cases, as ``tests/test_two_stage.py`` marks them."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_configs as jall  # noqa: E402
from repro.kernels.quant import dequantize_jnp, quantize_jnp  # noqa: E402
from repro.launch import smartsplit_exec as JX  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import all_configs as tall  # noqa: E402
from repro_torch.kernels import quant as kquant  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import smartsplit_exec as TX  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(1, False), (2, False), (3, False), (2, True)]   # (l1, pipelined)
WIRES = ("follow", "bf16", "int8")
TOL = {"follow": 1e-4, "bf16": 2e-2, "int8": 1e-2}
MICRO = 2

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import all_configs
    from repro.launch.smartsplit_exec import two_stage_apply
    from repro.models import transformer as T

    arch, wires, inp, outp = sys.argv[1], sys.argv[2].split(","), \\
        sys.argv[3], sys.argv[4]
    cfg = dataclasses.replace(all_configs()[arch].reduced(), num_layers=4,
                              name="split-test")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    params = T.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    toks = jnp.asarray(np.load(inp)["tokens"])
    mesh = jax.make_mesh((2,), ("pod",))
    out = {"mono": np.asarray(T.forward(cfg, params, {"tokens": toks},
                                        mode="train")[0])}
    for wire in wires:
        for l1, piped in ((1, False), (2, False), (3, False), (2, True)):
            fn = jax.jit(lambda p, t: two_stage_apply(
                cfg, p, t, mesh, l1, pipelined=piped, microbatches=2,
                wire_dtype=wire))
            out[f"{wire}_{l1}_{int(piped)}"] = np.asarray(fn(params, toks))
    np.savez(outp, **out)
    print("SPLIT_REF_OK")
""")


def _cfg(pkg_all, arch):
    cfg = dataclasses.replace(pkg_all()[arch].reduced(), num_layers=4,
                              name="split-test")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=16.0)
    return cfg


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """Per architecture: (port cfg, port params, tokens, JAX's logits by
    case), one JAX subprocess an architecture."""
    cache = {}

    def get(arch, wires=WIRES):
        if arch not in cache:
            tmp = tmp_path_factory.mktemp(arch)
            jcfg, tcfg = _cfg(jall, arch), _cfg(tall, arch)
            toks = np.random.default_rng(1).integers(
                0, jcfg.vocab_size, (4, 16)).astype(np.int32)
            np.savez(tmp / "in.npz", tokens=toks)
            env = dict(os.environ)
            env["PYTHONPATH"] = "src"
            env.pop("XLA_FLAGS", None)
            run = subprocess.run(
                [sys.executable, "-c", SCRIPT, arch, ",".join(wires),
                 str(tmp / "in.npz"), str(tmp / "out.npz")],
                capture_output=True, text=True, env=env, cwd=REPO,
                timeout=600)
            assert run.returncode == 0, run.stderr[-3000:]
            assert "SPLIT_REF_OK" in run.stdout
            jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
            tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")
            cache[arch] = (tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                           dict(np.load(tmp / "out.npz")), jp)
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def pods():
    return M.make_debug_mesh((2,), ("pod",), device="cpu")


def _row_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| over each row's scale (its largest |value|,
    at least the RMS of the whole tensor)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True),
                       np.sqrt((want ** 2).mean()))
    return float((np.abs(got - want) / scale).max())


def _split(cfg, params, toks, mesh, l1, piped, wire, m=MICRO):
    return TX.two_stage_apply(cfg, params, toks, mesh, l1, pipelined=piped,
                              microbatches=m, wire_dtype=wire)


def _walk(cfg, params, toks, l1, wire):
    """The monolithic walk of ``forward`` with the boundary after block l1
    round-tripped through ``wire`` (int8 per feature, axis -1)."""
    h = params["embed"][toks]
    B, S = toks.shape
    pos = TT._positions(0, B, S, h.device)
    for i in range(cfg.num_layers):
        if i == l1 and wire != "follow":
            h = kquant.boundary_roundtrip(h, wire, axis=-1)
        h, _, _ = TT._apply_block(cfg, cfg.pattern, TT._layer(
            params["blocks"], i), h, positions=pos)
    return TT._logits(cfg, params, h)


def _check_against_jax(model, pods, arch, wire, l1, piped):
    cfg, params, toks, ref, _ = model(arch)
    got = _split(cfg, params, toks, pods, l1, piped, wire)
    assert got.dtype == torch.float32 and got.shape == ref["mono"].shape
    err = _row_err(got.numpy(), ref[f"{wire}_{l1}_{int(piped)}"])
    print(f"{arch} {wire} l1={l1} pipelined={piped}: {err:.3g} of a row's "
          f"scale from JAX")
    assert err <= TOL[wire]
    return got


@pytest.mark.parametrize("l1,piped", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("wire", WIRES)
def test_split_matches_jax(model, pods, wire, l1, piped):
    _check_against_jax(model, pods, "qwen3-4b", wire, l1, piped)


@pytest.mark.parametrize("l1", [0, 1, 2, 3, 4])
def test_follow_split_equals_monolithic_bitwise(model, pods, l1):
    cfg, params, toks, ref, _ = model("qwen3-4b")
    mono = TT.forward(cfg, params, {"tokens": toks}, mode="train")[0]
    assert _row_err(mono.numpy(), ref["mono"]) <= 1e-4
    assert torch.equal(_split(cfg, params, toks, pods, l1, False, "follow"),
                       mono)


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("wire", WIRES)
def test_pipelined_equals_each_microbatch_alone_bitwise(model, pods, wire,
                                                        m):
    """Pipelined over m microbatches == the un-pipelined split of each
    microbatch alone (int8: its own scales); on the follow wire that is
    the monolithic ``forward`` of each microbatch."""
    cfg, params, toks, _, _ = model("qwen3-4b")
    got = _split(cfg, params, toks, pods, 2, True, wire, m=m)
    bm = toks.shape[0] // m
    parts = [toks[i * bm:(i + 1) * bm] for i in range(m)]
    alone = torch.cat([_split(cfg, params, t, pods, 2, False, wire)
                       for t in parts])
    assert torch.equal(got, alone)
    if wire == "follow":
        mono = torch.cat([TT.forward(cfg, params, {"tokens": t},
                                     mode="train")[0] for t in parts])
        assert torch.equal(got, mono)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_wire_is_the_boundary_round_trip(model, pods, wire):
    cfg, params, toks, _, _ = model("qwen3-4b")
    for l1 in (1, 3):
        assert torch.equal(_split(cfg, params, toks, pods, l1, False, wire),
                           _walk(cfg, params, toks, l1, wire))
    # the storage policy picks the follow wire's format
    assert torch.equal(
        TX.two_stage_apply(cfg, params, toks, pods, 2, boundary_dtype="bf16",
                           wire_dtype="follow"),
        _walk(cfg, params, toks, 2, "bf16"))


@pytest.mark.parametrize("l1", [1, 2, 3])
def test_stage_params_equal_jax(model, l1):
    cfg, params, _, _, jp = model("qwen3-4b")
    jcfg = _cfg(jall, "qwen3-4b")
    jstaged, jmask = JX.stage_params(jcfg, jp, l1)
    staged, mask = TX.stage_params(cfg, params, l1)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jl = jax.tree_util.tree_leaves_with_path(jstaged)
    assert len(jl) == len(jax.tree_util.tree_leaves(staged))
    for path, leaf in jl:
        t = staged
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_stage_blocks_are_views_on_a_shared_device(model, pods):
    """No copy of a weight where the pods share the params' device."""
    cfg, params, _, _, _ = model("qwen3-4b")
    p0, p1 = TX.stage_blocks(cfg, params, 1, pods)
    assert len(p0) == 1 and len(p1) == cfg.num_layers - 1
    base = params["blocks"]["mlp"]["wg"]
    assert p1[0]["mlp"]["wg"].data_ptr() == base[1].data_ptr()
    assert p0[0]["mlp"]["wg"].untyped_storage().data_ptr() == \
        base.untyped_storage().data_ptr()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_boundary_codec_equals_jitted_quantize_jnp(model, dtype):
    """The (B*S, d, 1) view of the boundary (axis -1), whole batch and each
    microbatch: values, scales and decoded values bitwise the jitted JAX
    codec's.  The boundary is the hidden state after block 2, with a
    feature set to zero (scale 1.0)."""
    cfg, params, toks, _, _ = model("qwen3-4b")
    h = params["embed"][toks]
    pos = TT._positions(0, *toks.shape, h.device)
    for i in range(2):
        h, _, _ = TT._apply_block(cfg, cfg.pattern, TT._layer(
            params["blocks"], i), h, positions=pos)
    h = h.clone()
    h[..., 5] = 0.0
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jq = jax.jit(lambda x: quantize_jnp(x, axis=-1))
    jd = jax.jit(lambda q, s: dequantize_jnp(q, s, axis=-1, out_dtype=jdt))
    B = h.shape[0]
    for part in [h] + [h[i * B // MICRO:(i + 1) * B // MICRO]
                       for i in range(MICRO)]:
        x = part.to(tdt).contiguous()
        jx = jnp.asarray(x.float().numpy()).astype(jdt)
        q, s = kquant.quantize_boundary(x, axis=-1)
        wq, ws = jq(jx)
        assert q.shape == x.shape and s.shape == (x.shape[-1],)
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
        assert float(s[5]) == 1.0
        back = kquant.dequantize_boundary(q, s, axis=-1, out_dtype=tdt)
        np.testing.assert_array_equal(
            back.float().numpy(), np.asarray(jd(wq, ws).astype(jnp.float32)))


def test_zamba2_is_refused_as_jax_refuses_it(pods):
    jcfg = _cfg(jall, "zamba2-7b")
    with pytest.raises(AssertionError, match="segment granularity"):
        JX.build_two_stage_forward(jcfg, None, 2)
    tcfg = _cfg(tall, "zamba2-7b")
    with pytest.raises(ValueError, match="segment granularity"):
        TX.build_two_stage_forward(tcfg, pods, 2)
    params = TT.init_params(tcfg, 0, torch.float32, "cpu")
    with pytest.raises(ValueError, match="segment granularity"):
        TX.two_stage_apply(tcfg, params, torch.zeros(2, 4, dtype=torch.long),
                           pods, 2)


def test_bad_arguments_raise(model, pods):
    cfg, params, toks, _, _ = model("qwen3-4b")
    with pytest.raises(ValueError, match="microbatches"):
        _split(cfg, params, toks, pods, 2, True, "follow", m=3)
    with pytest.raises(ValueError, match="outside"):
        _split(cfg, params, toks, pods, 5, False, "follow")
    with pytest.raises(ValueError, match="'pod' axis"):
        _split(cfg, params, toks, M.make_debug_mesh((2,), ("data",),
                                                    device="cpu"),
               2, False, "follow")
    with pytest.raises(ValueError, match="wire"):
        _split(cfg, params, toks, pods, 2, False, "int4")


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["rwkv6-7b", "granite-moe-3b-a800m"])
def test_other_block_kinds_split_as_jax_splits_them(model, pods, arch):
    """RWKV6 on all three wires; Granite-MoE on the follow wire only (a
    rounded boundary can flip a near-tie router decision, as
    ``tests/test_two_stage.py`` notes)."""
    wires = WIRES if arch == "rwkv6-7b" else ("follow",)
    cfg, params, toks, _, _ = model(arch, wires)
    mono = TT.forward(cfg, params, {"tokens": toks}, mode="train")[0]
    for wire in wires:
        for l1, piped in CASES:
            got = _check_against_jax(model, pods, arch, wire, l1, piped)
            if wire == "follow" and not piped:
                assert torch.equal(got, mono)
