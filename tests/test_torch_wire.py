"""The port's boundary wire codec against the JAX package's, on the CPU.

For the same host values the payload bytes are identical (fp32, bf16,
int8), each package decodes the other's payload to the same values, and
a corrupted int8 frame is caught and blamed on the right part."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant import quantize_jnp  # noqa: E402
from repro.kernels.quant import quantize_boundary as jquantize  # noqa: E402
from repro.runtime import wire as jwire  # noqa: E402
from repro_torch.core.costs import (INT8_FRAME_OVERHEAD_BYTES,  # noqa: E402
                                    WIRE_SCALE_BYTES)
from repro_torch.kernels import quant as kquant  # noqa: E402
from repro_torch.kernels.quant import boundary_roundtrip  # noqa: E402
from repro_torch.runtime import (FaultSpec, FaultyLink,  # noqa: E402
                                 FrameError, TransferFailed, events,
                                 pack_frames, send_with_retry, unpack_frames)
from repro_torch.runtime import wire as twire  # noqa: E402

# (storage, wire, shape): the float wires either ship the storage bytes
# as they are or cast them; int8 per channel (ndim 4) and per tensor
CASES = {
    "fp32_raw": ("fp32", "fp32", (2, 6, 5, 5)),
    "fp32_as_bf16": ("fp32", "bf16", (2, 6, 5, 5)),
    "bf16_raw": ("bf16", "bf16", (2, 6, 5, 5)),
    "bf16_as_fp32": ("bf16", "fp32", (3, 7)),
    "fp32_int8": ("fp32", "int8", (2, 6, 5, 5)),
    "fp32_int8_flat": ("fp32", "int8", (4, 33)),
    "bf16_int8": ("bf16", "int8", (1, 4, 3, 3)),
}
_T = {"fp32": torch.float32, "bf16": torch.bfloat16}
_J = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(storage, shape, seed=5):
    x = (np.random.default_rng(seed).normal(size=shape) * 4).astype(
        np.float32)
    return (jnp.asarray(x).astype(_J[storage]),
            torch.from_numpy(x).to(_T[storage]))


def _frames(payload):
    return unpack_frames(payload, ("scales", "data"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_payload_bytes_equal_jax(name):
    """The port's payload is JAX's ``encode_boundary``'s, byte for byte, on
    every wire: int8 included, whose scales JAX computes under ``jit`` as
    ``absmax * fl32(1/127)``, as the port does."""
    storage, wire, shape = CASES[name]
    jx, tx = _pair(storage, shape)
    jp, jm = jwire.encode_boundary(jx, wire)
    tp, tm = twire.encode_boundary(tx, wire)
    assert isinstance(tp, bytes) and len(tp) == len(jp)
    assert (tm.wire, tm.shape, tm.axis, tm.framed, tm.raw_bytes) == \
        (jm.wire, jm.shape, jm.axis, jm.framed, jm.raw_bytes)
    assert tm.storage == tx.dtype and tm.device == tx.device
    assert tp == jp
    # each package decodes the same payload to the same values
    for payload in (jp, tp):
        tgot = twire.decode_boundary(payload, tm)
        jgot = jwire.decode_boundary(payload, jm)
        assert tgot.dtype == tx.dtype
        np.testing.assert_array_equal(tgot.float().numpy(),
                                      np.asarray(jgot.astype(jnp.float32)))


def test_int8_payload_equals_jax_where_true_division_differs():
    """On the 200 seeds of ROADMAP queue 3 fault 1 -- 40 of which give a
    true quotient ``absmax / 127`` one ulp off JAX's jitted scale -- the
    port's int8 payload is JAX's ``encode_boundary``'s, byte for byte."""
    differ = 0
    for seed in range(200):
        x = (np.random.default_rng(seed).normal(size=(2, 6, 5, 5))
             * 4).astype(np.float32)
        jp, _ = jwire.encode_boundary(jnp.asarray(x), "int8")
        tp, _ = twire.encode_boundary(torch.from_numpy(x), "int8")
        assert tp == jp, seed
        _, eager = quantize_jnp(jnp.asarray(x), 1)
        differ += not np.array_equal(
            np.frombuffer(_frames(tp)[0], np.float32), np.asarray(eager))
    assert differ == 40        # the seeds where eager division differs


@pytest.mark.parametrize("shape, dtype", [
    ((2, 6, 5, 5), "fp32"), ((1, 3, 7, 7), "bf16"), ((4, 1, 6, 6), "fp32"),
    ((3, 5, 4), "fp32"), ((4, 33), "bf16"), ((1, 9216), "fp32")])
def test_int8_wire_is_one_packed_buffer(shape, dtype):
    """The int8 payload frames the two parts of the codec's one buffer
    (scales at 0, values at the 16-byte boundary past them), and decode
    rebuilds that buffer and dequantizes it to the round trip's values;
    the values agree with the jitted JAX codec."""
    jx, tx = _pair(dtype, shape, seed=7)
    axis = kquant.default_channel_axis(len(shape))
    groups = kquant.scale_count(shape, axis)
    off = kquant.values_offset(groups)
    assert off % 16 == 0 and 4 * groups <= off < 4 * groups + 16
    buf = kquant.quantize_packed(tx, axis)
    assert buf.dtype == torch.uint8 and buf.numel() == off + tx.numel()
    q, scales = kquant.split_packed(buf, shape, groups)
    jq, js = jquantize(jx, axis, backend="xla")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    payload, meta = twire.encode_boundary(tx, "int8")
    raw = buf.numpy().tobytes()
    assert _frames(payload) == (raw[:4 * groups], raw[off:])
    got = twire.decode_boundary(payload, meta)
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    assert torch.equal(got, kquant.dequantize_boundary(
        q, scales, axis, out_dtype=tx.dtype))
    assert torch.equal(got, boundary_roundtrip(tx, "int8"))


def test_decode_refuses_frames_of_the_wrong_size():
    _, tx = _pair("fp32", (2, 6, 5, 5))
    payload, meta = twire.encode_boundary(tx, "int8")
    s_b, q_b = _frames(payload)
    with pytest.raises(ValueError):
        twire.decode_boundary(pack_frames(s_b[:-4], q_b), meta)
    with pytest.raises(ValueError):
        twire.decode_boundary(pack_frames(s_b, q_b + b"\0"), meta)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_round_trips(name):
    storage, wire, shape = CASES[name]
    _, tx = _pair(storage, shape, seed=6)
    payload, meta = twire.encode_boundary(tx, wire)
    got = twire.decode_boundary(payload, meta)
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    assert torch.equal(got, boundary_roundtrip(tx, wire))
    if wire == storage:
        assert torch.equal(got, tx)         # the raw path is lossless
    if wire == "int8":
        channels = shape[1] if len(shape) >= 3 else 1
        assert len(payload) == tx.numel() + WIRE_SCALE_BYTES * channels \
            + INT8_FRAME_OVERHEAD_BYTES


def test_raw_wire_path_is_legacy_bytes():
    _, tx = _pair("fp32", (1, 4, 5, 5))
    payload, _ = twire.encode_boundary(tx, "fp32")
    data = twire.host_bytes(tx)
    assert payload == data == tx.numpy().tobytes()
    assert torch.equal(
        twire.tensor_from_bytes(data, tx.dtype, tx.shape, tx.device), tx)


def test_corrupted_frames_are_attributed():
    _, tx = _pair("fp32", (2, 6, 5, 5))
    payload, meta = twire.encode_boundary(tx, "int8")
    n_scales = 6 * 4
    cases = {"data": len(payload) - 1,             # last int8 value
             "scales": len(payload) - tx.numel() - n_scales // 2,
             "header": 0}
    for part, pos in cases.items():
        buf = bytearray(payload)
        buf[pos] ^= 0x5A
        with pytest.raises(FrameError) as ei:
            twire.decode_boundary(bytes(buf), meta)
        assert ei.value.part == part, (part, ei.value.part)


def test_send_with_retry_blames_a_frame_part():
    _, tx = _pair("fp32", (1, 4, 3, 3))
    payload, meta = twire.encode_boundary(tx, "int8")
    link = FaultyLink(1e6, faults=FaultSpec(corrupt_rate=1.0), seed=0)
    log = events.EventLog()
    with pytest.raises(TransferFailed):
        send_with_retry(link, payload, log=log, framed=meta.framed)
    fails = [e for e in log.events if e.kind == events.CHECKSUM_FAIL]
    assert fails and all(e.detail["part"] in ("scales", "data", "header")
                         for e in fails)
