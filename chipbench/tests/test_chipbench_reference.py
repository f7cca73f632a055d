"""The plain reference against the program's CPU path (its kernels' plain
versions) on the same seeded weights, cuts and int8 wire, at sizes the
CPU holds.  The test may import both; the reference imports nothing of
the program."""
import pytest
import torch

from chipbench import inputs, manifest
from chipbench.reference import cnn as ref
from chipbench.reference import codec
from repro_torch.kernels.quant import boundary_roundtrip
from repro_torch.models import cnn as cnn_lib


def _port_split(layers, params, x, cuts, dtype):
    """The program's stages with its own int8 round trip at each cut."""
    edges = [0, *cuts, len(layers)]
    for s, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
        if s:
            x = boundary_roundtrip(x, "int8")
        x = cnn_lib.apply_cnn(layers, params, x, start=a, stop=b,
                              dtype=dtype)
    return x


@pytest.mark.parametrize("name, hw, batch", [("vgg16-bf16", 32, 2),
                                             ("mobilenetv2-bf16", 224, 2)])
def test_reference_equals_the_programs_cpu_path(name, hw, batch):
    config = manifest.config(name)
    net = ref.layers(config["arch"])
    layers = cnn_lib.CNN_MODELS[config["model"]]
    assert [l.kind for l in layers] == [l["kind"] for l in net]
    in_shape = (3, hw, hw)
    for l, spec, shape in zip(layers, net, ref.shapes(net, in_shape)):
        assert cnn_lib.layer_out_shape(l, shape) == ref.out_shape(spec,
                                                                  shape)
    params = inputs.make_weights(net, in_shape, 5, "cpu", torch.bfloat16)
    x = torch.randn((batch, *in_shape), generator=torch.Generator()
                    .manual_seed(6))
    cuts = tuple(config["cuts"])
    got = _port_split(layers, params, x, cuts, "bf16").float()
    want = ref.forward(net, params, x, cuts=cuts,
                       store=ref.store_as(torch.bfloat16))
    assert got.shape == want.shape == (batch, 1000)
    assert torch.equal(got, want)


def test_codec_matches_the_programs_round_trip_and_wire_bytes():
    x = torch.randn((3, 8, 5, 5), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    x[:, 2] = 0.0
    store = ref.store_as(torch.bfloat16)
    assert torch.equal(codec.roundtrip(x.float(), store),
                       boundary_roundtrip(x, "int8").float())
    from repro_torch.runtime.wire import encode_boundary
    from repro_torch.runtime.transfer import HEADER_BYTES
    payload, _ = encode_boundary(x, "int8")
    assert codec.payload_bytes(tuple(x.shape)) == len(payload) \
        + HEADER_BYTES


def test_the_control_is_lower_precision():
    low = ref.store_as(torch.float8_e4m3fn)
    t = torch.tensor([1.0 + 2 ** -6, 1000.0, -1000.0])
    assert low(t).tolist() == [1.0, 448.0, -448.0]
    assert ref.store_as(torch.bfloat16)(t)[0] == 1.0 + 2 ** -6
