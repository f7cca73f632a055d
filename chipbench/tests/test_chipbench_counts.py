"""The yardstick's work and byte counts, from the layers' shapes."""
import pytest

from chipbench import counts, manifest
from chipbench.reference import cnn as ref

IN = (3, 224, 224)


def _net(name):
    return ref.layers(manifest.config(name)["arch"])


@pytest.mark.parametrize("name, gflop, params", [
    ("vgg16-bf16", 30.940528640, 138_357_544),
    ("mobilenetv2-bf16", 0.601548544, 3_487_816)])
def test_model_flops_and_parameters(name, gflop, params):
    """Convs and linear layers, two FLOPs a multiply-add; VGG16 has
    torchvision's 138,357,544 parameters (MobileNetV2's batch norms are
    folded into biases)."""
    net = _net(name)
    assert counts.model_flops(net, IN) == pytest.approx(gflop * 1e9,
                                                        rel=1e-12)
    assert counts.parameter_count(net, IN) == params
    assert manifest.config(name)["num_layers"] == len(net)


def test_a_convs_bound_from_its_shape():
    """VGG16's first conv, fused with its relu (no pool follows), batch
    16: FLOPs 2*9*3*64*224*224*16, bytes of the input, weights, bias and
    output once; bound by the larger of the two times."""
    calls = counts.conv_calls(_net("vgg16-bf16"), IN, cuts=(17, 31),
                              batch=16)
    first = calls[0]
    assert first["flops"] == 2 * 9 * 3 * 64 * 224 * 224 * 16
    assert first["bytes"] == 2 * 16 * (3 + 64) * 224 * 224 \
        + 2 * 64 * 3 * 9 + 4 * 64
    assert counts.least_seconds(first) == pytest.approx(
        max(first["flops"] / 989e12, first["bytes"] / 3.35e12))


def test_a_fused_pool_writes_the_pooled_output_unless_cut():
    net = _net("vgg16-bf16")
    # layer 2 is conv -> relu -> maxpool (2, 2): pooled output, 112 x 112
    whole = counts.conv_calls(net, IN, batch=1)[1]
    assert whole["bytes"] == 2 * 64 * 224 * 224 + 2 * 64 * 112 * 112 \
        + 2 * 64 * 64 * 9 + 4 * 64
    # cut after the relu: the conv writes its whole output
    cut = counts.conv_calls(net, IN, cuts=(4,), batch=1)[1]
    assert cut["bytes"] == 2 * 64 * 224 * 224 * 2 + 2 * 64 * 64 * 9 \
        + 4 * 64


def test_mobilenet_convs_are_expand_depthwise_project():
    calls = counts.conv_calls(_net("mobilenetv2-bf16"), IN, batch=1)
    assert len(calls) == 1 + 2 + 16 * 3 + 1
    assert sum(c["groups"] > 1 for c in calls) == 17


def _event(cat, name, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=1,
                args=args)


def test_launches_count_the_hosts_launch_calls_not_the_kernels():
    """Two kernels launched one by one and three replayed by one graph
    launch are three launch calls; a launch outside the window and a
    memcpy call do not count."""
    from chipbench import tracing
    events = [_event("user_annotation", tracing.WINDOW, 0, 1000),
              _event("cuda_runtime", "cudaLaunchKernel", 10, 2,
                     correlation=1),
              _event("cuda_driver", "cuLaunchKernel_v7000", 20, 2,
                     correlation=2),
              _event("cuda_runtime", "cudaGraphLaunch", 30, 2,
                     correlation=3),
              _event("cuda_runtime", "cudaMemcpyAsync", 40, 2,
                     correlation=4),
              _event("cuda_runtime", "cudaLaunchKernel", 2000, 2,
                     correlation=5)]
    for k, corr in enumerate([1, 2, 3, 3, 3]):
        events.append(_event("kernel", f"k{k}", 100 + 10 * k, 5,
                             correlation=corr))
    t = tracing.Trace(events)
    assert t.launch_calls == 3 and len(t.kernels) == 5
    run = {"trace": t, "window": {"images": 3}}
    assert manifest.reader("launches_per_image.fused").read(run) == 1.0
