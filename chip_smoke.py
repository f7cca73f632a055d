#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once); every dense conv instantiation and every flash
   attention one must hold tensor-core ``HGMMA``s (wgmma) in its SASS,
   every SSD product kernel (chunk states, outputs) ``HMMA``s
   (mma.sync); no depthwise conv, flash, WKV, SSD, quantize or
   dequantize kernel may have a stack frame or spill (``-Xptxas -v``,
   ``cuobjdump -sass``);
3. hold the conv kernels against their plain PyTorch version at every
   distinct conv (and fused conv+act+pool) shape of AlexNet, VGG16 and
   MobileNetV2 at 224 px, batch 1, of AlexNet and MobileNetV2 at batch
   4, and of two depthwise convs with a fused pool, fp32 (1e-4 of scale)
   and bf16 (2e-2 of scale); outside VGG16 every fused conv equals the
   unfused conv followed by its activation and pool, bitwise, and at
   every shape a batch-4 launch equals four batch-1 launches, bitwise;
4. hold the int8 codec against its plain version, bitwise, fp32 and
   bf16, at every boundary shape the main path's plans pick (batch-1
   microbatches), at every batch-4 boundary of every model's int8 plans
   (K 2 and 3), at the per-tensor flattens (4, 4096) and (4, 9216), at
   the transformer split's per-feature boundary (B*S, d, 1) = (512, 2560,
   1) and (128, 2560, 1) (phase 12's, whole batch and a microbatch), and at
   a shape where the quantize planner takes a cluster of 4: every cluster
   size 1, 2, 4, 8 must be checked, the flattens and (4, 32, 28, 28) must
   take more than one CTA a group, and every slice must be held in
   registers (x read once);
5. the main path: ``repro_torch.launch.serve.serve_cnn`` for AlexNet and
   MobileNetV2 at 224 px, batch 4 -- K=2 with the follow wire, K=3 with
   M=4 and the int8 wire, and K=3 with M=4 under 30% drops -- with the
   launch counts set to 0 just before and read just after; each of its
   kernels (conv, codec) must have launched.  Then split-vs-monolithic
   logits are checked bitwise on the card, and each run is repeated on
   the CPU: logits within 1e-3 of scale (follow wire) or the same top-1
   (int8 wire);
6. time every kernel against its plain version and the PyTorch library
   call (``F.conv2d``, fp32 and bf16; ``torch.mul`` for dequantize; none
   for quantize;
   ``F.scaled_dot_product_attention`` for flash attention, fp32 and bf16,
   each checked against the kernel first, with an explicit end-aligned
   mask where Sq < Sk; none for WKV and SSD) at the
   main paths' shapes -- the codec, fp32 and bf16, at phase 4's
   microbatch and batch-4 boundaries and flattens, each with its bound,
   and apart from those sums at phase 12's (B*S, d, 1) boundaries
   (``split_boundary`` in the kernels line) -- (CUDA graphs of
   back-to-back launches, CUDA events, warm L2, in turns), and print one
   ``{"kernels": [...]}`` JSON line with each kernel's launches, error,
   times and bound.  It runs after phases 10 and 12 (and before phase 11,
   whose heavy training stays out of the kernel timings), since it times
   phase 7's shapes too;
7. the sequence kernels' path: ``repro_torch.kernels.ops`` at batch 2, in
   fp32 and bf16, with the launch counts set to 0 just before and read
   just after -- ``flash_attention_gqa`` (causal) at Qwen3-4B's widths (32
   heads over 8 kv heads, hd 128) and Zamba2-7B's shared attention (32
   heads, hd 112) with Sq = Sk = 2048, and at Qwen3-4B's with Sq 128
   against Sk 2048; ``rwkv6_wkv`` at RWKV6-7B's (64 heads of 64) with T =
   2000, whose last stage is partial; ``mamba2_ssd`` at Zamba2-7B's (112
   heads, hp 64, ds 64, B/C of 8 groups repeated to the heads) with T =
   2048.  Every kernel must have launched; every output is finite and of
   its shape;
8. hold each sequence kernel against its plain version at every phase-7
   call and at the small shapes of ``tests/test_kernels.py``'s sweeps, a
   causal Sq > Sk case (rows with no visible key average V), ragged-T
   cases, and WKV at hd 64 with T inside one stage of its plan and T not
   a multiple of the plan's steps: fp32 to 1e-4 of scale (flash, WKV)
   and 2e-4 (SSD), bf16 to 2e-2 (flash, WKV) and 5e-2 (SSD), where the
   scale is each output row's own (its largest |value| over the last
   dim, at least the RMS of the whole output);
9. the CNN stream path: ``repro_torch.launch.serve.serve_cnn_stream`` for
   AlexNet and MobileNetV2 at 224 px, 16 single-sample requests in batch
   buckets of 4 -- K=3 with the int8 wire pipelined, K=2 with the follow
   wire sequential (``--no-pipeline``), K=3 int8 under 30% drops, K=3
   int8 under the ``crash`` tier-fault profile -- with the launch counts
   set to 0 just before and read just after.  Each pipelined run's served
   requests must equal their samples alone through the chain at batch 1
   on the card, bitwise; each run's conv kernels (and, on the int8 wire,
   both codec kernels) must have launched; each run's ``stats()`` must
   equal the same stream's on the CPU, key for key (counts, virtual times,
   hop bytes), and its logits the CPU's (1e-3 of scale, follow wire; the
   same top-1, int8 wire).  Prints wall ms per request and the virtual
   req/s, p50 and p99;
10. the transformer decode path: Qwen3-4B at full width and depth (fp32,
   weights from a seeded generator on the card) serves 8 greedy requests
   through ``repro_torch.serving.engine.Engine`` (tokens/s printed), and
   prefill of n+1 tokens equals prefill of n plus one ``decode_step`` to
   1e-3 of a row's scale; RWKV6-7B, Zamba2-7B (one shared-block
   application), Granite-MoE-3B and HuBERT-XLarge at full width and cut
   depth hold their card prefill logits and one decode step (HuBERT:
   forward only) to the same weights on the CPU to 1e-3 of a row's scale,
   and the MoE prefill is bitwise the same twice; no kernel of the port
   launches on this path (its mixers are plain torch, as the JAX
   package's are plain jnp);
11. the training path, after phase 6's timing, all in strict fp32:
   Qwen3-4B at full width and depth (4.42 B parameters) trained for 4
   steps by ``repro_torch.training.train_loop.train`` at the JAX
   package's ``TrainConfig`` defaults (batch 8 x 128 tokens of
   ``SyntheticLM``): every loss and grad norm finite, the step-0 loss
   below ln(padded vocab) + 2, every leaf moved; prints ms a step over
   steps 1-3, tokens/s, the optimizer's ms a step and the peak memory
   beside 16 B a parameter.  Then Qwen3-4B (2 layers), RWKV6-7B (2),
   Zamba2-7B (6), Granite-MoE-3B (2) and HuBERT-XLarge (2) at full
   width, batch 2 x 16 tokens, 2 steps on the card and on the CPU from
   the same weights: losses and grad norms within 1e-4 relative, step 0's
   grads within 1e-4 of each leaf's largest |value|, a second card run
   bitwise equal; and the Qwen3-4B run checkpointed after step 1,
   restored into fresh tensors on the card, takes step 2 to the
   uninterrupted run's loss and params bitwise.  No kernel of the port
   launches on this path;
12. the SmartSplit executors across devices, after phase 10 and before
   phase 6's timing: Qwen3-4B at full width and depth (fp32, batch 4 x 128
   seeded tokens) split by ``launch.smartsplit_exec.two_stage_apply``
   with both pods on the one card, each on its own CUDA stream, at the
   planner's cut (``smartsplit`` of the prefill profile on
   ``TPU_EDGE_CLOUD``, as ``serve --plan-split`` plans) and at l1 1, 18
   and 35, on the follow, bf16 and int8 wires, un-pipelined and over 4
   microbatches, with the launch counts set to 0 just before and read
   just after: the follow split equals the monolithic ``forward``
   bitwise (pipelined: ``forward`` of each microbatch), bf16 is within
   5e-2 of a row's scale, and the int8 boundary goes through the quantize
   and dequantize kernels once a crossing; ms a forward split and
   monolithic, and the peak memory.  Qwen3-4B cut to 4 layers, l1 = 2,
   card against CPU: 1e-3 of a row's scale (follow), the same top-1 where
   the CPU's top-2 margin decides it (int8).  Granite-MoE-3B at full width
   and 2 layers, capacity factor 8: each MoE layer expert-parallel
   (``models.moe_ep``) on a (2, 4) data x model debug mesh on the card
   within 1e-5 of a row's scale of the local dispatch, a second run
   bitwise equal, within 1e-4 of the same EP on the CPU, and the model's
   logits EP against local; no kernel launches in the EP runs.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without ``src/repro_torch`` beside it, the script exits
non-zero before printing any result.  Per-shape details go to
``chiprun_out/chip_smoke.json``."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA
# cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# The rate of the arithmetic the dense conv kernel runs: fp32 storage as
# three TF32 tensor-core passes (495 TFLOP/s each), bf16 as one bf16 pass.
CONV_PEAK = {"fp32": 495e12 / 3, "bf16": 989e12}
# The same for the sequence kernels: flash attention as the conv (its
# bf16 P V runs a second bf16 pass for P's low half, which the bound
# does not count: the function's operations at the bf16 rate); the SSD
# runs TF32 passes in both storage dtypes (up to three, fewer where a
# bf16 operand is exact); WKV runs fp32 on the CUDA cores in both.
MIXER_PEAK = {"flash_attention": CONV_PEAK,
              "mamba2_ssd": {"fp32": 495e12 / 3, "bf16": 495e12 / 3},
              "rwkv6_wkv": {"fp32": PEAK_FLOPS["fp32"],
                            "bf16": PEAK_FLOPS["fp32"]}}
TENSOR_CORE_MIXERS = ("flash_attention", "mamba2_ssd")
FP32_TOL = 1e-4
BF16_TOL = 2e-2
LOGIT_TOL = 1e-3
SOURCES = {
    "conv2d_dense": ("src/repro_torch/csrc/conv2d.cu",
                     "src/repro/kernels/conv2d.py:464"),
    "conv2d_depthwise": ("src/repro_torch/csrc/conv2d.cu",
                         "src/repro/kernels/conv2d.py:451"),
    "quantize": ("src/repro_torch/csrc/quant.cu",
                 "src/repro/kernels/quant.py:70"),
    "dequantize": ("src/repro_torch/csrc/quant.cu",
                   "src/repro/kernels/quant.py:79"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:23"),
    "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                  "src/repro/kernels/rwkv6_wkv.py:21"),
    "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu",
                   "src/repro/kernels/mamba2_ssd.py:24"),
}
CNN_KERNELS = ("conv2d_dense", "conv2d_depthwise", "quantize", "dequantize")
MIXERS = ("flash_attention", "rwkv6_wkv", "mamba2_ssd")
MIXER_TOL = {("flash_attention", "fp32"): 1e-4, ("rwkv6_wkv", "fp32"): 1e-4,
             ("mamba2_ssd", "fp32"): 2e-4, ("flash_attention", "bf16"): 2e-2,
             ("rwkv6_wkv", "bf16"): 2e-2, ("mamba2_ssd", "bf16"): 5e-2}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, output scale = max(1, max |want|))."""
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()),
            max(1.0, float(w.abs().max())))


def row_err(got, want) -> tuple[float, float]:
    """(max abs error, max of each row's error over its row's scale).  A
    row is one output vector (the last dim); its scale is its largest
    |want|, at least the RMS of all of ``want``, so a row of small values
    is held to its own size and not to the largest row's."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    floor = max(float(w.square().mean().sqrt()), 1e-30)
    scale = w.abs().amax(dim=-1, keepdim=True).clamp(min=floor)
    return float(err.max()), float((err / scale).max())


# ---------------------------------------------------------------------------
# Phase 3: conv kernels vs plain
# ---------------------------------------------------------------------------
def conv_cases(cnn, models):
    """Distinct conv calls of the fusion walk over each (model, batch),
    plus the unfused ends a split can leave (conv alone, conv+act without
    pool)."""
    seen = {}
    for name, batch in models:
        layers = cnn.CNN_MODELS[name]
        calls = cnn.conv_launches(layers, batch=batch)
        for cut in range(1, len(layers)):
            calls += cnn.conv_launches(layers, batch=batch, stop=cut)[-1:]
        for c in calls:
            key = (c["x_shape"], c["w_shape"], c["stride"], c["pad"],
                   c["groups"], c["activation"], c["pool_k"], c["pool_s"])
            seen.setdefault(key, dict(c, model=name))
    return list(seen.values())


# The depthwise kernel's fused pool, which no served model reaches (the
# JAX kernel takes it, so the port does too): MobileNetV2-sized depthwise
# convs with AlexNet's overlapping pool and a tiling one.
DW_POOL_CASES = [
    dict(layer=-1, x_shape=(4, 144, 56, 56), w_shape=(144, 1, 3, 3),
         stride=1, pad=1, groups=144, activation="relu6", pool_k=3,
         pool_s=2, model="depthwise+pool"),
    dict(layer=-1, x_shape=(1, 96, 57, 57), w_shape=(96, 1, 3, 3),
         stride=2, pad=1, groups=96, activation="relu", pool_k=2,
         pool_s=2, model="depthwise+pool"),
]


def make_inputs(torch, call, dtype, gen, dev):
    cout, cin_pg, k, _ = call["w_shape"]
    x = torch.randn(call["x_shape"], generator=gen)
    w = torch.randn(call["w_shape"], generator=gen) / (cin_pg * k * k) ** 0.5
    b = 0.1 * torch.randn((cout,), generator=gen)
    return x.to(dtype).to(dev), w.to(dtype).to(dev), b.to(dev)


def conv_kwargs(call):
    return dict(stride=call["stride"], pad=call["pad"],
                groups=call["groups"], activation=call["activation"],
                pool_k=call["pool_k"], pool_s=call["pool_s"])


def phase_conv(torch, F, cnn, kconv, ref, dev):
    gen = torch.Generator().manual_seed(1)
    worst = {}
    rows = []
    n_fused = n_batch = 0
    # batch 1 (and the int8 runs' microbatches) and the follow-wire runs'
    # batch 4, where the planner may pick another blocking
    cases = conv_cases(cnn, [("alexnet", 1), ("vgg16", 1),
                             ("mobilenetv2", 1), ("alexnet", 4),
                             ("mobilenetv2", 4)])
    for call in cases + DW_POOL_CASES:
        for dname, dtype, tol in (("fp32", torch.float32, FP32_TOL),
                                  ("bf16", torch.bfloat16, BF16_TOL)):
            x, w, b = make_inputs(torch, call, dtype, gen, dev)
            kw = conv_kwargs(call)
            got = kconv.conv2d(x, w, bias=b, **kw)
            want = ref.conv2d_plain(x, w, bias=b, **kw)
            torch.cuda.synchronize()
            err, scale = rel_err(got, want)
            kind = "conv2d_depthwise" if call["groups"] > 1 \
                and call["groups"] == call["x_shape"][1] else "conv2d_dense"
            check(err <= tol * scale,
                  f"{kind} {dname} {call}: max abs err {err} > "
                  f"{tol} * {scale}")
            worst[(kind, dname)] = max(worst.get((kind, dname), 0.0), err)
            fused = call["activation"] is not None or call["pool_k"]
            if fused and call["model"] != "vgg16":
                plain = dict(kw, activation=None, pool_k=0, pool_s=0)
                u = ref.activate(kconv.conv2d(x, w, bias=b, **plain),
                                 call["activation"])
                if call["pool_k"]:
                    u = F.max_pool2d(u, call["pool_k"], call["pool_s"])
                check(torch.equal(u, got),
                      f"{kind} {dname} {call}: fused != unfused")
                n_fused += 1
            # batch 4 == four batch-1 launches: the planner may tile the
            # two differently, the sums may not differ
            x4 = x if x.shape[0] == 4 else torch.randn(
                (4,) + tuple(x.shape[1:]), generator=gen).to(dtype).to(dev)
            y4 = got if x4 is x else kconv.conv2d(x4, w, bias=b, **kw)
            y1 = torch.cat([kconv.conv2d(x4[i:i + 1], w, bias=b, **kw)
                            for i in range(4)])
            check(torch.equal(y4, y1),
                  f"{kind} {dname} {call}: batch 4 != 4 x batch 1")
            n_batch += 1
            rows.append(dict(kernel=kind, dtype=dname, model=call["model"],
                             x=list(call["x_shape"]), w=list(call["w_shape"]),
                             stride=call["stride"], pad=call["pad"],
                             act=call["activation"], pool=call["pool_k"],
                             max_abs_err=err, scale=scale))
    print(f"phase 3: {len(rows)} conv checks against the plain version "
          f"passed; {n_fused} fused convs equal their unfused chain "
          f"bitwise; {n_batch} batch-4 launches equal four batch-1 "
          f"launches bitwise; worst abs err " + ", ".join(
              f"{k}/{d}={v:.3g}" for (k, d), v in sorted(worst.items())))
    return worst, rows


# ---------------------------------------------------------------------------
# Phase 4: codec vs plain
# ---------------------------------------------------------------------------
def boundary_shapes(cnn, core, profiles, batch=4, microbatches=4,
                    models=("alexnet", "mobilenetv2"), tiers=(3,)):
    """Boundary shapes of the int8 plans of ``models`` at ``batch`` split
    into ``microbatches``, over ``tiers`` (the main path's: K=3, M=4)."""
    shapes = set()
    for name in models:
        prof = profiles.cnn_profile(name, batch=batch)
        outs = cnn.shapes_through(cnn.CNN_MODELS[name])
        mb = -(-batch // microbatches)
        for k in tiers:
            plan = core.smartsplit_chain(prof, core.paper_chain(k),
                                         microbatches=microbatches,
                                         wire="int8")
            for cut in plan.cuts:
                shapes.add((mb,) + tuple(outs[cut - 1]))
    return sorted(shapes)


def codec_shapes(cnn, core, profiles):
    """The codec's checked and timed shapes: the main path's microbatch
    boundaries; every batch-4 boundary of the int8 plans of every model
    (K 2 and 3, unsplit batch); the per-tensor flattens of AlexNet and VGG's
    heads; and one shape where the planner takes k = 4, which no boundary
    above reaches."""
    micro = boundary_shapes(cnn, core, profiles)
    batch4 = boundary_shapes(cnn, core, profiles, microbatches=1,
                             models=tuple(cnn.CNN_MODELS), tiers=(2, 3))
    return micro, batch4 + [(4, 4096), (4, 9216)], [(4, 32, 56, 56)]


def quant_plan_of(kquant, torch, shape, dtype):
    axis = kquant.default_channel_axis(len(shape))
    return kquant.plan_quantize(*kquant._bcs(tuple(shape), axis), dtype)


def phase_codec(torch, kquant, ref, shapes, dev):
    """Returns the measured max |kernel - plain| of each codec and input
    dtype: the int8 values' and the scales' for quantize, the decoded
    values' for dequantize (0 when bitwise equal, which is checked), and
    the quantize plan (cluster size k, staged) of each shape."""
    gen = torch.Generator().manual_seed(2)
    worst, plans = {}, {}
    for shape in shapes:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x = (3 * torch.randn(shape, generator=gen)).to(dtype).to(dev)
            x[:, :1] = 0          # an all-zero group: scale 1.0
            axis = kquant.default_channel_axis(x.ndim)
            q, s = kquant.quantize_boundary(x)
            pq, ps = ref.quantize_plain(x, axis)
            d = kquant.dequantize_boundary(q, s, out_dtype=dtype)
            pd = ref.dequantize_plain(q, s, axis, dtype)
            errs = {"quantize": max(rel_err(q, pq)[0], rel_err(s, ps)[0]),
                    "dequantize": rel_err(d, pd)[0]}
            for name, err in errs.items():
                key = (name, dname)
                worst[key] = max(worst.get(key, 0.0), err)
            check(torch.equal(q, pq) and torch.equal(s, ps),
                  f"quantize {tuple(shape)} {dtype} differs from plain")
            check(torch.equal(d, pd),
                  f"dequantize {tuple(shape)} {dtype} differs from plain")
            plan = quant_plan_of(kquant, torch, shape, dtype)
            plans[(tuple(shape), dname)] = dict(
                k=plan.k, resident=plan.resident, vec=plan.vec,
                threads=plan.threads)
            check(plan.resident, f"quantize {tuple(shape)} {dname}: x read "
                  f"twice (the slice is not held in registers)")
    torch.cuda.synchronize()
    ks = sorted({p["k"] for p in plans.values()})
    check(ks == [1, 2, 4, 8], f"phase 4: cluster sizes {ks} checked, not "
          f"each of 1, 2, 4, 8")
    for shape in ((4, 4096), (4, 9216), (4, 32, 28, 28)):
        check(plans[(shape, "fp32")]["k"] > 1,
              f"quantize {shape}: a cluster of one CTA")
    print(f"phase 4: codec bitwise equal to the plain version, fp32 and "
          f"bf16, at (shape: cluster k) " + ", ".join(
              f"{s}: {plans[(s, 'fp32')]['k']}"
              for s in map(tuple, shapes)) + "; every slice held in "
          "registers")
    return worst, plans


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------
RUNS = [  # (label, argv after --cnn <model>)
    ("K2-follow", ["--tiers", "2", "--microbatch", "1",
                   "--wire-dtype", "follow", "--requests", "2"]),
    ("K3-M4-int8", ["--tiers", "3", "--microbatch", "4",
                    "--wire-dtype", "int8", "--requests", "2"]),
    ("K3-M4-drop30", ["--tiers", "3", "--microbatch", "4",
                      "--wire-dtype", "follow", "--drop", "0.3",
                      "--requests", "3"]),
]


def chain_reference(torch, cnn, quant, layers, params, x, plan_cuts, wires,
                    slices):
    """The fault-free logits of a chain run: each microbatch walks the
    stages, round-tripping the boundary through each hop's wire."""
    outs = []
    for a, b in slices:
        h = x[a:b]
        edges = [0, *plan_cuts, len(layers)]
        for k in range(len(edges) - 1):
            h = cnn.apply_cnn(layers, params, h, start=edges[k],
                              stop=edges[k + 1])
            if k < len(wires) and wires[k] != "fp32":
                h = quant.boundary_roundtrip(h, wires[k])
        outs.append(h)
    return torch.cat(outs)


def phase_main(torch, cnn, serve, launches, quant, runtime, dev):
    params = {m: cnn.init_cnn(cnn.CNN_MODELS[m], device=dev)
              for m in ("alexnet", "mobilenetv2")}
    torch.cuda.synchronize()
    results = []
    launches.reset()
    for model in ("alexnet", "mobilenetv2"):
        for label, argv in RUNS:
            args = serve.parse_args(["--cnn", model, "--batch", "4",
                                     "--device", dev.type, *argv])
            out = serve.serve_cnn(args, params=params[model])
            results.append((model, label, argv, out))
    counts = {n: launches.snapshot()[n] for n in CNN_KERNELS}
    print(f"phase 5: main path launches {json.dumps(counts)}")
    for name, n in counts.items():
        check(n > 0, f"{name} was never launched on the main path")

    summary = []
    cpu_params = {m: cnn.init_cnn(cnn.CNN_MODELS[m], device="cpu")
                  for m in params}
    for model, label, argv, out in results:
        r, rt = out["result"], out["runtime"]
        layers = cnn.CNN_MODELS[model]
        slices = runtime.microbatch_slices(out["x"].shape[0],
                                           rt.microbatches)
        int8 = "int8" in argv
        if int8:
            check(not r.degraded, f"{model} {label}: clean run degraded")
            want = chain_reference(torch, cnn, quant, layers, params[model],
                                   out["x"], r.cuts, rt.wire_dtypes, slices)
        else:
            want = torch.cat([cnn.apply_cnn(layers, params[model],
                                            out["x"][a:b])
                              for a, b in slices])
        check(torch.equal(r.logits, want),
              f"{model} {label}: split logits != monolithic on the card")
        args = serve.parse_args(["--cnn", model, "--batch", "4",
                                 "--device", "cpu", *argv])
        cpu = serve.serve_cnn(args, params=cpu_params[model], quiet=True)
        c = cpu["result"]
        check(c.cuts == r.cuts and c.attempts == r.attempts,
              f"{model} {label}: CPU run took another path")
        err, scale = rel_err(r.logits.cpu(), c.logits)
        top1 = bool(torch.equal(r.logits.float().argmax(1).cpu(),
                                c.logits.float().argmax(1)))
        if int8:
            check(top1, f"{model} {label}: top-1 differs from the CPU run")
        else:
            check(err <= LOGIT_TOL * scale,
                  f"{model} {label}: logits differ from the CPU run by "
                  f"{err} > {LOGIT_TOL} * {scale}")
        s = rt.stats()
        row = dict(model=model, run=label, cuts=list(r.cuts),
                   requests=s["requests"], seconds=out["seconds"],
                   ms_per_request=1e3 * out["seconds"] / s["requests"],
                   attempts=[h["attempts"] for h in s["hops"]],
                   dropped=[h["link"]["dropped"] for h in s["hops"]],
                   merges=s["merges"], repicks=s["repicks"],
                   cpu_max_abs_err=err, scale=scale, top1_equal=top1,
                   split_equals_monolithic=True, launches=out["launches"])
        summary.append(row)
        print(f"  {model} {label}: cuts={row['cuts']} "
              f"{row['ms_per_request']:.2f} ms/request (host clock) "
              f"split==monolithic bitwise, vs CPU max abs err {err:.3g} "
              f"(scale {scale:.3g}), top-1 equal {top1}")
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6: timing
# ---------------------------------------------------------------------------
class Timer:
    """Back-to-back launches of one call captured in a CUDA graph, timed
    with CUDA events: device time per call, without the host's launch
    overhead."""

    def __init__(self, torch, fn, reps=20):
        # warm up on a side stream (first-call set-up stays out of the
        # capture), then capture ``reps`` launches
        self.torch = torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(reps):
                fn()
        self.reps = reps
        self.graph.replay()
        torch.cuda.synchronize()

    def ms(self) -> float:
        t = self.torch
        a = t.cuda.Event(enable_timing=True)
        b = t.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / self.reps


def in_turns(timers: dict, rounds=2) -> dict:
    """Replay each timer in turns (a b c c b a ...) and average."""
    names = list(timers)
    total = dict.fromkeys(names, 0.0)
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            total[n] += timers[n].ms()
    return {n: total[n] / rounds for n in names}


def conv_bound(call, dtype):
    """(operations time at the rate of the kernel's arithmetic, bytes
    time, operations time at the CUDA-core fp32 rate), in seconds.  The
    depthwise kernel runs on the CUDA cores, so its first and last agree;
    the CUDA-core figure keeps the earlier CUDA-core kernels' bound
    comparable."""
    n, cin, h, w = call["x_shape"]
    cout, cin_pg, k, _ = call["w_shape"]
    ho = (h + 2 * call["pad"] - k) // call["stride"] + 1
    wo = (w + 2 * call["pad"] - k) // call["stride"] + 1
    po, pw = ho, wo
    if call["pool_k"]:
        po = (ho - call["pool_k"]) // call["pool_s"] + 1
        pw = (wo - call["pool_k"]) // call["pool_s"] + 1
    esize = 4 if dtype == "fp32" else 2
    flops = 2.0 * n * cout * ho * wo * cin_pg * k * k
    nbytes = esize * (n * cin * h * w + cout * cin_pg * k * k
                      + n * cout * po * pw) + 4 * cout
    depthwise = call["groups"] > 1 and call["groups"] == cin
    rate = PEAK_FLOPS["fp32"] if depthwise else CONV_PEAK[dtype]
    return flops / rate, nbytes / PEAK_BYTES, flops / PEAK_FLOPS["fp32"]


def codec_bound(n, groups, esize):
    """(operations time, bytes time) in seconds of quantize and dequantize
    of n elements in ``groups`` scale groups, storage ``esize`` bytes:
    quantize reads x, writes q and the scales, ~5 fp32 operations an
    element (abs, max, divide, round, clip); dequantize reads q and the
    scales, writes the storage dtype, one multiply an element."""
    return {"quantize": (5 * n / PEAK_FLOPS["fp32"],
                         (esize * n + n + 4 * groups) / PEAK_BYTES),
            "dequantize": (n / PEAK_FLOPS["fp32"],
                           (n + 4 * groups + esize * n) / PEAK_BYTES)}


def codec_time(torch, kquant, ref, shape, dname, dtype, gen, dev, agg, rows):
    """Kernel, plain and ``torch.mul`` times of quantize and dequantize at
    one shape and storage dtype; adds a row each and, in fp32, to the
    kernels line's sums (bf16 to its *_bf16 sums)."""
    x = (3 * torch.randn(shape, generator=gen)).to(dtype).to(dev)
    axis = kquant.default_channel_axis(x.ndim)
    q, s = kquant.quantize_boundary(x)
    # dequantize's library call: one broadcast multiply; int8 * fp32
    # promotes to fp32 and rounds the product once, as the kernel does
    # (quantize has none: torch.quantize_per_channel takes the scales as
    # given and multiplies by their reciprocal).  It writes fp32 at either
    # storage dtype: a bf16 result takes a second call.
    s_b = s.view([-1 if d == axis else 1 for d in range(x.ndim)])
    check(torch.equal(torch.mul(q, s_b), kquant.dequantize_boundary(q, s)),
          f"torch.mul dequantize {tuple(shape)} differs from the kernel")
    t = in_turns({
        "q_ms": Timer(torch, lambda: kquant.quantize_boundary(x)),
        "q_plain_ms": Timer(torch, lambda: ref.quantize_plain(x, axis)),
        "d_ms": Timer(torch, lambda: kquant.dequantize_boundary(
            q, s, out_dtype=dtype)),
        "d_plain_ms": Timer(torch, lambda: ref.dequantize_plain(
            q, s, axis, dtype)),
        "d_library_ms": Timer(torch, lambda: torch.mul(q, s_b))})
    t["q_library_ms"] = None
    plan = quant_plan_of(kquant, torch, shape, dtype)
    bounds = codec_bound(x.numel(), s.numel(), x.element_size())
    for kind, key in (("quantize", "q"), ("dequantize", "d")):
        t_f, t_b = bounds[kind]
        lib = t[f"{key}_library_ms"]
        row = dict(kernel=kind, dtype=dname, shape=list(shape),
                   ms=t[f"{key}_ms"], plain_ms=t[f"{key}_plain_ms"],
                   library_ms=lib, flop_ms=1e3 * t_f, byte_ms=1e3 * t_b,
                   bound_ms=1e3 * max(t_f, t_b),
                   **({"k": plan.k} if kind == "quantize" else {}))
        rows.append(row)
        a = agg.setdefault(kind, dict(
            ms=0.0, plain_ms=0.0, library_ms=None if lib is None else 0.0,
            flop_ms=0.0, byte_ms=0.0, bound_ms=0.0, calls=0, ms_bf16=0.0,
            bound_ms_bf16=0.0,
            library_ms_bf16=None if lib is None else 0.0))
        if dname == "bf16":
            a["ms_bf16"] += row["ms"]
            a["bound_ms_bf16"] += row["bound_ms"]
            if lib is not None:
                a["library_ms_bf16"] += lib
            continue
        for k in ("ms", "plain_ms", "flop_ms", "byte_ms", "bound_ms"):
            a[k] += row[k]
        if lib is not None:
            a["library_ms"] += lib
        a["calls"] += 1
    print(f"  codec {tuple(shape)} {dname} k={plan.k}: quantize "
          f"{t['q_ms'] * 1e3:.2f} us (bound {bounds['quantize'][1] * 1e6:.2f}"
          f", plain {t['q_plain_ms'] * 1e3:.2f}), dequantize "
          f"{t['d_ms'] * 1e3:.2f} us (bound "
          f"{bounds['dequantize'][1] * 1e6:.2f}, plain "
          f"{t['d_plain_ms'] * 1e3:.2f}, torch.mul "
          f"{t['d_library_ms'] * 1e3:.2f})")


def phase_time(torch, F, cnn, kconv, kquant, ref, shapes, dev):
    gen = torch.Generator().manual_seed(3)
    calls = []
    for name in ("alexnet", "mobilenetv2"):
        calls += [dict(c, model=name) for c in
                  cnn.conv_launches(cnn.CNN_MODELS[name], batch=4)]
    agg = {}
    rows = []
    for call in calls:
        kw = conv_kwargs(call)
        kind = "conv2d_depthwise" if call["groups"] > 1 \
            and call["groups"] == call["x_shape"][1] else "conv2d_dense"
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            x, w, b = make_inputs(torch, call, dtype, gen, dev)
            timers = {
                "ms": Timer(torch, lambda: kconv.conv2d(x, w, bias=b, **kw)),
                "library_ms": Timer(torch, lambda: F.conv2d(
                    x, w, b.to(dtype), stride=call["stride"],
                    padding=call["pad"], groups=call["groups"]))}
            if dname == "fp32":
                timers["plain_ms"] = Timer(
                    torch, lambda: ref.conv2d_plain(x, w, bias=b, **kw))
            t = in_turns(timers)
            t_f, t_b, t_cc = conv_bound(call, dname)
            row = dict(kernel=kind, dtype=dname, model=call["model"],
                       x=list(call["x_shape"]), w=list(call["w_shape"]),
                       stride=call["stride"], pad=call["pad"],
                       act=call["activation"], pool=call["pool_k"],
                       flop_ms=1e3 * t_f, byte_ms=1e3 * t_b,
                       bound_ms=1e3 * max(t_f, t_b),
                       cuda_core_flop_ms=1e3 * t_cc, **t)
            rows.append(row)
            a = agg.setdefault(kind, dict(
                ms=0.0, plain_ms=0.0, library_ms=0.0, flop_ms=0.0,
                byte_ms=0.0, bound_ms=0.0, bound_ms_cuda_cores=0.0,
                ms_bf16=0.0, library_ms_bf16=0.0, bound_ms_bf16=0.0,
                calls=0))
            if dname == "bf16":
                a["ms_bf16"] += row["ms"]
                a["library_ms_bf16"] += row["library_ms"]
                a["bound_ms_bf16"] += row["bound_ms"]
                continue
            for key in ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms",
                        "bound_ms"):
                a[key] += row[key]
            a["bound_ms_cuda_cores"] += 1e3 * max(t_cc, t_b)
            a["calls"] += 1
    for shape in shapes:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            codec_time(torch, kquant, ref, shape, dname, dtype, gen, dev,
                       agg, rows)
    return agg, rows


# ---------------------------------------------------------------------------
# Phase 7: the sequence kernels' path
# ---------------------------------------------------------------------------
def mixer_cases(configs, rwkv_hd):
    """The phase-7 calls, at the full widths of the three configs whose
    mixers the kernels compute; batch 2, 2048 tokens."""
    qwen, rwkv, zamba = (configs.get_config(n)
                         for n in ("qwen3-4b", "rwkv6-7b", "zamba2-7b"))
    inner = zamba.ssm_expand * zamba.d_model
    nh = zamba.n_mamba_heads
    attn = dict(kernel="flash_attention", B=2, causal=True)
    return [
        dict(attn, label="qwen3-4b", Sq=2048, Sk=2048, H=qwen.num_heads,
             KV=qwen.num_kv_heads, hd=qwen.hd),
        dict(attn, label="zamba2-7b shared attention", Sq=2048, Sk=2048,
             H=zamba.num_heads, KV=zamba.num_kv_heads, hd=zamba.hd),
        dict(attn, label="qwen3-4b Sq=128", Sq=128, Sk=2048,
             H=qwen.num_heads, KV=qwen.num_kv_heads, hd=qwen.hd),
        dict(kernel="rwkv6_wkv", label="rwkv6-7b", B=2, T=2000,
             H=rwkv.d_model // rwkv_hd, hd=rwkv_hd, block_t=64),
        dict(kernel="mamba2_ssd", label="zamba2-7b", B=2, T=2048, H=nh,
             hp=inner // nh, ds=zamba.ssm_state, G=zamba.ssm_groups,
             chunk=64),
    ]


# The small shapes of tests/test_kernels.py's sweeps (flash L27-38, WKV
# L144-148, SSD L184-188), GQA, a causal Sq > Sk case, ragged T and an
# SSD chunk of 96.
SMALL_MIXERS = [
    *(dict(kernel="flash_attention", label="sweep", B=1, Sq=sq, Sk=sk, H=bh,
           KV=bh, hd=hd, causal=causal, block_q=bq, block_k=bk)
      for bh, sq, sk, hd, causal, bq, bk in (
          (2, 128, 128, 64, True, 64, 64), (1, 128, 128, 128, True, 128, 128),
          (2, 128, 256, 64, False, 64, 64), (1, 64, 256, 32, True, 64, 128),
          (2, 128, 128, 80, True, 64, 64), (1, 256, 256, 128, True, 128, 128),
          (1, 64, 384, 32, True, 64, 128), (3, 192, 192, 80, True, 64, 64))),
    dict(kernel="flash_attention", label="gqa4", B=2, Sq=128, Sk=128, H=8,
         KV=2, hd=64, causal=True, block_q=64, block_k=64),
    dict(kernel="flash_attention", label="sq>sk causal", B=1, Sq=192, Sk=64,
         H=4, KV=2, hd=96, causal=True, block_q=64, block_k=64),
    *(dict(kernel="rwkv6_wkv", label="sweep", B=b, T=t, H=h, hd=hd,
           block_t=bt)
      for b, t, h, hd, bt in ((2, 128, 2, 32, 32), (1, 96, 4, 64, 32),
                              (3, 64, 1, 16, 64))),
    dict(kernel="rwkv6_wkv", label="ragged T", B=1, T=50, H=2, hd=16,
         block_t=32),
    *(dict(kernel="mamba2_ssd", label="sweep", B=b, T=t, H=h, hp=hp, ds=ds,
           G=h, chunk=chunk)
      for b, t, h, hp, ds, chunk in ((2, 128, 2, 16, 8, 32),
                                     (1, 64, 4, 32, 16, 64),
                                     (2, 96, 1, 64, 64, 32))),
    dict(kernel="mamba2_ssd", label="ragged T", B=2, T=50, H=2, hp=16, ds=8,
         G=2, chunk=32),
    # chunk > 64: att in its own tile, strips and column groups looped
    dict(kernel="mamba2_ssd", label="chunk 96", B=1, T=192, H=2, hp=80,
         ds=72, G=2, chunk=96),
]


def wkv_stage_cases(torch, plan_wkv, hd):
    """WKV at head dim ``hd`` with T inside one stage of the kernel's plan
    and T past three stages but not a multiple of the plan's steps, in
    both storage dtypes' plans."""
    steps = [plan_wkv(1, 4096, 1, hd, d).steps
             for d in (torch.float32, torch.bfloat16)]
    short, ragged = min(steps) // 2 + 1, 3 * max(steps) + 5
    check(short < min(steps) and all(ragged % s for s in steps),
          f"WKV stage cases: T {short} and {ragged} against steps {steps}")
    return [dict(kernel="rwkv6_wkv", label="T < a stage", B=2, T=short, H=8,
                 hd=hd, block_t=64),
            dict(kernel="rwkv6_wkv", label="T % steps", B=1, T=ragged, H=16,
                 hd=hd, block_t=64)]


def mixer_inputs(torch, case, dtype, gen, dev):
    """Seeded inputs on the card, made in fp32 and stored in ``dtype``."""
    F = torch.nn.functional

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    B = case["B"]
    if case["kernel"] == "flash_attention":
        q = randn(B, case["Sq"], case["H"], case["hd"])
        k, v = (randn(B, case["Sk"], case["KV"], case["hd"])
                for _ in range(2))
        return tuple(t.to(dtype) for t in (q, k, v))
    if case["kernel"] == "rwkv6_wkv":
        shape = (B, case["T"], case["H"], case["hd"])
        r, k, v = (randn(*shape, scale=0.3) for _ in range(3))
        w = torch.sigmoid(randn(*shape)) * 0.5 + 0.45
        u = randn(case["H"], case["hd"], scale=0.1)
        return tuple(t.to(dtype) for t in (r, k, v, w, u))
    T, H = case["T"], case["H"]
    x = randn(B, T, H, case["hp"], scale=0.5)
    dt = F.softplus(randn(B, T, H))
    A = -torch.exp(randn(H, scale=0.3))
    # B and C per group, repeated to the heads as the model's layer does
    Bm, Cm = (randn(B, T, case["G"], case["ds"], scale=0.4)
              .repeat_interleave(H // case["G"], dim=2) for _ in range(2))
    return x.to(dtype), dt.to(dtype), A, Bm.to(dtype), Cm.to(dtype)


def call_mixer(kops, case, args):
    if case["kernel"] == "flash_attention":
        return kops.flash_attention_gqa(
            *args, causal=case["causal"], block_q=case.get("block_q", 128),
            block_k=case.get("block_k", 128))
    if case["kernel"] == "rwkv6_wkv":
        return kops.rwkv6_wkv(*args, block_t=case["block_t"])
    return kops.mamba2_ssd(*args, chunk=case["chunk"])


def plain_mixer(ref, case, args):
    if case["kernel"] == "flash_attention":
        return ref.attention_plain(*args, causal=case["causal"])
    if case["kernel"] == "rwkv6_wkv":
        return ref.rwkv6_wkv_plain(*args)
    return ref.mamba2_ssd_plain(*args, chunk=case["chunk"])


def mixer_out_shape(case):
    if case["kernel"] == "flash_attention":
        return (case["B"], case["Sq"], case["H"], case["hd"])
    if case["kernel"] == "rwkv6_wkv":
        return (case["B"], case["T"], case["H"], case["hd"])
    return (case["B"], case["T"], case["H"], case["hp"])


DTYPES = (("fp32", "float32"), ("bf16", "bfloat16"))


def phase_mixers(torch, kops, launches, cases, dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    inputs = {(i, d): mixer_inputs(torch, case, getattr(torch, tname), gen,
                                   dev)
              for i, case in enumerate(cases) for d, tname in DTYPES}
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    outs = {key: call_mixer(kops, cases[key[0]], args)
            for key, args in inputs.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches.snapshot()
    print(f"phase 7: sequence kernels' path launches "
          f"{json.dumps({n: counts[n] for n in MIXERS})} "
          f"({seconds:.2f} s host clock, first calls included)")
    for name in MIXERS:
        check(counts[name] > 0, f"{name} was never launched on its path")
    for (i, d), y in outs.items():
        case = cases[i]
        check(tuple(y.shape) == mixer_out_shape(case)
              and y.dtype == inputs[(i, d)][0].dtype,
              f"{case['label']} {d}: output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()),
              f"{case['label']} {d}: non-finite output")
    return inputs, outs, counts


# ---------------------------------------------------------------------------
# Phase 8: sequence kernels vs plain
# ---------------------------------------------------------------------------
def phase_mixer_checks(torch, kops, ref, cases, inputs, outs, small, dev):
    worst, worst_rel = {}, {}
    rows = []

    def hold(case, d, got, args):
        want = plain_mixer(ref, case, args)
        torch.cuda.synchronize()
        err, rel = row_err(got, want)
        tol = MIXER_TOL[(case["kernel"], d)]
        check(rel <= tol,
              f"{case['kernel']} {case['label']} {d} {mixer_out_shape(case)}"
              f": error {rel} of its row's scale > {tol} (max abs {err})")
        key = (case["kernel"], d)
        worst[key] = max(worst.get(key, 0.0), err)
        worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
        rows.append(dict(case, dtype=d, max_abs_err=err, max_row_rel_err=rel))

    for (i, d), args in inputs.items():
        hold(cases[i], d, outs[(i, d)], args)
    gen = torch.Generator(device=dev).manual_seed(5)
    for case in small:
        for d, tname in DTYPES:
            args = mixer_inputs(torch, case, getattr(torch, tname), gen, dev)
            hold(case, d, call_mixer(kops, case, args), args)
    # the Sq > Sk rows with no visible key: the mean of V, from the kernel
    case = next(c for c in small if c["label"] == "sq>sk causal")
    q, k, v = mixer_inputs(torch, case, torch.float32, gen, dev)
    y = call_mixer(kops, case, (q, k, v))
    blind = case["Sq"] - case["Sk"]
    mean_v = v.mean(dim=1).repeat_interleave(case["H"] // case["KV"], dim=1)
    err = float((y[:, :blind] - mean_v[:, None]).abs().max())
    check(err <= FP32_TOL, f"flash rows with no visible key: {err} from "
          f"mean(V)")
    print(f"phase 8: {len(rows)} sequence-kernel checks against the plain "
          f"version passed; rows with no visible key = mean(V) to {err:.3g}; "
          f"worst abs err " + ", ".join(
              f"{k}/{d}={v:.3g}" for (k, d), v in sorted(worst.items()))
          + "; worst err over its row's scale " + ", ".join(
              f"{k}/{d}={v:.3g}" for (k, d), v in sorted(worst_rel.items())))
    return worst, rows


def mixer_bound(case, dname):
    """(FLOP time at the rate of the kernel's arithmetic, byte time, FLOP
    time at the CUDA-core fp32 rate) in seconds of one call: each input
    read once and each output written once; FLOPs of the work this call's
    data needs (visible query-key pairs; the causal half of each SSD
    chunk)."""
    e = 4 if dname == "fp32" else 2
    B = case["B"]
    if case["kernel"] == "flash_attention":
        Sq, Sk, H, KV, hd = (case[n] for n in ("Sq", "Sk", "H", "KV", "hd"))
        if case["causal"]:
            # a row with no visible key still averages every key
            pairs = sum(min(Sk, r + Sk - Sq + 1) if r + Sk - Sq >= 0 else Sk
                        for r in range(Sq))
        else:
            pairs = Sq * Sk
        flops = 4.0 * hd * pairs * B * H
        nbytes = e * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    elif case["kernel"] == "rwkv6_wkv":
        T, H, hd = case["T"], case["H"], case["hd"]
        # k v^T (hd^2), S w + k v^T and r^T S (2 hd^2 each as FMAs); the
        # bonus term factors as v_j * sum_i r_i u_i k_i: 5 hd more
        flops = (5.0 * hd * hd + 5.0 * hd) * B * T * H
        nbytes = e * 5 * B * T * H * hd + e * H * hd
    else:
        T, H, hp, ds, L = (case[n] for n in ("T", "H", "hp", "ds", "chunk"))
        n = -(-T // L)
        pairs = L * (L + 1) // 2
        flops = B * H * n * (2.0 * pairs * (ds + hp) + 4.0 * L * hp * ds)
        nbytes = e * B * T * H * (2 * hp + 2 * ds + 1) + 4 * H
    return (flops / MIXER_PEAK[case["kernel"]][dname], nbytes / PEAK_BYTES,
            flops / PEAK_FLOPS["fp32"])


def sdpa_call(torch, F, case, args):
    """One ``F.scaled_dot_product_attention`` call computing the kernel's
    function on its (B, S, heads, hd) inputs: GQA, the end-aligned causal
    mask given explicitly where Sq != Sk (SDPA's is_causal is top-left
    aligned; every row of the phase-7 calls sees a key)."""
    qh, kh, vh = (t.transpose(1, 2) for t in args)
    Sq, Sk = case["Sq"], case["Sk"]
    mask = None
    if Sq != Sk:
        qpos = torch.arange(Sq, device=qh.device)[:, None]
        kpos = torch.arange(Sk, device=qh.device)[None, :]
        mask = kpos <= qpos + (Sk - Sq)

    def lib():
        return F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
    return lib


def phase_time_mixers(torch, F, kops, ref, cases, inputs):
    """Kernel, plain and library times of every phase-7 call, fp32 and
    bf16; the aggregates feed the kernels line (fp32 keys, and *_bf16)."""
    agg, rows = {}, []
    plain_reps = {"flash_attention": 3, "rwkv6_wkv": 1, "mamba2_ssd": 3}
    for (i, d), args in inputs.items():
        case = cases[i]
        name = case["kernel"]
        timers = {
            "ms": Timer(torch, lambda: call_mixer(kops, case, args), reps=5),
            "plain_ms": Timer(torch, lambda: plain_mixer(ref, case, args),
                              reps=plain_reps[name])}
        lib_err = None
        if name == "flash_attention":
            lib = sdpa_call(torch, F, case, args)
            lib_err, rel = row_err(lib().transpose(1, 2),
                                   call_mixer(kops, case, args))
            tol = 1e-3 if d == "fp32" else BF16_TOL
            check(rel <= tol,
                  f"SDPA {case['label']} {d} differs from the kernel by "
                  f"{rel} of its row's scale (max abs {lib_err})")
            timers["library_ms"] = Timer(torch, lib, reps=5)
        t = in_turns(timers)
        t.setdefault("library_ms", None)
        t_f, t_b, t_cc = mixer_bound(case, d)
        row = dict(case, dtype=d, flop_ms=1e3 * t_f, byte_ms=1e3 * t_b,
                   bound_ms=1e3 * max(t_f, t_b),
                   bound_ms_cuda_cores=1e3 * max(t_cc, t_b),
                   library_max_abs_err=lib_err, **t)
        rows.append(row)
        a = agg.setdefault(name, dict(
            ms=0.0, plain_ms=0.0, flop_ms=0.0, byte_ms=0.0, bound_ms=0.0,
            calls=0, library_ms=None if t["library_ms"] is None else 0.0,
            ms_bf16=0.0, bound_ms_bf16=0.0,
            library_ms_bf16=None if t["library_ms"] is None else 0.0,
            **({"bound_ms_cuda_cores": 0.0}
               if name in TENSOR_CORE_MIXERS else {})))
        if d != "fp32":
            a["ms_bf16"] += row["ms"]
            a["bound_ms_bf16"] += row["bound_ms"]
            if a["library_ms_bf16"] is not None:
                a["library_ms_bf16"] += t["library_ms"]
            continue
        for key in ("ms", "plain_ms", "flop_ms", "byte_ms", "bound_ms"):
            a[key] += row[key]
        if "bound_ms_cuda_cores" in a:
            a["bound_ms_cuda_cores"] += row["bound_ms_cuda_cores"]
        a["calls"] += 1
        if a["library_ms"] is not None:
            # every call of a kernel with a library call has it timed
            a["library_ms"] += t["library_ms"]
    return agg, rows


# ---------------------------------------------------------------------------
# Phase 9: the CNN stream path
# ---------------------------------------------------------------------------
STREAM_ARGS = ["--concurrency", "16", "--max-batch", "4"]
STREAM_RUNS = [  # (label, argv after --cnn <model> STREAM_ARGS)
    ("K3-int8", ["--tiers", "3", "--wire-dtype", "int8"]),
    ("K2-follow-seq", ["--tiers", "2", "--wire-dtype", "follow",
                       "--no-pipeline"]),
    ("K3-int8-drop30", ["--tiers", "3", "--wire-dtype", "int8",
                        "--drop", "0.3"]),
    ("K3-int8-crash", ["--tiers", "3", "--wire-dtype", "int8",
                       "--tier-faults", "crash"]),
]


def stream_kernels(model: str, argv: list) -> list[str]:
    """The kernels a stream run must launch."""
    names = ["conv2d_dense"]
    if model == "mobilenetv2":
        names.append("conv2d_depthwise")
    if "int8" in argv:
        names += ["quantize", "dequantize"]
    return names


def request_reference(torch, cnn, quant, layers, params, req, rt):
    """The logits of a request's sample alone, at batch 1, through the
    chain under the cuts its batch planned and under the cuts it finished
    under (a stage merge or a failover inside a batch moves the later
    requests to the latter), each boundary round-tripped through the
    wire (one format on every hop).  One of them must equal the served
    logits bitwise."""
    res = req.result
    wire = set(rt.wire_dtypes)
    check(len(wire) == 1, f"phase 9: hops ship {wire}, not one format")
    return [chain_reference(torch, cnn, quant, layers, params, req.x[None],
                            cuts, [*wire] * len(cuts), [(0, 1)])[0]
            for cuts in dict.fromkeys((tuple(res.planned_cuts),
                                       tuple(res.cuts)))]


def phase_stream(torch, cnn, serve, launches, quant, dev):
    """``serve_cnn_stream`` for AlexNet and MobileNetV2 at 224 px, 16
    single-sample requests at batch buckets of 4, each of STREAM_RUNS
    after an untimed warm-up of all of them (the timed runs' shapes), with
    the launch counts set to 0 just before and read just after.
    Checks (a) every served request of a pipelined run bitwise equal to
    its sample alone through the chain at batch 1 on the card, (b) each
    run's kernels launched, (c) each run's ``stats()`` equal to the same
    stream's on the CPU (counts, virtual times, hop bytes), and every
    request's logits within 1e-3 of the CPU's (follow wire) or of the same
    top-1 (int8 wire)."""
    models = ("alexnet", "mobilenetv2")
    params = {m: cnn.init_cnn(cnn.CNN_MODELS[m], device=dev) for m in models}
    cpu_params = {m: cnn.init_cnn(cnn.CNN_MODELS[m], device="cpu")
                  for m in models}
    for model in models:        # warm-up: every timed run's shapes once
        for _, argv in STREAM_RUNS:
            args = serve.parse_args(["--cnn", model, *STREAM_ARGS, *argv,
                                     "--device", dev.type])
            serve.serve_cnn_stream(args, params=params[model], quiet=True)
    torch.cuda.synchronize()
    outs = []
    launches.reset()
    for model in models:
        for label, argv in STREAM_RUNS:
            args = serve.parse_args(["--cnn", model, *STREAM_ARGS, *argv,
                                     "--device", dev.type])
            outs.append((model, label, argv,
                         serve.serve_cnn_stream(args, params=params[model])))
    counts = {n: launches.snapshot()[n] for n in CNN_KERNELS}
    print(f"phase 9: stream path launches {json.dumps(counts)}")
    rows = []
    for model, label, argv, out in outs:
        eng, reqs = out["engine"], out["requests"]
        what = f"phase 9 {model} {label}"
        for name in stream_kernels(model, argv):
            check(out["launches"][name] > 0,
                  f"{what}: {name} was never launched")
        s = eng.stats()
        check(s["served"] > 0, f"{what}: nothing served")
        layers = cnn.CNN_MODELS[model]
        bitwise = 0
        if eng.pipelined:
            for req in reqs:
                if req.status != "served":
                    continue
                rt = eng._buckets[req.bucket].rt
                refs = request_reference(torch, cnn, quant, layers,
                                         params[model], req, rt)
                check(any(torch.equal(req.logits, r) for r in refs),
                      f"{what}: request {req.rid} differs from its sample "
                      f"alone through the chain at batch 1")
                bitwise += 1
        args = serve.parse_args(["--cnn", model, *STREAM_ARGS, *argv,
                                 "--device", "cpu"])
        cpu = serve.serve_cnn_stream(args, params=cpu_params[model],
                                     quiet=True)
        cs = cpu["engine"].stats()
        diff = sorted(k for k in set(s) | set(cs) if s.get(k) != cs.get(k))
        check(not diff, f"{what}: stats() differ from the CPU's at {diff}")
        worst, top1 = 0.0, True
        for a, b in zip(reqs, cpu["requests"]):
            check(a.status == b.status, f"{what}: request {a.rid} "
                  f"{a.status} on the card, {b.status} on the CPU")
            if a.logits is None:
                continue
            check(bool(torch.isfinite(a.logits).all()),
                  f"{what}: non-finite logits")
            err, scale = rel_err(a.logits.cpu(), b.logits)
            worst = max(worst, err / scale)
            top1 = top1 and int(a.logits.argmax()) == int(b.logits.argmax())
        if "int8" in argv:
            check(top1, f"{what}: a top-1 differs from the CPU run")
        else:
            check(worst <= LOGIT_TOL, f"{what}: logits differ from the "
                  f"CPU run by {worst} of scale > {LOGIT_TOL}")
        row = dict(model=model, run=label, served=s["served"],
                   submitted=s["submitted"], failed=s["failed"],
                   batches=s["batches"], pipelined=s["pipelined"],
                   wall_s=out["seconds"],
                   wall_ms_per_request=1e3 * out["seconds"] / s["served"],
                   virtual_requests_per_s=s["requests_per_s"],
                   virtual_p50_s=s["latency_p50_s"],
                   virtual_p99_s=s["latency_p99_s"],
                   repicks=s["repicks"], merges=s["merges"],
                   failovers=s["failovers"],
                   dropped=[h["link"]["dropped"] for h in s["hops"]],
                   bitwise_requests=bitwise, cpu_rel_err=worst,
                   top1_equal=top1, stats_equal_cpu=True,
                   launches=out["launches"])
        rows.append(row)
        print(f"  {model} {label}: {s['served']}/{s['submitted']} served in "
              f"{s['batches']} batches, {row['wall_ms_per_request']:.2f} "
              f"wall ms/request (host clock); virtual "
              f"{s['requests_per_s']:.1f} req/s, p50 "
              f"{s['latency_p50_s'] * 1e3:.1f} ms, p99 "
              f"{s['latency_p99_s'] * 1e3:.1f} ms (virtual clock); "
              f"merges={s['merges']} failovers={s['failovers']}; "
              f"{bitwise} requests bitwise, stats == CPU, "
              f"vs CPU {worst:.3g} of scale")
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 10: the transformer decode path
# ---------------------------------------------------------------------------
DECODE_TOL = 1e-3
BLOCK_KINDS = [  # (config, layers kept, forward only)
    ("rwkv6-7b", 2, False),
    ("zamba2-7b", 6, False),        # one application of the shared block
    ("granite-moe-3b-a800m", 2, False),
    ("hubert-xlarge", 2, True),
]


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    return tree.numel()


def phase_decode(torch, configs, T, Engine, launches, dev):
    """(a) Qwen3-4B at full width and depth, fp32 weights from a seeded
    generator on the card, serving 8 greedy requests of 8-24 prompt
    tokens, 8 new tokens each, through ``serving.engine.Engine`` (timed
    on a second engine, after a first has served the same prompts, and
    emitting the same tokens); prefill of n+1 tokens against prefill of n plus
    one ``decode_step`` on the last token's logits.  (b) one config of
    each other block kind at full width and a cut depth, its prefill
    logits and one decode step held against the same weights on the CPU,
    and the MoE prefill run twice on the card, bitwise.  No kernel of the
    port runs on this path: every launch count stays 0."""
    import dataclasses

    import numpy as np

    launches.reset()
    rng = np.random.default_rng(0)
    cfg = configs.all_configs()["qwen3-4b"]
    params = T.init_params(cfg, 0, torch.float32, dev)
    n_params = tree_numel(params)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.choice([8, 16, 24]))).tolist()
               for _ in range(8)]

    def serve_prompts():
        eng = Engine(cfg, params, max_len=128, max_batch=4, device=dev)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t0

    _, warm, _ = serve_prompts()        # warm-up on the timed shapes
    eng, reqs, dt = serve_prompts()
    check([r.output for r in reqs] == [r.output for r in warm],
          "phase 10 qwen3-4b: two runs of the same prompts emit different "
          "tokens")
    toks = sum(len(r.output) for r in reqs)
    check(toks == 64 and all(0 <= t < cfg.padded_vocab
                             for r in reqs for t in r.output),
          f"phase 10 qwen3-4b: {toks} tokens served, or a token out of range")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 17)),
                          device=dev)
    full, _, _ = T.forward(cfg, params, {"tokens": tok}, mode="prefill",
                           cache=T.init_cache(cfg, 2, 128, torch.float32, dev))
    _, cache, _ = T.forward(cfg, params, {"tokens": tok[:, :16]},
                            mode="prefill",
                            cache=T.init_cache(cfg, 2, 128, torch.float32, dev))
    step, _ = T.decode_step(cfg, params, tok[:, 16:], cache)
    _, rel = row_err(step[:, -1], full[:, -1])
    check(rel <= DECODE_TOL, f"phase 10 qwen3-4b: prefill + decode_step "
          f"differs from the longer prefill by {rel} of a row's scale")
    # a batch (one length bucket of up to 4 prompts) is one prefill and 7
    # decode steps: tokens/s depends on how the prompts' lengths bucket,
    # ms a pass does not
    batches = int(eng.stats["batches"])
    passes = batches * 8
    qwen = dict(config="qwen3-4b", params=n_params, requests=len(reqs),
                batches=batches, passes=passes, tokens=toks, seconds=dt,
                tokens_per_s=toks / dt, ms_per_pass=1e3 * dt / passes,
                decode_vs_prefill_rel_err=rel,
                peak_bytes=torch.cuda.max_memory_allocated(dev))
    print(f"phase 10: qwen3-4b full width and depth ({n_params / 1e9:.2f} B "
          f"parameters, fp32): {len(reqs)} requests, {toks} tokens in "
          f"{batches} batches, {dt:.2f} s, {toks / dt:.1f} tokens/s, "
          f"{1e3 * dt / passes:.1f} ms a pass (host clock, {card_line()}); "
          f"decode == prefill to {rel:.3g} of scale")
    del params, eng, full, cache, step
    torch.cuda.empty_cache()

    rows = [qwen]
    for name, n_layers, fwd_only in BLOCK_KINDS:
        cfg = dataclasses.replace(configs.all_configs()[name],
                                  num_layers=n_layers)
        params = T.init_params(cfg, 0, torch.float32, dev)
        cpu_params = tree_to(params, "cpu")
        B, S = 2, 16
        if cfg.frontend == "audio":
            frames = rng.normal(size=(B, S, cfg.d_model)) * 0.02
            batch = {"prefix_embeds": torch.as_tensor(frames,
                                                      dtype=torch.float32)}
        else:
            batch = {"tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (B, S)))}
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)))
        outs = {}
        for where, p in (("card", params), ("cpu", cpu_params)):
            d = dev if where == "card" else torch.device("cpu")
            b = {k: v.to(d) for k, v in batch.items()}
            cache = None if fwd_only \
                else T.init_cache(cfg, B, 32, torch.float32, d)
            logits, cache, _ = T.forward(cfg, p, b, mode="prefill",
                                         cache=cache)
            outs[where] = [logits.cpu()]
            if not fwd_only:
                lg, _ = T.decode_step(cfg, p, nxt.to(d), cache)
                outs[where].append(lg.cpu())
            if where == "card" and cfg.num_experts:
                again, _, _ = T.forward(cfg, p, b, mode="prefill",
                                        cache=None if fwd_only else
                                        T.init_cache(cfg, B, 32,
                                                     torch.float32, d))
                check(torch.equal(again, logits), f"phase 10 {name}: two "
                      f"card prefills differ (the MoE combine order)")
        errs = []
        for got, want in zip(outs["card"], outs["cpu"]):
            check(bool(torch.isfinite(got).all()),
                  f"phase 10 {name}: non-finite logits")
            errs.append(row_err(got, want)[1])
        check(max(errs) <= DECODE_TOL, f"phase 10 {name}: the card differs "
              f"from the CPU by {errs} of a row's scale")
        rows.append(dict(config=name, layers=n_layers,
                         params=tree_numel(params), prefill_rel_err=errs[0],
                         decode_rel_err=errs[1] if len(errs) > 1 else None))
        print(f"  {name} ({n_layers} layers, full width): card == CPU to "
              f"{', '.join(f'{e:.3g}' for e in errs)} of scale "
              f"({'prefill' if fwd_only else 'prefill, decode step'})")
        del params, cpu_params
        torch.cuda.empty_cache()
    counts = launches.snapshot()
    check(not any(counts.values()), f"phase 10 launched kernels {counts}: "
          f"the decode path's mixers are plain torch")
    return rows


# ---------------------------------------------------------------------------
# Phase 12: the SmartSplit executors across devices
# ---------------------------------------------------------------------------
SPLIT_BATCH, SPLIT_SEQ, SPLIT_MICRO = 4, 128, 4
SPLIT_WIRES = ("follow", "bf16", "int8")
SPLIT_BF16_TOL = 5e-2
SPLIT_INT8_CPU_TOL = 1e-2
EP_TOL = 1e-5
EP_CPU_TOL = 1e-4
EP_CAPACITY = 8.0       # drop-free in both dispatches, as tests/test_moe_ep.py
# the codec at the split's per-feature boundary, the (B*S, d, 1) view of
# Qwen3-4B's (4, 128, 2560) hidden state: whole batch and a microbatch
SPLIT_CODEC_SHAPES = [(512, 2560, 1), (128, 2560, 1)]


def split_cuts(configs, core, profiles):
    """The planner's l1 for Qwen3-4B's prefill profile at seq 128, batch 4
    (``smartsplit(prof, TPU_EDGE_CLOUD)``, as ``serve --plan-split``
    plans), l1 = 1 and 35 (one block on either side) and 18 (halves)."""
    cfg = configs.all_configs()["qwen3-4b"]
    prof = profiles.transformer_profile(cfg, seq_len=SPLIT_SEQ,
                                        batch=SPLIT_BATCH, mode="prefill",
                                        dtype_bytes=4)
    planned = core.smartsplit(prof, core.TPU_EDGE_CLOUD).split_index
    return planned, sorted({planned, 1, 18, 35})


def top1_agrees(got, want) -> tuple[bool, int]:
    """(every position whose top-2 margin in ``want`` exceeds twice its
    row's largest |got - want| has the same top-1 in both; the number of
    positions too close to call)."""
    g, w = got.float().reshape(-1, got.shape[-1]), \
        want.float().reshape(-1, want.shape[-1])
    top2 = w.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * (g - w).abs().amax(dim=-1)
    same = g.argmax(-1) == w.argmax(-1)
    return bool(same[decided].all()), int((~decided).sum())


def phase_split(torch, configs, core, profiles, T, X, M, launches, dev):
    """(a) Qwen3-4B at full width and depth, fp32, batch 4 x 128 seeded
    tokens, split two ways with both pods on the one card (each on its
    own stream) by ``launch.smartsplit_exec.two_stage_apply`` at every cut
    of ``split_cuts``, on the follow, bf16 and int8 wires, un-pipelined
    and pipelined over 4 microbatches, with the launch counts set to 0
    just before and read just after: the follow split equals the
    monolithic ``forward`` bitwise, pipelined ``forward`` of each
    microbatch; bf16 within 5e-2 of a row's scale; int8 finite, through
    the codec kernels once a boundary crossing.  Then ms per split
    forward (host clock to a synchronize, warm, in turns) against the
    monolithic forward (whole, and a microbatch at a time), and the peak
    memory.  (b) Qwen3-4B cut to 4
    layers, l1 = 2: the card against the CPU, 1e-3 of a row's scale
    (follow) and the same top-1 where the CPU's margin decides it (int8).
    (c) Granite-MoE-3B at full width and 2 layers, batch 4 x 128,
    capacity factor 8, expert-parallel on a (2, 4) data x model debug
    mesh on the card: each MoE layer within 1e-5 of a row's scale of the
    local dispatch, a second run bitwise equal, the card within 1e-4 of
    the same EP on the CPU; the model's logits EP against local.  No
    kernel launches in (c)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import moe_ep

    out = {}
    rng = np.random.default_rng(12)
    planned, cuts = split_cuts(configs, core, profiles)
    cfg = configs.all_configs()["qwen3-4b"]
    params = T.init_params(cfg, 0, torch.float32, dev)
    mesh = M.make_debug_mesh((2,), ("pod",), device=dev)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (SPLIT_BATCH, SPLIT_SEQ)), device=dev)
    bm = SPLIT_BATCH // SPLIT_MICRO

    def split(l1, wire, piped, c=cfg, p=params, t=tok, m=mesh):
        return X.two_stage_apply(c, p, t, m, l1, pipelined=piped,
                                 microbatches=SPLIT_MICRO, wire_dtype=wire)

    # -- (a) --------------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        mono = T.forward(cfg, params, {"tokens": tok}, mode="prefill")[0]
        mono_mb = torch.cat([T.forward(cfg, params, {
            "tokens": tok[i * bm:(i + 1) * bm]}, mode="prefill")[0]
            for i in range(SPLIT_MICRO)])
        launches.reset()
        runs = []
        for l1 in cuts:
            for wire in SPLIT_WIRES:
                for piped in (False, True):
                    got = split(l1, wire, piped)
                    what = f"phase 12 qwen3-4b l1={l1} {wire} " \
                        f"{'pipelined' if piped else 'un-pipelined'}"
                    check(got.shape == mono.shape and got.dtype ==
                          torch.float32 and bool(torch.isfinite(got).all()),
                          f"{what}: logits {tuple(got.shape)} {got.dtype}, "
                          f"or not finite")
                    want = mono_mb if piped else mono
                    _, rel = row_err(got, want)
                    same, close = top1_agrees(got, want)
                    if wire == "follow":
                        check(torch.equal(got, want), f"{what}: differs "
                              f"from the monolithic forward by {rel} of a "
                              f"row's scale")
                    elif wire == "bf16":
                        check(rel <= SPLIT_BF16_TOL, f"{what}: {rel} of a "
                              f"row's scale from the monolithic forward")
                    runs.append(dict(l1=l1, wire=wire, pipelined=piped,
                                     rel_err=rel, top1_decided_agree=same,
                                     top1_too_close=close))
                    del got
        torch.cuda.synchronize()
        counts = launches.snapshot()
    crossings = len(cuts) * (1 + SPLIT_MICRO)
    check(counts["quantize"] == crossings and
          counts["dequantize"] == crossings and
          not any(v for k, v in counts.items()
                  if k not in ("quantize", "dequantize")),
          f"phase 12: split path launches {counts}, not {crossings} "
          f"quantize and dequantize (one a boundary crossing of the int8 "
          f"runs) and nothing else")
    int8_err = max(r["rel_err"] for r in runs if r["wire"] == "int8")
    bf16_err = max(r["rel_err"] for r in runs if r["wire"] == "bf16")
    int8_top1 = all(r["top1_decided_agree"] for r in runs
                    if r["wire"] == "int8")
    print(f"phase 12: split path launches {json.dumps(counts)}")
    print(f"phase 12: qwen3-4b full width and depth, batch {SPLIT_BATCH} x "
          f"{SPLIT_SEQ}, both pods on one card: l1 in {cuts} (planner "
          f"{planned}); follow split == monolithic bitwise, pipelined (m="
          f"{SPLIT_MICRO}) == monolithic a microbatch bitwise; bf16 within "
          f"{bf16_err:.3g}, int8 within {int8_err:.3g} of a row's scale "
          f"(int8 top-1 equal where decided: {int8_top1})")

    def host_ms(fn, reps=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    with torch.no_grad():
        # the monolithic forward whole and a microbatch at a time (what
        # the pipelined split computes, without its second stream)
        timers = {"monolithic": lambda: T.forward(cfg, params,
                                                   {"tokens": tok},
                                                   mode="prefill"),
                  "monolithic a microbatch at a time": lambda: [
                      T.forward(cfg, params, {"tokens": tok[i * bm:(i + 1)
                                                            * bm]},
                                mode="prefill") for i in range(SPLIT_MICRO)]}
        for l1 in sorted({planned, 18}):
            for wire in ("follow", "int8"):
                for piped in (False, True):
                    timers[f"l1={l1} {wire}"
                           f"{' pipelined' if piped else ''}"] = \
                        (lambda l1=l1, wire=wire, piped=piped:
                         split(l1, wire, piped))
        for fn in timers.values():
            fn()                                        # warm
        total = dict.fromkeys(timers, 0.0)
        for r in range(2):
            for name in (list(timers) if r == 0 else list(timers)[::-1]):
                total[name] += host_ms(timers[name]) / 2
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = tree_numel(params)
    out["qwen"] = dict(cuts=cuts, planned=planned, runs=runs,
                       launches=counts, ms=total, peak_bytes=peak,
                       param_bytes=4 * n_params)
    print(f"phase 12: ms a forward (host clock, {card_line()}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in total.items()))
    print(f"phase 12: peak {peak / 2**30:.2f} GiB against "
          f"{4 * n_params / 2**30:.2f} GiB of fp32 weights")
    del params, mono, mono_mb
    torch.cuda.empty_cache()

    # -- (b) --------------------------------------------------------------
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    p4 = T.init_params(cfg4, 0, torch.float32, dev)
    p4_cpu = tree_to(p4, "cpu")
    cpu_mesh = M.make_debug_mesh((2,), ("pod",), device="cpu")
    cut = []
    with torch.no_grad():
        for wire in ("follow", "int8"):
            for piped in (False, True):
                card_out = split(2, wire, piped, c=cfg4, p=p4).cpu()
                cpu_out = split(2, wire, piped, c=cfg4, p=p4_cpu,
                                t=tok.cpu(), m=cpu_mesh)
                _, rel = row_err(card_out, cpu_out)
                same, close = top1_agrees(card_out, cpu_out)
                what = f"phase 12 qwen3-4b 4 layers l1=2 {wire}" \
                    f"{' pipelined' if piped else ''}"
                if wire == "follow":
                    check(rel <= LOGIT_TOL, f"{what}: the card differs from "
                          f"the CPU by {rel} of a row's scale")
                else:
                    check(same and rel <= SPLIT_INT8_CPU_TOL,
                          f"{what}: the card's top-1 differs from the CPU's "
                          f"where the margin decides it, or {rel} of a "
                          f"row's scale")
                cut.append(dict(wire=wire, pipelined=piped, rel_err=rel,
                                top1_too_close=close))
    out["qwen_4_layers"] = cut
    print("  qwen3-4b 4 layers, l1=2: card == CPU to " + ", ".join(
        f"{c['wire']}{' pipelined' if c['pipelined'] else ''} "
        f"{c['rel_err']:.3g}" for c in cut) + " of a row's scale (int8: "
        f"top-1 equal where decided; "
        f"{max(c['top1_too_close'] for c in cut)} positions too close)")
    del p4, p4_cpu
    torch.cuda.empty_cache()

    # -- (c) --------------------------------------------------------------
    gcfg = dataclasses.replace(configs.all_configs()["granite-moe-3b-a800m"],
                               num_layers=2,
                               moe_capacity_factor=EP_CAPACITY)
    gp = T.init_params(gcfg, 0, torch.float32, dev)
    gtok = torch.as_tensor(rng.integers(0, gcfg.vocab_size,
                                        (SPLIT_BATCH, SPLIT_SEQ)), device=dev)
    ep_mesh = M.make_debug_mesh((2, 4), ("data", "model"), device=dev)
    ep_cpu = M.make_debug_mesh((2, 4), ("data", "model"), device="cpu")
    launches.reset()
    layers, gen = [], torch.Generator().manual_seed(12)
    try:
        with torch.no_grad():
            for i in range(gcfg.num_layers):
                lp = {k: v[i] for k, v in gp["blocks"]["moe"].items()}
                x = (0.5 * torch.randn((SPLIT_BATCH, SPLIT_SEQ,
                                        gcfg.d_model), generator=gen)).to(dev)
                moe_ep.EP_MESH = None
                local, aux_local = L.moe(gcfg, lp, x)
                moe_ep.EP_MESH = ep_mesh
                check(moe_ep.ep_enabled(gcfg, x.shape),
                      "phase 12 granite: EP not enabled on the mesh")
                ep, aux = L.moe(gcfg, lp, x)
                again, _ = L.moe(gcfg, lp, x)
                moe_ep.EP_MESH = ep_cpu
                ep_host, aux_host = L.moe(gcfg, tree_to(lp, "cpu"), x.cpu())
                _, rel = row_err(ep, local)
                _, rel_cpu = row_err(ep.cpu(), ep_host)
                what = f"phase 12 granite-moe-3b layer {i}"
                check(rel <= EP_TOL, f"{what}: EP differs from the local "
                      f"dispatch by {rel} of a row's scale")
                check(torch.equal(again, ep), f"{what}: two EP runs differ")
                check(rel_cpu <= EP_CPU_TOL, f"{what}: card EP differs from "
                      f"CPU EP by {rel_cpu} of a row's scale")
                aux_gap = abs(float(aux) - float(aux_local))
                check(aux_gap < 0.05 and abs(float(aux) - float(aux_host))
                      <= 1e-5, f"{what}: aux {float(aux)} against local "
                      f"{float(aux_local)}, CPU EP {float(aux_host)}")
                moe_ep.EP_MESH = ep_mesh
                ms_ep = host_ms(lambda: L.moe(gcfg, lp, x))
                moe_ep.EP_MESH = None
                ms_local = host_ms(lambda: L.moe(gcfg, lp, x))
                layers.append(dict(layer=i, rel_err=rel, cpu_rel_err=rel_cpu,
                                   aux=float(aux), aux_local=float(aux_local),
                                   ms_ep=ms_ep, ms_local=ms_local))
            moe_ep.EP_MESH = None
            local_logits = T.forward(gcfg, gp, {"tokens": gtok},
                                     mode="prefill")[0]
            moe_ep.EP_MESH = ep_mesh
            ep_logits = T.forward(gcfg, gp, {"tokens": gtok},
                                  mode="prefill")[0]
    finally:
        moe_ep.EP_MESH = None
    _, rel_logits = row_err(ep_logits, local_logits)
    check(bool(torch.isfinite(ep_logits).all()) and rel_logits <= EP_CPU_TOL,
          f"phase 12 granite-moe-3b: EP logits {rel_logits} of a row's scale "
          f"from the local dispatch's, or not finite")
    counts = launches.snapshot()
    check(not any(counts.values()), f"phase 12 EP launched kernels "
          f"{counts}: the MoE dispatch is plain torch")
    out["granite_ep"] = dict(layers=layers, logits_rel_err=rel_logits)
    print(f"  granite-moe-3b (2 layers, full width, cf {EP_CAPACITY}) EP on "
          f"a (2, 4) data x model mesh on one card: " + "; ".join(
              f"layer {r['layer']}: {r['rel_err']:.3g} of scale from local, "
              f"{r['cpu_rel_err']:.3g} from CPU EP, {r['ms_ep']:.2f} ms EP "
              f"against {r['ms_local']:.2f} local" for r in layers)
          + f"; a second EP run bitwise equal; logits {rel_logits:.3g}")
    del gp, ep_logits, local_logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 11: the training path
# ---------------------------------------------------------------------------
TRAIN_TOL = 1e-4
TRAIN_KINDS = [("qwen3-4b", 2)] + [(name, n) for name, n, _ in BLOCK_KINDS]


def train_arithmetic(cfg, n_params: int, tokens: int) -> dict:
    """What a train step must at least cost: the matmul operations of
    forward, backward and the block remat's second forward (8 x the
    blocks' and unembedding's weights x tokens), the AdamW bytes (read
    param, grad, mu, nu; write param, mu, nu: 28 B a parameter in fp32),
    and fp32 params, grads, mu and nu resident."""
    matmul = n_params - cfg.padded_vocab * cfg.d_model   # the gather is no matmul
    flops = 8 * matmul * tokens
    return dict(matmul_params=matmul, flops=flops,
                flop_ms=1e3 * flops / PEAK_FLOPS["fp32"],
                adamw_bytes=28 * n_params,
                adamw_ms=1e3 * 28 * n_params / PEAK_BYTES,
                state_bytes=16 * n_params)


def phase_train(torch, configs, T, train_loop, partition, opt, ckpt,
                SyntheticLM, launches, dev):
    """(a) Qwen3-4B at full width and depth, fp32, trained for 4 steps by
    ``train_loop.train`` (JAX's ``TrainConfig`` defaults: batch 8, 128
    tokens) on ``SyntheticLM``: every loss and grad norm finite, the
    step-0 loss below ln(padded vocab) + 2, every leaf moved; ms a step
    over steps 1-3 (each step ends in the loop's read of its loss, which
    waits for the step's last kernel), the optimizer's device time a step
    (CUDA events) and the peak memory.  (b) one config of each block kind
    at full width and a cut depth, 2 steps at batch 2 x 16 tokens on the
    card and on the CPU from the same weights: losses and grad norms
    within 1e-4 relative, step 0's grads within 1e-4 of each leaf's
    largest |value|, and a second card run bitwise equal.  (c) on the
    Qwen3-4B 2-layer run: a checkpoint after step 1, restored into fresh
    tensors on the card, takes step 2 to the uninterrupted run's loss and
    params, bitwise.  No kernel of the port launches on this path."""
    import dataclasses
    import math
    import tempfile

    from repro_torch.tree import leaves, tree_map

    launches.reset()
    rows = {}
    # -- (a) --------------------------------------------------------------
    cfg = configs.all_configs()["qwen3-4b"]
    tcfg = train_loop.TrainConfig(steps=4, log_every=1)
    real_step, real_update = train_loop.make_train_step, opt.apply_updates
    metrics, marks, opt_events, before = [], [], [], {}

    def timed_update(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_update(*args, **kw)
        b.record()
        opt_events.append((a, b))
        return out

    def recording(cfg_, ocfg):
        step_fn = real_step(cfg_, ocfg)

        def step(params, opt_state, batch):
            if not before:      # a slice of every leaf before step 0
                for i, t in enumerate(leaves(params)):
                    before[i] = t.reshape(-1)[:4096].clone()
            out = step_fn(params, opt_state, batch)
            metrics.append(out[2])
            return out
        return step

    def log(line):
        marks.append(time.perf_counter())
        print(f"  {line}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)      # earlier phases' tensors
    train_loop.make_train_step, opt.apply_updates = recording, timed_update
    try:
        out = train_loop.train(cfg, tcfg, log=log, device=dev)
    finally:
        train_loop.make_train_step, opt.apply_updates = real_step, real_update
    peak = torch.cuda.max_memory_allocated(dev)
    params = out["params"]
    n_params = tree_numel(params)
    vals = [{k: float(v) for k, v in m.items()} for m in metrics]
    check(len(vals) == 4 and all(math.isfinite(v["loss"])
                                 and math.isfinite(v["grad_norm"])
                                 for v in vals),
          f"phase 11 qwen3-4b: non-finite loss or grad norm {vals}")
    bound = math.log(cfg.padded_vocab) + 2
    check(vals[0]["loss"] < bound, f"phase 11 qwen3-4b: step-0 loss "
          f"{vals[0]['loss']} not below ln(padded vocab) + 2 = {bound}")
    stale = [i for i, t in enumerate(leaves(params))
             if torch.equal(t.reshape(-1)[:4096], before[i])]
    check(not stale, f"phase 11 qwen3-4b: leaves {stale} did not move")
    step_ms = 1e3 * (marks[3] - marks[0]) / 3
    opt_ms = sum(a.elapsed_time(b) for a, b in opt_events[1:]) / 3
    arith = train_arithmetic(cfg, n_params, tcfg.batch * tcfg.seq_len)
    rows["full"] = dict(
        config="qwen3-4b", layers=cfg.num_layers, params=n_params,
        batch=tcfg.batch, seq_len=tcfg.seq_len, steps=tcfg.steps,
        losses=[v["loss"] for v in vals],
        grad_norms=[v["grad_norm"] for v in vals], step_ms=step_ms,
        tokens_per_s=tcfg.batch * tcfg.seq_len / (step_ms / 1e3),
        optimizer_ms=opt_ms, optimizer_ms_each=[a.elapsed_time(b)
                                                for a, b in opt_events],
        step_ms_each=[1e3 * (b - a) for a, b in zip(marks, marks[1:])],
        peak_bytes=peak, held_bytes=held, **arith)
    print(f"phase 11: qwen3-4b full width and depth ({n_params / 1e9:.2f} B "
          f"parameters, fp32), batch {tcfg.batch} x {tcfg.seq_len} tokens: "
          f"{step_ms:.1f} ms a step over steps 1-3, "
          f"{rows['full']['tokens_per_s']:.0f} tokens/s, optimizer "
          f"{opt_ms:.1f} ms a step (bounds: matmuls {arith['flop_ms']:.0f} "
          f"ms at fp32 peak, AdamW {arith['adamw_ms']:.1f} ms at HBM rate); "
          f"peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of "
          f"it held by earlier phases) against "
          f"{arith['state_bytes'] / 2**30:.2f} GiB of params, grads and "
          f"moments ({card_line()})")
    del out, params, metrics, before
    torch.cuda.empty_cache()

    # -- (b), (c) -----------------------------------------------------------
    adamw = train_loop.TrainConfig().adamw
    rows["kinds"] = []
    for name, n_layers in TRAIN_KINDS:
        cfg = dataclasses.replace(configs.all_configs()[name],
                                  num_layers=n_layers)
        data = SyntheticLM(cfg, 2, 16, seed=0)
        batches = [data.batch_at(i) for i in range(3)]
        card0 = T.init_params(cfg, 0, torch.float32, dev)
        cpu0 = tree_map(lambda t: t.to("cpu", copy=True), card0)

        def put(b, d):
            return {k: torch.from_numpy(v).to(d) for k, v in b.items()}

        grads = {}
        for where, p in (("card", card0), ("cpu", cpu0)):
            d = p["embed"].device
            _, _, _, g = partition.loss_and_grads(cfg, p, put(batches[0], d))
            grads[where] = [t.cpu() for t in leaves(g)]
            del g
        errs = []
        for a, b in zip(grads["card"], grads["cpu"], strict=True):
            errs.append(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
        del grads
        check(max(errs) <= TRAIN_TOL, f"phase 11 {name}: step-0 grads of "
              f"the card differ from the CPU's by {max(errs)} of a leaf's "
              f"scale")

        def run(p, d, steps, resume=None):
            """Train steps from params ``p`` (consumed); ``resume`` (a
            directory) saves after step 1 and restores into fresh
            tensors for the rest."""
            step_fn = partition.make_train_step(cfg, adamw)
            state = opt.init_state(p)
            out = []
            for i in range(steps):
                if resume and i == 2:
                    ckpt.save(resume, 2, p, state)
                    fresh = T.init_params(cfg, 1, torch.float32, d)
                    _, tree = ckpt.restore(resume, {
                        "params": fresh, "opt_state": opt.init_state(fresh)})
                    del p, state, fresh
                    p, state = tree["params"], tree["opt_state"]
                p, state, m = step_fn(p, state, put(batches[i], d))
                out.append((m["loss"].cpu(), m["grad_norm"].cpu()))
            return out, p

        steps = 3 if name == "qwen3-4b" else 2
        card, card_p = run(card0, dev, steps)
        cpu, _ = run(cpu0, torch.device("cpu"), 2)
        again, again_p = run(T.init_params(cfg, 0, torch.float32, dev),
                             dev, steps)
        rel = max(float(abs(a - b) / abs(b)) for x, y in zip(card, cpu)
                  for a, b in zip(x, y))
        check(all(math.isfinite(float(v)) for x in card for v in x),
              f"phase 11 {name}: non-finite loss or grad norm {card}")
        check(rel <= TRAIN_TOL, f"phase 11 {name}: the card's losses and "
              f"grad norms differ from the CPU's by {rel} relative")
        check(all(torch.equal(a, b) for x, y in zip(card, again)
                  for a, b in zip(x, y)),
              f"phase 11 {name}: two card runs differ: {card} vs {again}")
        row = dict(config=name, layers=n_layers, params=tree_numel(card_p),
                   grad_rel_err=max(errs), loss_rel_err=rel,
                   losses=[float(x[0]) for x in card],
                   grad_norms=[float(x[1]) for x in card])
        if name == "qwen3-4b":
            with tempfile.TemporaryDirectory() as tmp:
                resumed, resumed_p = run(
                    T.init_params(cfg, 0, torch.float32, dev), dev, 3,
                    resume=tmp)
                size = sum(os.path.getsize(os.path.join(tmp, f))
                           for f in os.listdir(tmp))
            same = torch.equal(resumed[2][0], card[2][0]) and all(
                torch.equal(a, b) for a, b in zip(leaves(resumed_p),
                                                  leaves(card_p)))
            check(same, f"phase 11 {name}: step 2 after a checkpoint "
                  f"differs from the uninterrupted run")
            row["checkpoint_bytes"] = size
            del resumed_p
        rows["kinds"].append(row)
        print(f"  {name} ({n_layers} layers, full width): card == CPU to "
              f"{rel:.3g} (losses, grad norms) and {max(errs):.3g} of a "
              f"leaf's scale (step-0 grads); a second card run bitwise "
              f"equal" + ("; step 2 from a checkpoint "
                          f"({row['checkpoint_bytes'] / 1e9:.1f} GB) bitwise "
                          f"equal" if name == "qwen3-4b" else ""))
        del card0, cpu0, card_p, again_p
        torch.cuda.empty_cache()
    counts = launches.snapshot()
    check(not any(counts.values()), f"phase 11 launched kernels {counts}: "
          f"the training path's mixers are plain torch")
    return rows


def phase_build(_build):
    """Phase 2: build every source at once; check what nvcc made of the
    tensor-core kernels.  Returns the logs and the per-kernel reports."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k}: {len(v)} B of log' for k, v in logs.items())})")
    report = {}
    for src in ("conv2d", "flash_attention", "rwkv6_wkv", "mamba2_ssd",
                "quant"):
        ptxas = _build.ptxas_report(logs[src])
        sass = _build.sass_report(_build._target(src))
        report[src] = {k: dict(ptxas.get(k, {}), **sass.get(k, {}))
                       for k in sorted(set(ptxas) | set(sass))}
    for src, kernels in report.items():
        print(f"phase 2: {src} kernels (registers/stack B/spill B/SASS/"
              f"HGMMA/HMMA): " + ", ".join(
                  f"{n} {r.get('registers', '?')}/{r.get('stack', '?')}/"
                  f"{r.get('spill_stores', '?')}/{r['instructions']}/"
                  f"{r['hgmma']}/{r['hmma']}" for n, r in kernels.items()))
    for name, r in report["conv2d"].items():
        if name.startswith("conv2d_dense_kernel"):
            check(r["hgmma"] > 0, f"{name}: no HGMMA in its SASS")
        if name.startswith("conv2d_depthwise_kernel"):
            check(r["stack"] == 0, f"{name}: {r['stack']} B stack frame")
    found = [n.split("<")[0] for kernels in report.values() for n in kernels]
    for name, want in (("conv2d_dense_kernel", 6), ("flash_kernel", 16),
                       ("wkv_kernel", 8), ("ssd_states_kernel", 2),
                       ("ssd_output_kernel", 2), ("ssd_scan_kernel", 1),
                       ("quantize_kernel", 6), ("dequantize_kernel", 4)):
        check(found.count(name) == want, f"phase 2: {found.count(name)} "
              f"{name} instantiations named, not {want}")
    for name, r in [kv for src in ("flash_attention", "rwkv6_wkv",
                                   "mamba2_ssd", "quant")
                    for kv in report[src].items()]:
        check(r["stack"] == 0 and r["spill_stores"] == 0
              and r["spill_loads"] == 0,
              f"{name}: {r['stack']} B stack frame, spills "
              f"{r['spill_stores']}/{r['spill_loads']} B")
        if name.startswith("flash_kernel"):
            check(r["hgmma"] > 0, f"{name}: no HGMMA in its SASS")
        if name.startswith(("ssd_states_kernel", "ssd_output_kernel")):
            check(r["hmma"] > 0, f"{name}: no HMMA in its SASS")
    return logs, report


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F

    from repro_torch import configs, core, runtime
    from repro_torch.device import strict_fp32
    from repro_torch.kernels import _build, launches
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant as kquant
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_wkv import RWKV_HD, plan_wkv
    from repro_torch.launch import serve
    from repro_torch.models import cnn, profiles, transformer
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import partition
    from repro_torch.launch import smartsplit_exec
    from repro_torch.serving.engine import Engine
    from repro_torch.training import checkpoint, optimizer, train_loop

    t_start = time.perf_counter()
    strict_fp32()
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    logs, kernel_report = phase_build(_build)
    regs = [ln.strip() for text in logs.values() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]

    worst, conv_rows = phase_conv(torch, F, cnn, kconv, ref, dev)
    micro, batch4, extra = codec_shapes(cnn, core, profiles)
    codec_worst, codec_plans = phase_codec(
        torch, kquant, ref, micro + batch4 + extra + SPLIT_CODEC_SHAPES, dev)
    worst.update(codec_worst)
    counts, runs = phase_main(torch, cnn, serve, launches, kquant, runtime,
                              dev)
    cases = mixer_cases(configs, RWKV_HD)
    t0 = time.perf_counter()
    inputs, outs, mixer_counts = phase_mixers(torch, kops, launches, cases,
                                              dev)
    counts.update({n: mixer_counts[n] for n in MIXERS})
    small = SMALL_MIXERS + wkv_stage_cases(torch, plan_wkv, RWKV_HD)
    mixer_worst, mixer_rows = phase_mixer_checks(torch, kops, ref, cases,
                                                 inputs, outs, small, dev)
    worst.update(mixer_worst)
    print(f"phases 7-8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream_counts, stream_runs = phase_stream(torch, cnn, serve, launches,
                                              kquant, dev)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decode_runs = phase_decode(torch, configs, transformer, Engine, launches,
                               dev)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split_runs = phase_split(torch, configs, core, profiles, transformer,
                             smartsplit_exec, mesh_lib, launches, dev)
    split_counts = split_runs["qwen"]["launches"]
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    agg, time_rows = phase_time(torch, F, cnn, kconv, kquant, ref,
                                micro + batch4, dev)
    split_agg = {}
    for shape in SPLIT_CODEC_SHAPES:
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            codec_time(torch, kquant, ref, shape, dname, dtype,
                       torch.Generator().manual_seed(20), dev, split_agg,
                       time_rows)
    t0 = time.perf_counter()
    mixer_agg, mixer_time_rows = phase_time_mixers(torch, F, kops, ref,
                                                   cases, inputs)
    agg.update(mixer_agg)
    time_rows += mixer_time_rows
    print(f"phase 6: sequence kernels timed in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_runs = phase_train(torch, configs, transformer, train_loop,
                             partition, optimizer, checkpoint, SyntheticLM,
                             launches, dev)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        a = agg[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            **({"launches_stream": stream_counts[name]}
               if name in stream_counts else {}),
            **({"launches_split": split_counts[name],
                "split_boundary": dict(
                    shapes=[list(s) for s in SPLIT_CODEC_SHAPES],
                    **{k: split_agg[name][k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms",
                        "ms_bf16", "bound_ms_bf16", "library_ms_bf16")})}
               if name in split_agg else {}),
            "max_abs_err": worst[(name, "fp32")], "ms": a["ms"],
            "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"],
            "bound_by": "operations" if a["flop_ms"] >= a["byte_ms"]
            else "bytes",
            "library_ms": a["library_ms"],
            "calls_timed": a["calls"],
            "max_abs_err_bf16": worst[(name, "bf16")],
            **{k: a[k] for k in ("bound_ms_cuda_cores", "ms_bf16",
                                 "library_ms_bf16", "bound_ms_bf16")
               if k in a}})
    detail = dict(card=card, torch=torch.__version__, conv_checks=conv_rows,
                  codec_plans=[dict(shape=list(k[0]), dtype=k[1], **v)
                               for k, v in codec_plans.items()],
                  kernel_report=kernel_report,
                  mixer_checks=mixer_rows, runs=runs, timings=time_rows,
                  stream_runs=stream_runs, decode_runs=decode_runs,
                  split_runs=split_runs,
                  train_runs=train_runs,
                  kernels=kernels, ptxas=regs,
                  seconds=time.perf_counter() - t_start)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(f"phase 6: timed {len(time_rows)} calls; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
