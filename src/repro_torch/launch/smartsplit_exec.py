"""Two-stage SmartSplit executor: the paper's client->server handoff over
the ``pod`` axis of a mesh, the port of ``repro.launch.smartsplit_exec``.

Pod 0 ("client", paper: smartphone) owns transformer blocks [0, l1); pod 1
("server", paper: cloud) owns [l1, L).  The boundary activation -- the
paper's "intermediate model upload" -- crosses from pod 0 to pod 1 in the
wire dtype; its byte count is exactly the I|l1 term the optimiser's Eq. 4
models.  Pod 1 runs its blocks, the final norm and the unembedding in
fp32, and the logits come back to pod 0.

The JAX program is one SPMD body over both pods: each scans Lmax =
max(l1, L-l1) padded block slots with a mask, and the pod that is not
meant to compute a phase computes it anyway and discards it.  The port
runs one controller: each pod runs its own active blocks, through
``transformer._apply_block`` as the monolithic ``forward`` does, on
views of the stacked weights where the pod shares their device (the
padded ``stage_params`` stacks, kept for parity, are never built by the
executor: at Qwen3-4B's width they would be 14-28 GB of fp32).

On the card each pod runs on a CUDA stream of its own; an event orders
each handoff, and a tensor made on one stream and used on another is
``record_stream``ed there, so the caching allocator does not hand its
memory out early.  With ``pipelined=True`` (GPipe, m microbatches) pod 0
runs microbatch i while pod 1 runs microbatch i-1, so on one card the two
streams may overlap.  On the CPU the pods run in turn."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtype_policy import (conv_dtype, policy_torch_dtype,
                                           resolve_wire_dtype)
from repro_torch.kernels import quant
from repro_torch.launch.mesh import Mesh, send
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def _check_split(cfg: ModelConfig, l1: int) -> None:
    if cfg.pattern == "mamba" and cfg.attn_every:
        raise ValueError("zamba2: split at segment granularity")
    if not 0 <= l1 <= cfg.num_layers:
        raise ValueError(f"l1={l1} outside [0, {cfg.num_layers}]")


def stage_params(cfg: ModelConfig, params, l1: int):
    """Reorganise stacked blocks (L, ...) into (2, Lmax, ...) stage slots +
    (2, Lmax) active mask, as the JAX package stages them (bit for bit).
    Works for the uniform-pattern archs.  The executor does not use them:
    ``stage_blocks`` gives each pod its active blocks without padding."""
    _check_split(cfg, l1)
    Lt = cfg.num_layers
    lmax = max(l1, Lt - l1)

    def pack(t):
        pad = torch.zeros((2, lmax) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[0, :l1] = t[:l1]
        pad[1, :Lt - l1] = t[l1:]
        return pad

    staged = tree_map(pack, params["blocks"])
    mask = torch.zeros((2, lmax), dtype=torch.bool)
    mask[0, :l1] = True
    mask[1, :Lt - l1] = True
    return staged, mask


def pod_devices(mesh: Mesh) -> list[torch.device]:
    """The devices of pods 0 and 1 (the other axes' coordinates 0)."""
    if mesh.shape.get("pod") != 2:
        raise ValueError(f"the two-stage split needs a 'pod' axis of 2 "
                         f"positions, got a mesh {mesh.shape}")
    return mesh.along("pod")


def stage_blocks(cfg: ModelConfig, params, l1: int, mesh: Mesh):
    """``(pod 0's blocks [0, l1), pod 1's blocks [l1, L))``, each a list of
    per-layer trees on its pod's device: views of ``params["blocks"]``
    where the pod is on their device, a copy of each layer where not."""
    _check_split(cfg, l1)
    devs = pod_devices(mesh)
    blocks = params["blocks"]

    def layers(lo, hi, dev):
        return [tree_map(lambda t: t.to(dev), T._layer(blocks, i))
                for i in range(lo, hi)]
    return (layers(0, l1, devs[0]),
            layers(l1, cfg.num_layers, devs[1]))


class _Pods:
    """Each pod's device and, on the card, its stream."""

    def __init__(self, devices: list[torch.device]):
        self.devices = devices
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in devices]

    def on(self, pod: int):
        s = self.streams[pod]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def start(self) -> None:
        """Both pods begin after the work already queued on their
        devices' current streams (the caller's inputs)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def mark(self, pod: int):
        """An event after the work queued so far on pod ``pod``'s stream
        (None on the CPU)."""
        s = self.streams[pod]
        if s is None:
            return None
        ev = torch.cuda.Event()
        ev.record(s)
        return ev

    def handoff(self, t: torch.Tensor, ready, src: int, dst: int
                ) -> torch.Tensor:
        """``t``, made on pod ``src``'s stream up to event ``ready``,
        moved to pod ``dst`` (``mesh.send``) once pod ``dst``'s stream
        has waited for it."""
        s_dst = self.streams[dst]
        if ready is not None and s_dst is not None:
            s_dst.wait_event(ready)
        with contextlib.ExitStack() as ctx:
            if self.devices[src] != self.devices[dst]:
                ctx.enter_context(self.on(src))     # the copy's source
            ctx.enter_context(self.on(dst))
            out = send(t, self.devices[dst])
        if s_dst is not None and t.device.type == "cuda":
            t.record_stream(s_dst)
        return out

    def finish(self, out: torch.Tensor) -> torch.Tensor:
        """Hand ``out`` (made on a pod's stream) to the caller's current
        stream, which also waits for both pods."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)
        if out.device.type == "cuda":
            out.record_stream(torch.cuda.current_stream(out.device))
        return out


def build_two_stage_forward(cfg: ModelConfig, mesh: Mesh, l1: int,
                            pipelined: bool = False, microbatches: int = 4,
                            boundary_dtype: str | None = None,
                            wire_dtype: str | None = None):
    """Returns ``fn(stages, embed, unembed, final_norm, tokens) -> logits``
    (fp32, on pod 0's device), ``stages`` from ``stage_blocks``.

    ``boundary_dtype`` is the storage policy (``conv_dtype``; env
    ``REPRO_CONV_DTYPE``): under ``bf16`` the boundary activation crosses
    the link as bfloat16 and is upcast back to the compute dtype on
    arrival.  ``fp32`` transfers the activation as-is.

    ``wire_dtype`` decouples the link format from that storage policy
    (``follow``/``fp32``/``bf16``/``int8``; None resolves the
    ``REPRO_WIRE_DTYPE`` env, default ``follow`` = the storage dtype).
    ``int8`` quantizes the hidden state per feature (axis -1) with
    ``kernels.quant`` -- the CUDA codec on the card, its plain version on
    the CPU -- and ships the scales and int8 values in one packed buffer
    (``quantize_packed``), dequantized to the compute dtype on arrival.
    Pipelined, each microbatch is quantized on its own, with its own
    scales.

    Restricted to the uniform-pattern architectures (attn/MoE/RWKV/Mamba
    without shared blocks); zamba2 raises ``ValueError``."""
    _check_split(cfg, l1)
    w = resolve_wire_dtype(wire_dtype, storage=conv_dtype(boundary_dtype))
    int8_wire = w == "int8"
    link_dt = policy_torch_dtype(w) if w == "bf16" else None
    if pipelined and microbatches < 1:
        raise ValueError(f"microbatches={microbatches}")
    pods = _Pods(pod_devices(mesh))
    dev0, dev1 = pods.devices

    def run_stage(blocks, h, positions):
        for p in blocks:
            h, _, _ = T._apply_block(cfg, cfg.pattern, p, h,
                                     positions=positions)
        return h

    def encode(h):
        if int8_wire:
            return quant.quantize_packed(h.contiguous(), -1)
        return h if link_dt is None else h.to(link_dt)

    def decode(payload, shape, dtype):
        if int8_wire:
            return quant.dequantize_packed(payload, shape, -1, dtype)
        return payload.to(dtype)

    def fn(stages, embed, unembed, final_norm, tokens):
        blocks0, blocks1 = stages
        B, S = tokens.shape
        m = microbatches if pipelined else 1
        if B % m:
            raise ValueError(f"batch {B} does not split into {m} "
                             f"microbatches")
        bm = B // m
        tokens = tokens.to(dev0)
        embed = embed.to(dev0)
        unembed, final_norm = unembed.to(dev1), final_norm.to(dev1)
        pods.start()

        def client(i):                                  # pod 0
            with pods.on(0):
                h = embed[tokens[i * bm:(i + 1) * bm]]
                h = run_stage(blocks0, h, T._positions(0, bm, S, dev0))
                payload = encode(h)
            return payload, pods.mark(0), tuple(h.shape), h.dtype

        def server(sent):                               # pod 1
            payload, ready, shape, dtype = sent
            recv = pods.handoff(payload, ready, 0, 1)
            with pods.on(1):
                h = decode(recv, shape, dtype)
                h = run_stage(blocks1, h, T._positions(0, bm, S, dev1))
                h = L.rmsnorm(h, final_norm, cfg.norm_eps)
                return (h @ unembed).float()

        # tick i: pod 0 takes microbatch i while pod 1 takes microbatch
        # i-1 (un-pipelined: one microbatch, two ticks)
        outs, inflight = [], None
        for i in range(m + 1):
            sent = client(i) if i < m else None
            if inflight is not None:
                outs.append(server(inflight))
            inflight = sent
        with pods.on(1):
            logits = outs[0] if m == 1 else torch.cat(outs)
        return pods.finish(pods.handoff(logits, pods.mark(1), 1, 0))

    return fn


def two_stage_apply(cfg: ModelConfig, params, tokens, mesh: Mesh, l1: int,
                    pipelined: bool = False, microbatches: int = 4,
                    boundary_dtype: str | None = None,
                    wire_dtype: str | None = None):
    """Convenience wrapper: stage, place, and run.  Returns the logits on
    pod 0's device: under the follow wire, bit for bit the monolithic
    ``forward``'s (pipelined: ``forward`` of each microbatch, since pod 1
    unembeds each microbatch alone); a bf16 boundary adds ~1e-2 relative,
    the int8 wire a bounded per-feature quantization error."""
    stages = stage_blocks(cfg, params, l1, mesh)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    fn = build_two_stage_forward(cfg, mesh, l1, pipelined, microbatches,
                                 boundary_dtype=boundary_dtype,
                                 wire_dtype=wire_dtype)
    return fn(stages, params["embed"], unembed, params["final_norm"],
              tokens)
