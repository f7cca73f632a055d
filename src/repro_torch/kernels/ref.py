"""Plain PyTorch versions of every CUDA kernel in this package.

These are the semantics contracts.  The kernel wrappers take them for
tensors that lie on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  On the card they must run with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), or the fp32 conv drops to
TF32 inside cuDNN.

The codec versions are bitwise equal to the JAX package's jitted
``quantize_boundary`` / ``dequantize_boundary``, what its wire ships: the
absmax, a scale of ``absmax * fl32(1/127)`` (XLA's rewrite of ``absmax /
127``: one rounded multiply), then a true division by the scale (a
tensor divisor, never a Python scalar: PyTorch's CUDA division by a host
scalar multiplies by its reciprocal), round-half-even, clip.

The sequence mixers (``attention_plain``, ``rwkv6_wkv_plain``,
``mamba2_ssd_plain``) compute what the JAX package's Pallas kernels
compute, in fp32: the attention's finite mask value and the SSD's chunked
arithmetic included, so they agree with ``repro.kernels.ref`` wherever
that oracle is defined and with the Pallas kernels everywhere."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = (None, "relu", "relu6")


def activate(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def conv2d_plain(x, w, *, stride: int = 1, pad: int = 0, bias=None,
                 activation: str | None = None, groups: int = 1,
                 pool_k: int = 0, pool_s: int = 0) -> torch.Tensor:
    """Conv(+bias)(+relu/relu6)(+VALID maxpool) in fp32, returned in the
    storage dtype of ``x``.  x: (N, Cin, H, W); w: (Cout, Cin/groups,
    K, K) OIHW; bias: (Cout,) fp32."""
    y = F.conv2d(x.float(), w.float(), stride=stride, padding=pad,
                 groups=groups)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    y = activate(y, activation)
    if pool_k:
        y = F.max_pool2d(y, pool_k, pool_s or pool_k)
    return y.to(x.dtype)


def quantize_plain(x, axis: int | None = None):
    """Per-channel (``axis``) or per-tensor (None) symmetric int8.

    Returns ``(values int8 like x, scales fp32 (C,))``, C = 1 per-tensor."""
    x32 = x.float()
    if axis is None:
        absmax = x32.abs().amax().reshape(1)
        sb = absmax
    else:
        axis = axis % x.ndim
        red = tuple(a for a in range(x.ndim) if a != axis)
        absmax = x32.abs().amax(dim=red) if red else x32.abs()
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        sb = absmax.reshape(shape)
    scale = _scale_of(absmax)
    q = torch.clamp(torch.round(x32 / _scale_of(sb)), -127.0, 127.0)
    return q.to(torch.int8), scale


# fl32(1/127), the constant XLA multiplies by for ``absmax / 127``
INV127 = float.fromhex("0x1.020408p-7")


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    inv = torch.full_like(absmax, INV127)
    return torch.where(absmax > 0.0, absmax * inv, torch.ones_like(absmax))


def dequantize_plain(values, scales, axis: int | None = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_plain``: values * scale, cast to ``out_dtype``."""
    if axis is None:
        sb = scales.reshape(())
    else:
        axis = axis % values.ndim
        shape = [1] * values.ndim
        shape[axis] = values.shape[axis]
        sb = scales.reshape(shape)
    return (values.float() * sb).to(out_dtype)


# ---------------------------------------------------------------------------
# Sequence mixers: attention, RWKV6 WKV, Mamba2 SSD
# ---------------------------------------------------------------------------
# The TPU flash kernel's mask value: finite, so a query row that sees no key
# averages V (every key gets exp(0) = 1), where a -inf fill would give NaN.
MASK_VALUE = -1e30


def attention_scale(hd: int) -> float:
    """The softmax scale, ``1 / sqrt(hd)``, as the JAX kernel writes it; it
    is rounded once, to fp32, where it meets the fp32 scores."""
    return 1.0 / hd**0.5


def attention_plain(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Dense softmax attention in fp32, output in q's dtype; the scores
    are scaled by ``scale`` (default ``attention_scale(hd)``).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H % KV == 0 (query head h
    reads K/V head h // (H // KV)).  Causal masking is end-aligned (query
    i sees keys <= i + Sk - Sq) with the finite ``MASK_VALUE`` fill, so a
    query row with no visible key comes out as the mean of V."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().transpose(1, 2)                          # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) \
        * (attention_scale(hd) if scale is None else scale)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).transpose(1, 2).to(q.dtype)


def rwkv6_wkv_plain(r, k, v, w, u) -> torch.Tensor:
    """Token-level RWKV6 WKV recurrence from a zero fp32 state.

    r, k, v, w: (B, T, H, hd), w the per-step decay; u: (H, hd) the
    current-token bonus.  out_t = r_t . (S + diag(u) k_t v_t^T), then
    S = diag(w_t) S + k_t v_t^T; out in r's dtype."""
    B, T, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]                        # (1, H, hd, 1)
    s = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
    out = torch.empty(B, T, H, hd, dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B, H, hd, hd)
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv)
        s = s * wf[:, t, :, :, None] + kv
    return out.to(r.dtype)


def pad_time(t: torch.Tensor, mult: int) -> torch.Tensor:
    """``t`` (B, T, ...) zero-padded along T to a multiple of ``mult``."""
    pad = (-t.shape[1]) % mult
    if pad == 0:
        return t
    fill = torch.zeros((t.shape[0], pad, *t.shape[2:]), dtype=t.dtype,
                       device=t.device)
    return torch.cat([t, fill], dim=1)


def mamba2_ssd_plain(x, dt, A, B, C, *, chunk: int = 64) -> torch.Tensor:
    """Chunked Mamba2 SSD scan from h0 = 0, the TPU kernel's arithmetic.

    x: (Bb, T, H, hp); dt: (Bb, T, H); A: (H,); B, C: (Bb, T, H, ds).
    T is zero-padded to a multiple of ``chunk`` and the result sliced back;
    the chunk is the arithmetic's (results differ with it by rounding).
    y in x's dtype; no D term."""
    T = x.shape[1]
    xp, dtp, Bp, Cp = (pad_time(t, chunk) for t in (x, dt, B, C))
    Bb, Tp, H, hp = xp.shape
    ds = Bp.shape[-1]
    la = dtp.float() * A.float()                            # (Bb, Tp, H)
    below = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=x.device))[None, :, :, None]
    h = torch.zeros(Bb, H, hp, ds, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, Tp, chunk):
        sl = slice(c0, c0 + chunk)
        xc, dtc = xp[:, sl].float(), dtp[:, sl].float()
        Bc, Cc = Bp[:, sl].float(), Cp[:, sl].float()
        cs = torch.cumsum(la[:, sl], dim=1)                 # (Bb, L, H)
        seg = cs[:, :, None, :] - cs[:, None, :, :]         # (Bb, t, u, H)
        decay = torch.where(below, torch.exp(seg), 0.0)
        att = torch.einsum("bthn,buhn->btuh", Cc, Bc) * decay
        y = torch.einsum("btuh,buhp->bthp", att, xc * dtc[..., None])
        y = y + torch.exp(cs)[..., None] * torch.einsum("bthn,bhpn->bthp",
                                                        Cc, h)
        w_u = torch.exp(cs[:, -1:] - cs) * dtc              # (Bb, L, H)
        h = h * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "buhp,buhn->bhpn", xc * w_u[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T].to(x.dtype)
