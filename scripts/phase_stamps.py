#!/usr/bin/env python3
"""Where a flash attention tile and an SSD chunk spend their cycles.

    python3 scripts/phase_stamps.py

Builds ``csrc/flash_attention.cu`` and ``csrc/mamba2_ssd.cu`` with
``-DPHASE_STAMPS`` into ``chiprun_out/stamps/``, which turns their
``STAMP(i)`` markers (``csrc/hopper.cuh``) into ``clock64()`` stamps of
one CTA's thread 0 (flash: CTA (3, 5), its ninth key tile; SSD: CTA
(5, 7) of the states and output passes), runs each at the phase-7 widths
of ``chip_smoke.py`` (Qwen3-4B attention, Zamba2-7B SSD; fp32 and bf16),
and prints the cycles of each phase as JSON (also written to
``chiprun_out/phase_stamps.json``).  Needs a CUDA card and nvcc."""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "stamps"

FLASH_PHASES = ("copy wait and barrier (bf16)", "S (bf16: and the next copies)",
                "softmax", "P V issue",
                "next tile's copies and halves (fp32)",
                "P V wait and barrier")


def build(name: str, sx: int, sy: int, when: str):
    """The source ``name`` built with its stamps on, for CTA (sx, sy)
    where ``when`` holds."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}_stamps.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DPHASE_STAMPS",
                    f"-DSTAMP_X={sx}", f"-DSTAMP_Y={sy}",
                    f"-DSTAMP_WHEN=({when})", "-o", str(lib),
                    str(_build.CSRC / f"{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def read(lib) -> list[list[int]]:
    """The stamps of the fp32 and the bf16 instantiations."""
    buf = (ctypes.c_longlong * 32)()
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    if lib.read_stamps(ctypes.addressof(buf)):
        raise SystemExit("phase_stamps: reading the stamps failed")
    return [list(buf)[:16], list(buf)[16:]]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("phase_stamps: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba2_ssd as kssd
    from repro_torch.kernels.ref import attention_scale

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    lib = build("flash_attention", 3, 5, "kt==8")
    lib.flash_attention_launch.argtypes = \
        kfa._SIGNATURES["flash_attention_launch"][0]
    for dt in (torch.float32, torch.bfloat16):
        q = rn(2, 2048, 32, 128).to(dt)
        k, v = (rn(2, 2048, 8, 128).to(dt) for _ in range(2))
        o = torch.empty_like(q)
        g = kfa.plan_flash(q.shape, k.shape, causal=True, dtype=dt)
        tiles = torch.tensor(g.k_tiles, dtype=torch.int32, device="cuda")
        for _ in range(3):
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.Sq,
                g.Sk, g.H, g.KV, g.hd, attention_scale(g.hd), 1,
                _build.DTYPE_CODE[dt], *g.grid, g.smem, tiles.data_ptr(),
                stream())
            if rc:
                raise SystemExit(f"flash stamp launch failed: {rc}")
        torch.cuda.synchronize()
    for dname, s in zip(("fp32", "bf16"), read(lib)):
        result[f"flash qwen3-4b {dname}"] = dict(zip(
            FLASH_PHASES, (s[i + 1] - s[i] for i in range(6))))
    lib = build("mamba2_ssd", 5, 7, "true")
    lib.mamba2_ssd_launch.argtypes = kssd._SIGNATURES["mamba2_ssd_launch"][0]
    for dt in (torch.float32, torch.bfloat16):
        x = rn(2, 2048, 112, 64, scale=0.5).to(dt)
        d = F.softplus(rn(2, 2048, 112)).to(dt)
        A = -torch.exp(rn(112, scale=0.3))
        Bm, Cm = (rn(2, 2048, 112, 64, scale=0.4).to(dt) for _ in range(2))
        plan = kssd.plan_ssd(2, 2048, 112, 64, 64, 64, dt)
        y = torch.empty_like(x)
        st = torch.empty(plan.state_floats, device="cuda")
        dc = torch.empty(2 * 112 * plan.nc, device="cuda")
        vals = plan.params()
        params = (ctypes.c_int * len(vals))(*vals)
        for _ in range(3):
            rc = lib.mamba2_ssd_launch(
                x.data_ptr(), d.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), st.data_ptr(), dc.data_ptr(),
                params, _build.DTYPE_CODE[dt], stream())
            if rc:
                raise SystemExit(f"ssd stamp launch failed: {rc}")
        torch.cuda.synchronize()
    for dname, s in zip(("fp32", "bf16"), read(lib)):
        result[f"ssd zamba2-7b {dname}"] = {
            "states: staging issue and dt": s[1] - s[0],
            "states: cumsum": s[2] - s[1],
            "states: w and the copies' wait": s[3] - s[2],
            "states: product and stores": s[4] - s[3],
            "output: staging issue and dt": s[9] - s[8],
            "output: cumsum": s[10] - s[9],
            "output: the copies' wait": s[11] - s[10],
            "output: att": s[12] - s[11],
            "output: y": s[13] - s[12]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result["card"] = card
    text = json.dumps(result, indent=1)
    print(text)
    (ROOT / "chiprun_out" / "phase_stamps.json").write_text(text)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
