"""Three-term roofline of the port's dry-run records on NVIDIA H100s: the
counterpart of ``repro.analysis.roofline``.

  compute    = flops a device  / the H100's peak for the record's dtype
  memory     = bytes a device  / HBM3 bandwidth
  collective = collective bytes a device / NVLink bandwidth a direction

The records (``launch/dryrun.py``) hold per-device figures, so the terms
use them directly.  Their flops are the matmuls of the eager path and
their bytes its unfused traffic (``analysis/hlo.py``): a bound, not a
prediction.  MODEL_FLOPS is the analytic 6*N_active*D (train) /
2*N_active*D (inference), so ``useful_ratio`` shows remat, attention and
the embedding gather against it.

The constants come from ``core/hardware.py``: the H100 SXM's data sheet
(dense, no sparsity) at its 700 W power limit, fp32 being the CUDA cores'
rate, which the port runs under ``device.strict_fp32`` (no TF32).
``energy_j`` is the paper's f2 lifted to the fleet, a device's joules a
step from the energy constants measured on the card (pJ/FLOP of the
record's dtype, pJ/HBM byte) and NVLink's unmeasured estimate (pJ/link
byte).  Like the terms, it counts the unfused eager traffic: a bound, not
a prediction."""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import (H100_HBM_BW, H100_HBM_BYTES,
                                       H100_NVLINK_BW, H100_PEAK_FLOPS,
                                       H100_PJ_PER_FLOP, H100_PJ_PER_HBM_BYTE,
                                       NVLINK_PJ_PER_BYTE_ESTIMATE)


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    dtype: str
    compute_s: float
    memory_s: float
    collective_s: float | None
    model_flops: float
    hlo_flops_total: float
    bytes_per_device: float
    hbm_budget_ok: bool

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s or 0.0}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops_total \
            if self.hlo_flops_total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s or 0.0)

    @property
    def energy_j(self) -> float:
        """A device's joules a step: pJ/FLOP of the dtype + pJ/HBM byte +
        pJ/link byte (left out, as in ``bound_s``, where the collectives
        were not counted)."""
        link = 0.0 if self.collective_s is None else \
            self.collective_s * H100_NVLINK_BW * NVLINK_PJ_PER_BYTE_ESTIMATE
        return (self.hlo_flops_total * H100_PJ_PER_FLOP[self.dtype]
                + self.memory_s * H100_HBM_BW * H100_PJ_PER_HBM_BYTE
                + link) * 1e-12


def from_record(rec: dict) -> Roofline:
    """rec: one dry-run JSON record (see launch/dryrun.py).  A record
    whose collectives were not counted has ``collective_s`` None (the
    bound then leaves them out).  ``bytes_per_device`` is the whole
    step's memory on a device: arguments + output + temp - alias (the
    counter of ``analysis/hlo.py``), and ``hbm_budget_ok`` tests it
    against the H100's 80 GB."""
    chips = rec["num_devices"]
    flops_dev = rec["cost"].get("flops", 0.0)
    bytes_dev = rec["cost"].get("bytes accessed", 0.0)
    coll = rec["collective_bytes"]
    mem = rec["memory"]
    resident = sum((mem.get(k) or 0) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes")) - (mem.get("alias_size_in_bytes") or 0)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        dtype=rec["dtype"],
        compute_s=flops_dev / H100_PEAK_FLOPS[rec["dtype"]],
        memory_s=bytes_dev / H100_HBM_BW,
        collective_s=None if coll is None
        else coll.get("total", 0.0) / H100_NVLINK_BW,
        model_flops=rec["model_flops"] / chips,
        hlo_flops_total=flops_dev,
        bytes_per_device=resident,
        hbm_budget_ok=resident <= H100_HBM_BYTES,
    )


def format_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':9s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
           f"{'bound':>10s} {'useful':>7s} {'GB/dev':>8s} {'fits':>5s} "
           f"{'J/dev':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        coll = "n/c" if r.collective_s is None else f"{r.collective_s:.4f}"
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:9s} "
            f"{r.compute_s:10.4f} {r.memory_s:10.4f} {coll:>10s} "
            f"{r.dominant:>10s} {r.useful_ratio:7.2f} "
            f"{r.bytes_per_device / 2**30:8.2f} "
            f"{'yes' if r.hbm_budget_ok else 'NO':>5s} "
            f"{r.energy_j:8.2f}")
    return "\n".join(lines)
