"""Competing algorithms from paper Section VI-C.

LBO  -- latency-based optimisation: argmin f1 over feasible splits.
EBO  -- energy-based optimisation:  argmin f2.
MBO  -- memory-based optimisation:  argmin f3 (implied by f3; beyond-paper
        completeness -- trivially l1=1, included for the ablation).
COS  -- CNN on smartphone: l1 = L.
COC  -- CNN on cloud:      l1 = 0.
RS   -- random split, uniform over [1, L-1] per run.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.costs import (ModelProfile, evaluate_objectives,
                              feasible_mask)
from repro_torch.core.hardware import TwoTierHardware


def _argmin_feasible(F: np.ndarray, feas: np.ndarray, col: int) -> int:
    masked = np.where(feas, F[:, col], np.inf)
    return int(np.argmin(masked))


def lbo(profile: ModelProfile, hw: TwoTierHardware) -> int:
    F = evaluate_objectives(profile, hw)
    return _argmin_feasible(F, feasible_mask(profile, hw), 0)


def ebo(profile: ModelProfile, hw: TwoTierHardware) -> int:
    F = evaluate_objectives(profile, hw)
    return _argmin_feasible(F, feasible_mask(profile, hw), 1)


def mbo(profile: ModelProfile, hw: TwoTierHardware) -> int:
    F = evaluate_objectives(profile, hw)
    return _argmin_feasible(F, feasible_mask(profile, hw), 2)


def cos(profile: ModelProfile, hw: TwoTierHardware) -> int:  # noqa: ARG001
    return profile.num_layers


def coc(profile: ModelProfile, hw: TwoTierHardware) -> int:  # noqa: ARG001
    return 0


def rs(profile: ModelProfile, hw: TwoTierHardware,  # noqa: ARG001
       rng: np.random.Generator | None = None) -> int:
    rng = rng or np.random.default_rng()
    return int(rng.integers(1, profile.num_layers))


ALGORITHMS = {"LBO": lbo, "EBO": ebo, "MBO": mbo, "COS": cos, "COC": coc,
              "RS": rs}
