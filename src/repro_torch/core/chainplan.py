"""The unified split-plan abstraction: an ordered chain of K stages.

Every planner output in the repo is a ``ChainPlan``: ``smartsplit()`` /
``smartsplit_exhaustive()`` return the degenerate K=2 instance (one cut,
one link -- the paper's phone/cloud split), ``smartsplit_multicut()`` /
``smartsplit_chain()`` return the general K-tier case.  ``SplitPlan`` and
``MultiCutPlan`` are aliases of this class, kept so existing callers (and
the paper-faithful tests) read naturally.

A plan carries everything the runtime needs to *execute and degrade*
without re-running the optimiser: the picked cuts, the cached Pareto
front over cut vectors, the per-hop ``LinkProfile``s the objectives were
priced against, and the microbatch count the pipeline latency term
assumed.  ``runtime.ChainRuntime`` walks the stages, re-picks from the
cached front under per-hop bandwidth estimates, and collapses cuts
(``merge_hop``) when a hop dies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hardware import LinkProfile


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """K-stage placement of ``num_layers`` layers over a tier chain.

    cuts: K-1 strictly-increasing layer indices; stage k runs layers
      ``[edges[k], edges[k+1])`` with ``edges = (0, *cuts, L)``.
    pareto_cuts: (n, K-1) cut vectors of the cached Pareto front (rows
      sorted ascending) -- the runtime re-pick search space.
    pareto_F: (n, 3) objective rows matching ``pareto_cuts``.
    links: the K-1 nominal per-hop link profiles the plan assumed.
    tiers: the K tier names (``tiers[0]`` is the legacy ``hardware``
      field of the old two-tier SplitPlan).
    microbatches: pipeline depth M the latency objective was priced at
      (1 = sequential stage execution).
    wire_dtypes: the concrete per-hop wire formats (``fp32``/``bf16``/
      ``int8``) the objectives were priced under -- () on plans from
      before the wire tier (the runtime then resolves from env).
    """

    model: str
    num_layers: int
    cuts: tuple[int, ...]
    objectives: tuple[float, float, float]   # (latency s, energy J, mem)
    pareto_cuts: np.ndarray
    pareto_F: np.ndarray
    links: tuple[LinkProfile, ...]
    tiers: tuple[str, ...]
    microbatches: int = 1
    wire_dtypes: tuple[str, ...] = ()

    def __post_init__(self):
        L = self.num_layers
        for c in self.cuts:
            if not 1 <= c <= L - 1:
                raise ValueError(
                    f"ChainPlan cut {c} out of range [1, {L - 1}] "
                    f"for a {L}-layer model")
        for a, b in zip(self.cuts, self.cuts[1:]):
            if b <= a:
                raise ValueError(
                    f"ChainPlan cuts must be strictly increasing, got "
                    f"{self.cuts}")
        if len(self.tiers) != len(self.cuts) + 1:
            raise ValueError(
                f"ChainPlan tier/cut mismatch: {len(self.cuts)} cuts "
                f"need {len(self.cuts) + 1} tiers, got {len(self.tiers)}")
        if len(self.links) != len(self.tiers) - 1:
            raise ValueError(
                f"ChainPlan tier/link mismatch: {len(self.tiers)} tiers "
                f"need {len(self.tiers) - 1} links, got {len(self.links)}")
        if self.microbatches < 1:
            raise ValueError(
                f"ChainPlan microbatches must be >= 1, got "
                f"{self.microbatches}")
        if self.wire_dtypes and len(self.wire_dtypes) != len(self.links):
            raise ValueError(
                f"ChainPlan wire/link mismatch: {len(self.links)} links "
                f"need {len(self.links)} wire dtypes, got "
                f"{len(self.wire_dtypes)}")

    # -- chain views ----------------------------------------------------
    @property
    def num_tiers(self) -> int:
        return len(self.cuts) + 1

    @property
    def edges(self) -> tuple[int, ...]:
        return (0,) + self.cuts + (self.num_layers,)

    def stages(self, L: int | None = None) -> list[tuple[int, int]]:
        """Per-stage (start, stop) layer ranges.  ``L`` is accepted for
        back-compat with the old ``MultiCutPlan.stages(L)`` call shape
        and must match ``num_layers`` when given."""
        if L is not None and L != self.num_layers:
            raise ValueError(
                f"stages(L={L}) disagrees with plan num_layers="
                f"{self.num_layers}")
        e = self.edges
        return [(e[i], e[i + 1]) for i in range(len(e) - 1)]

    def merge_hop(self, hop: int) -> "ChainPlan":
        """Collapse cut ``hop``: stage ``hop+1``'s layers fold into stage
        ``hop``'s tier and the hop's link drops out of the chain -- the
        planning-side mirror of the runtime's stage-merge degradation.
        The cached front is not carried over (it indexes the old cut
        arity)."""
        if not 0 <= hop < len(self.cuts):
            raise ValueError(
                f"merge_hop: hop must be in [0, {len(self.cuts) - 1}], "
                f"got {hop}")
        cuts = self.cuts[:hop] + self.cuts[hop + 1:]
        wires = self.wire_dtypes
        if wires:
            wires = wires[:hop] + wires[hop + 1:]
        return dataclasses.replace(
            self, cuts=cuts,
            pareto_cuts=np.empty((0, len(cuts)), np.int64),
            pareto_F=np.empty((0, 3)),
            links=self.links[:hop] + self.links[hop + 1:],
            tiers=self.tiers[:hop + 1] + self.tiers[hop + 2:],
            wire_dtypes=wires)

    # -- two-tier (K=2) legacy surface ---------------------------------
    @property
    def split_index(self) -> int:
        """l1 of the paper's single split (K=2 plans only)."""
        if len(self.cuts) != 1:
            raise ValueError(
                f"split_index is a two-tier view; this plan has "
                f"{len(self.cuts)} cuts")
        return self.cuts[0]

    @property
    def pareto_indices(self) -> tuple[int, ...]:
        """Pareto-set split indices (K=2 plans only; plot/test surface)."""
        if self.pareto_cuts.ndim != 2 or self.pareto_cuts.shape[1] != 1:
            raise ValueError(
                "pareto_indices is a two-tier view; use pareto_cuts")
        return tuple(int(c) for c in self.pareto_cuts[:, 0])

    @property
    def hardware(self) -> str:
        """Legacy SplitPlan field: the first (client/device) tier name."""
        return self.tiers[0]

    @property
    def client_layers(self) -> int:
        return self.split_index

    @property
    def server_layers(self) -> int:
        return self.num_layers - self.split_index


# The legacy names: the paper's two-tier plan and the beyond-paper K-cut
# plan are the same abstraction now.
SplitPlan = ChainPlan
MultiCutPlan = ChainPlan
