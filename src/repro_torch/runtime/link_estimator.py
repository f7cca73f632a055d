"""EWMA effective-bandwidth estimator (NeuPart-style runtime link model).

The planner's Eq. 4 upload term assumes a nominal bandwidth B; the runtime
observes what each transfer *actually* achieved (goodput bytes over the
successful attempt's wire time, zero for a failed transfer) and folds it
into an exponentially-weighted moving average.  Sustained degradation then
shows up as ``degradation() >> 1`` and triggers a *proactive* Pareto-front
re-pick before the next request burns its retries against a link the
estimator already knows is bad."""
from __future__ import annotations


class EwmaLinkEstimator:
    """bw_est <- (1 - alpha) * bw_est + alpha * observed.

    Seeded with the planning bandwidth so the first requests trust the
    plan; ``alpha`` trades reaction speed against noise (0.3 reacts within
    ~3 observations, the transfer layer feeds one per request)."""

    def __init__(self, planned_bandwidth: float, alpha: float = 0.3,
                 floor: float = 1.0):
        if planned_bandwidth <= 0:
            raise ValueError(
                f"planned_bandwidth must be positive, got "
                f"{planned_bandwidth}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.planned = float(planned_bandwidth)
        self.alpha = float(alpha)
        self.floor = float(floor)    # bytes/s; keeps 1/bw finite
        self.bandwidth = float(planned_bandwidth)
        self.n_obs = 0

    def observe(self, nbytes: float, seconds: float) -> float:
        """Fold one observed transfer in; failed transfers pass nbytes=0
        (the time was spent, nothing arrived).  Returns the new estimate."""
        if seconds <= 0:
            return self.bandwidth
        observed = max(nbytes / seconds, self.floor)
        self.bandwidth = ((1.0 - self.alpha) * self.bandwidth
                          + self.alpha * observed)
        self.bandwidth = max(self.bandwidth, self.floor)
        self.n_obs += 1
        return self.bandwidth

    def degradation(self) -> float:
        """planned/estimated bandwidth: 1 = nominal, >1 = degraded (the
        ratio ``core.topsis.link_weights`` and the re-pick consume)."""
        return self.planned / self.bandwidth


def chain_estimators(planned_bandwidths, alpha: float = 0.3,
                     floor: float = 1.0) -> list[EwmaLinkEstimator]:
    """One independent EWMA estimator per hop of a chain, each seeded
    with that hop's planning bandwidth (``core.topsis.chain_link_weights``
    consumes the resulting per-hop degradation ratios)."""
    return [EwmaLinkEstimator(bw, alpha=alpha, floor=floor)
            for bw in planned_bandwidths]
