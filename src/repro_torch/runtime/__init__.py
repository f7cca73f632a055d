"""Fault-tolerant split-execution runtime of the port: the flaky-link
channel model, reliable transfer, EWMA link estimation, recovery events,
tier faults and circuit breakers (verbatim copies of ``repro.runtime``'s
numpy modules), the boundary wire codec, and ``ChainRuntime`` on torch
tensors (a two-tier split is its K=2 chain)."""
from repro_torch.runtime.breakers import CircuitBreaker, tier_breakers
from repro_torch.runtime.events import Event, EventLog
from repro_torch.runtime.faults import (FaultSpec, FaultyLink, LinkDropped,
                                        LinkError, LinkOutage, LinkTimeout,
                                        VirtualClock, chain_links_from_env,
                                        link_from_env)
from repro_torch.runtime.link_estimator import (EwmaLinkEstimator,
                                                chain_estimators)
from repro_torch.runtime.runtime import (ChainInferenceResult,
                                         ChainResources, ChainRuntime,
                                         SplitUnrecoverable,
                                         microbatch_slices)
from repro_torch.runtime.tier_faults import (FaultyTier, TierCrash,
                                             TierError, TierFaultSpec,
                                             TierShed, tier_faults_from_env)
from repro_torch.runtime.transfer import (ChecksumError, FrameError,
                                          RetryPolicy, TransferFailed,
                                          pack_frames, send_with_retry,
                                          unpack_frames)
from repro_torch.runtime.wire import (BoundaryMeta, decode_boundary,
                                      encode_boundary)

__all__ = [
    "CircuitBreaker", "tier_breakers", "Event", "EventLog",
    "FaultSpec", "FaultyLink", "LinkDropped", "LinkError", "LinkOutage",
    "LinkTimeout", "VirtualClock", "chain_links_from_env", "link_from_env",
    "EwmaLinkEstimator", "chain_estimators",
    "ChainInferenceResult", "ChainResources", "ChainRuntime",
    "SplitUnrecoverable", "microbatch_slices",
    "FaultyTier", "TierCrash", "TierError", "TierFaultSpec", "TierShed",
    "tier_faults_from_env",
    "ChecksumError", "FrameError", "RetryPolicy", "TransferFailed",
    "pack_frames", "send_with_retry", "unpack_frames",
    "BoundaryMeta", "decode_boundary", "encode_boundary",
]
