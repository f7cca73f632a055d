"""SmartSplit core (numpy only): cost models, NSGA-II, TOPSIS, the split
planners and the paper's competing baselines -- verbatim copies of
``repro.core``'s modules, apart from ``hardware``'s pod profiles, which
are the H100's.  Re-exports what the port's serving path uses."""
from repro_torch.core.baselines import ALGORITHMS, coc, cos, ebo, lbo, mbo, rs
from repro_torch.core.dtype_policy import CONV_DTYPES, WIRE_DTYPES
from repro_torch.core.hardware import (H100_EDGE_CLOUD, PAPER_ENV_J6,
                                       h100_edge_cloud, paper_chain)
from repro_torch.core.multicut import smartsplit_chain
from repro_torch.core.smartsplit import smartsplit, smartsplit_exhaustive

__all__ = ["ALGORITHMS", "coc", "cos", "ebo", "lbo", "mbo", "rs",
           "CONV_DTYPES", "WIRE_DTYPES", "H100_EDGE_CLOUD", "PAPER_ENV_J6",
           "h100_edge_cloud", "paper_chain", "smartsplit", "smartsplit_chain",
           "smartsplit_exhaustive"]
