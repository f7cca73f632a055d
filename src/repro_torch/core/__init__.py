"""SmartSplit core (numpy only): cost models, NSGA-II, TOPSIS and the
split planners -- verbatim copies of ``repro.core``'s modules.  Re-exports
what the port's serving path uses."""
from repro_torch.core.dtype_policy import CONV_DTYPES, WIRE_DTYPES
from repro_torch.core.hardware import PAPER_ENV_J6, paper_chain
from repro_torch.core.multicut import smartsplit_chain
from repro_torch.core.smartsplit import smartsplit_exhaustive

__all__ = ["CONV_DTYPES", "WIRE_DTYPES", "PAPER_ENV_J6", "paper_chain",
           "smartsplit_chain", "smartsplit_exhaustive"]
