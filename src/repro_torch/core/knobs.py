"""Registry of every ``REPRO_*`` environment knob, as code.

Every env knob the repo reads is declared here exactly once -- name,
default, type, where it is resolved, and whether a per-hop
``REPRO_LINK{k}_*`` override exists.  ``scripts/gen_knobs.py`` renders
this table into ``docs/knobs.md``, and ``tests/test_knobs.py`` scans the
source tree for ``os.environ`` reads of ``REPRO_*`` names and asserts
each one appears here -- so the docs cannot silently drift from the
code: adding a knob without registering it is a tier-1 failure.

This module is stdlib-only (no jax) so the docs tooling and CI docs job
can import it without the accelerator stack.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Knob:
    """One environment knob: the registry row ``docs/knobs.md`` renders.

    per_hop: template of the per-hop override accepted alongside the
      chain-wide name (``{k}`` = 0-based hop id), or None."""

    name: str
    default: str        # rendered verbatim; "" = empty/unset
    type: str           # int | float | str | flag | choice | windows
    resolved_in: str    # module.symbol that reads it
    description: str
    per_hop: str | None = None


KNOBS: tuple[Knob, ...] = (
    # -- kernels / numerics --------------------------------------------
    Knob("REPRO_CONV_BACKEND", "xla", "choice: xla|pallas",
         "models.cnn.apply_cnn",
         "Conv2D execution backend: XLA reference or the Pallas kernel."),
    Knob("REPRO_CONV_DTYPE", "fp32", "choice: fp32|bf16",
         "core.dtype_policy.conv_dtype",
         "Storage/compute dtype for conv activations and the boundary "
         "tensor the cost model prices."),
    Knob("REPRO_WIRE_DTYPE", "follow", "choice: follow|fp32|bf16|int8",
         "core.dtype_policy.wire_dtype",
         "Wire dtype for boundary payloads; `follow` streams whatever "
         "the storage dtype is, `int8` adds quantized framing.",
         per_hop="REPRO_LINK{k}_WIRE_DTYPE"),
    Knob("REPRO_CONV_SEARCH", "1", "flag",
         "kernels.conv2d.search_enabled",
         "Enable the W-axis tile-size search for the Pallas conv kernel "
         "(0 pins the default tile)."),
    Knob("REPRO_CONV_TILE_W", "0", "int",
         "kernels.conv2d.forced_tile_w",
         "Force a specific W tile width for the Pallas conv kernel "
         "(0 = let the search/heuristic pick)."),
    Knob("REPRO_PALLAS_COMPILE", "0", "flag",
         "kernels.ops.interpret_mode",
         "1 compiles Pallas kernels for the accelerator; 0 (default) "
         "runs them in interpret mode, which works on CPU."),
    # -- launch / parallelism ------------------------------------------
    Knob("REPRO_FSDP", "1", "flag",
         "launch.partition.partition_params",
         "Shard parameters FSDP-style across the data axis (0 = "
         "replicate)."),
    Knob("REPRO_MOE_EP", "1", "flag",
         "launch.dryrun.main",
         "Give the MoE layer an expert-parallel mesh in the dry-run "
         "launcher (0 = dense placement)."),
    # -- split planning / chain execution ------------------------------
    Knob("REPRO_CHAIN_TIERS", "2", "int",
         "launch.serve / serving.cnn_engine",
         "Number of chain tiers to plan for (2 = the paper's "
         "phone/cloud pair; 3-4 add edge tiers via `paper_chain`)."),
    Knob("REPRO_CHAIN_MICROBATCH", "plan.microbatches", "int",
         "runtime.ChainRuntime",
         "Microbatches per request for the within-request pipeline "
         "schedule (default: whatever the plan was priced with)."),
    # -- link fault injection (all accept per-hop overrides) -----------
    Knob("REPRO_LINK_BW", "plan nominal", "float",
         "runtime.faults.link_from_env",
         "Link bandwidth in bytes/s (default: the bandwidth the plan "
         "was priced with).", per_hop="REPRO_LINK{k}_BW"),
    Knob("REPRO_LINK_LATENCY", "0", "float",
         "runtime.faults.link_from_env",
         "Fixed per-transfer latency in seconds.",
         per_hop="REPRO_LINK{k}_LATENCY"),
    Knob("REPRO_LINK_DROP", "0", "float",
         "runtime.faults.link_from_env",
         "Probability each wire attempt is dropped.",
         per_hop="REPRO_LINK{k}_DROP"),
    Knob("REPRO_LINK_CORRUPT", "0", "float",
         "runtime.faults.link_from_env",
         "Probability each delivered attempt is corrupted (caught by "
         "crc32 framing).", per_hop="REPRO_LINK{k}_CORRUPT"),
    Knob("REPRO_LINK_DELAY", "0", "float",
         "runtime.faults.link_from_env",
         "Probability each attempt is hit by a delay fault.",
         per_hop="REPRO_LINK{k}_DELAY"),
    Knob("REPRO_LINK_DELAY_S", "0.5", "float",
         "runtime.faults.link_from_env",
         "Extra seconds added when a delay fault fires.",
         per_hop="REPRO_LINK{k}_DELAY_S"),
    Knob("REPRO_LINK_OUTAGES", "", "windows",
         "runtime.faults.link_from_env",
         "Outage windows in virtual time, `start:end[,start:end...]` "
         "seconds.", per_hop="REPRO_LINK{k}_OUTAGES"),
    Knob("REPRO_LINK_SEED", "0", "int",
         "runtime.faults.link_from_env",
         "Fault-schedule seed; on a chain, hop k draws from seed+k "
         "unless its per-hop knob pins a seed verbatim.",
         per_hop="REPRO_LINK{k}_SEED"),
    # -- retry policy ---------------------------------------------------
    Knob("REPRO_LINK_RETRIES", "4", "int",
         "runtime.transfer.RetryPolicy.from_env",
         "Max wire attempts per logical transfer."),
    Knob("REPRO_LINK_TIMEOUT", "5.0", "float",
         "runtime.transfer.RetryPolicy.from_env",
         "Per-transfer timeout in virtual seconds."),
    Knob("REPRO_LINK_BACKOFF", "0.05", "float",
         "runtime.transfer.RetryPolicy.from_env",
         "Base backoff after a failed attempt (doubles per retry, "
         "jittered)."),
    Knob("REPRO_LINK_BACKOFF_FACTOR", "2.0", "float",
         "runtime.transfer.RetryPolicy.from_env",
         "Multiplier applied to the backoff base per failed attempt "
         "(attempt i waits base * factor^(i-1))."),
    Knob("REPRO_LINK_JITTER", "0.25", "float",
         "runtime.transfer.RetryPolicy.from_env",
         "Backoff jitter amplitude: each wait is scaled by "
         "1 + jitter * U[0,1) from the caller's seeded rng."),
    # -- tier fault injection (all accept per-tier overrides) -----------
    Knob("REPRO_TIER_CRASH", "0", "float",
         "runtime.tier_faults.tier_from_env",
         "Probability each stage execution crashes on the tier.",
         per_hop="REPRO_TIER{k}_CRASH"),
    Knob("REPRO_TIER_CRASH_WINDOWS", "", "windows",
         "runtime.tier_faults.tier_from_env",
         "Dead windows in virtual time, `start:end[,start:end...]` "
         "seconds: every stage overlapping one dies (restart = the "
         "window ending).", per_hop="REPRO_TIER{k}_CRASH_WINDOWS"),
    Knob("REPRO_TIER_SLOW", "0", "float",
         "runtime.tier_faults.tier_from_env",
         "Straggler probability per stage execution (slowdowns are not "
         "failures: they never trip breakers).",
         per_hop="REPRO_TIER{k}_SLOW"),
    Knob("REPRO_TIER_SLOW_FACTOR", "4.0", "float",
         "runtime.tier_faults.tier_from_env",
         "Compute-time multiplier applied when a straggler fault fires.",
         per_hop="REPRO_TIER{k}_SLOW_FACTOR"),
    Knob("REPRO_TIER_MEM_BUDGET", "0", "float",
         "runtime.tier_faults.tier_from_env",
         "Admission budget in bytes (0 = unlimited): a stage whose "
         "activation footprint exceeds it is shed before running.",
         per_hop="REPRO_TIER{k}_MEM_BUDGET"),
    Knob("REPRO_TIER_MEM_PROFILE", "", "windows",
         "runtime.tier_faults.tier_from_env",
         "Time-varying admission budget, `start:budget[,start:budget"
         "...]` (seconds : bytes), overriding REPRO_TIER_MEM_BUDGET "
         "from each start time onward.",
         per_hop="REPRO_TIER{k}_MEM_PROFILE"),
    Knob("REPRO_TIER_SEED", "0", "int",
         "runtime.tier_faults.tier_from_env",
         "Tier fault-schedule seed; on a chain, tier k draws from "
         "seed+k unless its per-tier knob pins a seed verbatim.",
         per_hop="REPRO_TIER{k}_SEED"),
    # -- serving engine -------------------------------------------------
    Knob("REPRO_SERVE_MAX_BATCH", "4", "int",
         "serving.cnn_engine.CnnServingEngine",
         "Batch packing limit per (model, resolution, dtype, wire) "
         "bucket; also the microbatch count when pipelining."),
    Knob("REPRO_SERVE_QUEUE_DEPTH", "64", "int",
         "serving.cnn_engine.CnnServingEngine",
         "Bounded request-queue depth; beyond it `submit` sheds with "
         "`QueueFullError`."),
    Knob("REPRO_SERVE_PIPELINED", "1", "flag",
         "serving.cnn_engine.CnnServingEngine",
         "Cross-request pipelining on the virtual clock (0 = "
         "sequential baseline: each batch waits out the previous "
         "one's makespan)."),
)


def registry_names() -> set[str]:
    """Every accepted env name, per-hop templates included (with the
    literal ``{k}`` placeholder -- the scanner canonicalises to it)."""
    names = set()
    for k in KNOBS:
        names.add(k.name)
        if k.per_hop:
            names.add(k.per_hop)
    return names


# -- source scanner -----------------------------------------------------
# Matches module-level UPPER_CASE constants bound to a REPRO_* literal
# (SEARCH_ENV, ENV_PREFIX, MAX_BATCH_ENV, ...).
_CONST_RE = re.compile(
    r'^([A-Z][A-Z0-9_]*)\s*=\s*["\'](REPRO_[A-Z0-9_]*)["\']', re.M)
# direct environ reads with a (possibly f-) string literal name
_DIRECT_RE = re.compile(
    r'environ(?:\.get)?\s*[\[(]\s*(f?)["\']([^"\']+)["\']')
# environ.get(CONST) or get(CONST + <literal suffix>) -- the bare `get`
# form catches the `get = os.environ.get` aliasing idiom.
_CONST_USE_RE = re.compile(
    r'\bget\s*\(\s*([A-Z][A-Z0-9_]*)\s*'
    r'(?:\+\s*["\']([A-Za-z0-9_]+)["\'])?\s*[,)]')
# _env_raw("DROP", hop) / _env_float("BW", ...): the faults.py per-hop
# lookup helpers; a literal first arg names a REPRO_LINK_* knob read
# both chain-wide and as REPRO_LINK{k}_*.
_WRAPPER_RE = re.compile(r'\b_env_[a-z]+\(\s*["\']([A-Z0-9_]+)["\']')
# _tier_env_raw("CRASH", tier) / _tier_env_float(...): the
# tier_faults.py per-tier lookup helpers -- same contract with the
# REPRO_TIER_* / REPRO_TIER{k}_* prefix pair.
_TIER_WRAPPER_RE = re.compile(
    r'\b_tier_env_[a-z]+\(\s*["\']([A-Z0-9_]+)["\']')
# f-string placeholders that index a hop or tier (canonicalised to {k})
_HOP_PLACEHOLDER_RE = re.compile(r'\{(?:k|hop)\}')

_LINK_PREFIX = "REPRO_LINK_"
_TIER_PREFIX = "REPRO_TIER_"


def scan_env_reads(root: str | Path | None = None) -> set[str]:
    """Every ``REPRO_*`` env name read under ``root`` (default: the
    ``repro`` package this module lives in), canonicalised: per-hop
    f-string reads become ``REPRO_LINK{k}_X``; reads through the
    faults.py ``_env_*`` helpers yield both the chain-wide and per-hop
    forms.  Docstring mentions are NOT picked up -- only code paths
    that reach ``os.environ``."""
    if root is None:
        root = Path(__file__).resolve().parents[1]
    root = Path(root)
    consts: dict[str, str] = {}
    texts: dict[Path, str] = {}
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        texts[path] = text
        for m in _CONST_RE.finditer(text):
            consts[m.group(1)] = m.group(2)
    names: set[str] = set()
    for text in texts.values():
        for is_f, lit in _DIRECT_RE.findall(text):
            if is_f:
                lit = _HOP_PLACEHOLDER_RE.sub("{k}", lit)
                if "{" in lit.replace("{k}", ""):
                    continue    # non-hop placeholder: a helper's
                    # dynamic dispatch, covered by the wrapper scan
            if lit.startswith("REPRO_"):
                names.add(lit)
        for const, suffix in _CONST_USE_RE.findall(text):
            base = consts.get(const)
            if base is None:
                continue
            names.add(base + suffix if suffix else base)
        for suffix in _WRAPPER_RE.findall(text):
            names.add(_LINK_PREFIX + suffix)
            names.add("REPRO_LINK{k}_" + suffix)
        for suffix in _TIER_WRAPPER_RE.findall(text):
            names.add(_TIER_PREFIX + suffix)
            names.add("REPRO_TIER{k}_" + suffix)
    return names


def render_markdown() -> str:
    """The full ``docs/knobs.md`` content (``scripts/gen_knobs.py``
    writes it; the CI docs job regenerates and diffs)."""
    lines = [
        "# Environment knobs",
        "",
        "<!-- GENERATED by scripts/gen_knobs.py from "
        "src/repro/core/knobs.py. Do not edit by hand:",
        "     regenerate with `PYTHONPATH=src python scripts/gen_knobs.py`"
        " -->",
        "",
        "Every `REPRO_*` environment variable the code reads, in one "
        "table. The",
        "registry lives in [`core/knobs.py`](../src/repro/core/knobs.py);"
        " a tier-1",
        "test scans `src/` for `os.environ` reads and fails if any "
        "`REPRO_*` name",
        "is missing from it, so this page cannot drift from the code.",
        "",
        "Knobs marked *per-hop* also accept a `REPRO_LINK{k}_*` form "
        "(`{k}` =",
        "0-based hop id) that overrides the chain-wide value for one "
        "link only --",
        "how the chaos harness aims a fault at a single hop. "
        "`REPRO_TIER_*` knobs",
        "override per *tier* the same way (`REPRO_TIER{k}_*`, `{k}` = "
        "0-based tier id).",
        "",
        "| Knob | Default | Type | Resolved in | Per-hop | What it does |",
        "|---|---|---|---|---|---|",
    ]
    esc = lambda s: s.replace("|", "\\|")  # noqa: E731 -- cell-safe pipes
    for k in KNOBS:
        default = f"`{k.default}`" if k.default else "*(unset)*"
        per_hop = f"`{k.per_hop}`" if k.per_hop else "--"
        lines.append(
            f"| `{k.name}` | {default} | {esc(k.type)} | `{k.resolved_in}` "
            f"| {per_hop} | {esc(k.description)} |")
    lines += [
        "",
        "Precedence everywhere: explicit function argument > per-hop "
        "env knob >",
        "chain-wide env knob > default.",
        "",
    ]
    return "\n".join(lines)
