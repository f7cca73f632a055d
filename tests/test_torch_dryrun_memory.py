"""The dry-run's memory of RWKV6's train and prefill cells, fit from two
short sequence lengths (``dryrun._fit_memory``), against the direct
count at the cell's own length, byte for byte.

A train step's peak is the largest of its stages' (``hlo.mark``), and
which stage peaks moves with S: on reduced RWKV6-7B at S 8 and 16 AdamW
peaks (every gradient alive), at S 64 and 128 a block's backward (its
tokens' saved states).  Within a stage the peak moves too (two moments
of a block's backward cross near S 96 at d 256, batch 2: one holding a
weight gradient, one more of the tokens' activations).  A line through
the step's temp at the two short lengths (the fit before stages) is
then below the direct count; so is a line through each stage's peak.
The fit before stages gave 0.343 of the direct temp in the one-device
train case below and 0.829 in the (2, 2, 2) one (measured on the tree
before the moment fit, its direct count turned off).  Each moment's
live bytes are affine in S, and ``hlo.LiveBytes`` keys them alike at
every length (a token loop's by its first and last iterations), so the
fit of each moment, its largest at the cell's S, is the direct count
exactly: no tolerance is needed, and none is given.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

POINTS = (8, 16)
MESHES = {"one": ((1,), ("data",)),
          "222": ((2, 2, 2), ("pod", "data", "model"))}
CASES = [("one", "train", 128, 1), ("222", "train", 64, 8),
         ("one", "prefill", 128, 1), ("222", "prefill", 64, 8)]


def reduced(num_layers):
    return dataclasses.replace(all_configs()["rwkv6-7b"].reduced(),
                               num_layers=num_layers, name="rwkv6-7b")


def _mesh(name):
    return M.make_debug_mesh(*MESHES[name], device="meta")


def direct(cfg, shape, mesh, dtype=torch.float32):
    """One device's memory counted at ``shape``'s own length and the real
    depth, and its temp by stage: the plain pass on one device, else the
    DTensor pass (its op budget does not apply here)."""
    if mesh.devices.size == 1:
        res = DR._measure(cfg, shape, mesh, dtype, memory=True)
        return res["memory"], res["stage_temps"]
    with DR._fake_group(int(mesh.devices.size)):
        device_mesh, joins = DR._device_mesh(mesh)
        res = DR._measure_collectives(cfg, shape, mesh, dtype,
                                      device_mesh, joins, ep=True)
    return res["memory"], res["stage_temps"]


def _peak_stage(stages):
    return max(stages, key=stages.get)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mesh,mode,S,B", CASES,
                         ids=[f"{m}-{mode}" for m, mode, _, _ in CASES])
def test_rwkv_memory_fit_equals_the_direct_count(monkeypatch, mesh, mode,
                                                  S, B, dtype):
    """The record's output, temp and alias at S (64 or 128), fit from S 8
    and 16 -- on one device at the real depth, on the (2, 2, 2) mesh over
    the depth variants B2 and B4 as well -- equal the direct count at
    that length and the real depth (4 layers on the mesh), byte for
    byte, and so does each stage's temp, in fp32 and in the dry-run's
    default bf16.  In train the peak moves from AdamW at the fit points
    to a block's backward at S."""
    monkeypatch.setattr(DR, "SEQ_POINTS", POINTS)
    cfg = reduced(2 if mesh == "one" else 4)
    shape = InputShape("t", S, B, mode)
    rec = DR.lower_cell(cfg, shape, _mesh(mesh), "m", dtype=dtype)
    assert rec["extrapolation"]["seq_len"] == list(POINTS)
    want, stages = direct(cfg, shape, _mesh(mesh), dtype)
    for key in DR.MEMORY_KEYS:
        assert rec["memory"][key] == want[key], (key, rec["memory"], want)
    assert "each fit in S from [8, 16] moment by moment" \
        in rec["memory_note"]
    assert "lower bound" not in rec["memory_note"]
    got = rec["memory_stages"]
    if mesh == "one":
        assert got == stages
    else:          # the units between the first and the last are not fit
        assert got == {k: v for k, v in stages.items()
                       if k not in ("forward: unit 1", "forward: unit 2",
                                    "backward: unit 1", "backward: unit 2")}
        assert max(got.values()) == max(stages.values())
    if mode == "train":
        _, short = direct(cfg, dataclasses.replace(shape, seq_len=POINTS[1]),
                          _mesh(mesh), dtype)
        assert _peak_stage(short) == "optimizer"
        assert _peak_stage(stages).startswith("backward: unit")


def test_a_line_through_the_short_lengths_is_below_the_count():
    """The fault the moment fit repairs, on the one-device train case: a
    line through the step's temp at S 8 and 16 -- and one through each
    stage's peak -- gives less than the direct count at S 128."""
    cfg, mesh = reduced(2), _mesh("one")
    at = {s: direct(cfg, InputShape("t", s, 1, "train"), mesh)
          for s in (*POINTS, 128)}

    def line(a, b):
        return a + (b - a) * (128 - POINTS[0]) / (POINTS[1] - POINTS[0])
    temp = {s: m["temp_size_in_bytes"] for s, (m, _) in at.items()}
    assert line(temp[8], temp[16]) < temp[128]
    by_stage = max(line(at[8][1][k], at[16][1][k]) for k in at[128][1])
    assert by_stage < temp[128]


def test_mismatched_moments_raise(monkeypatch):
    """Runs whose moments do not correspond one to one (here: fit points
    too short for the token loop to run its first and last iterations
    apart) raise rather than give a number."""
    monkeypatch.setattr(DR, "SEQ_POINTS", (2, 3))
    with pytest.raises(ValueError, match="do not match one to one"):
        DR.lower_cell(reduced(2), InputShape("t", 8, 1, "train"),
                      _mesh("one"), "m", dtype=torch.float32)


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a call dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_stage_marks_leave_the_step_s_ops_unchanged():
    """A reduced RWKV6-7B train step on CPU tensors (block remat, its
    token loop) dispatches the same aten ops in the same order, and
    gives the same parameters, moments and metrics bitwise, whether the
    dry-run's marks act -- the step under a counting ``LiveBytes`` with
    the token step a ``loop_body``: hooks on every unit's input, the
    marks around the gradient reduction -- or not (the train step as
    ``make_train_step`` makes it, nothing counting)."""
    from repro_torch.analysis import hlo
    from repro_torch.launch import partition as PT
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer
    from repro_torch.tree import leaves
    cfg, shape = reduced(2), InputShape("t", 12, 2, "train")
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
             for k in ("tokens", "labels")}
    runs = []
    for marked in (False, True):
        params = T.init_params(cfg, 0, torch.float32, device="cpu")
        state = optimizer.init_state(params)
        step = DR._step(cfg, shape) if marked else PT.make_train_step(cfg)
        with _Ops() as rec:
            if marked:
                live = hlo.LiveBytes((params, state, batch))
                with DR._token_loops(), live:
                    out = step(params, state, batch)
                stages = live.stage_peaks
            else:
                out = step(params, state, batch)
        runs.append((rec.ops, leaves(out)))
    (ops0, out0), (ops1, out1) = runs
    assert len(ops0) > 1000 and ops1 == ops0
    assert len(out0) == len(out1)
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))
    assert {"forward: unit 1", "backward: unit 0", "backward: embedding",
            "gradient reduction", "optimizer"} <= set(stages)
