"""A run's ``correct`` on the CPU: true for the program as it is, false for
the control and for each fault a cell can have, planted under the timed
path.  The runs skip the look for a card (``run_cell(device="cpu")``)
and size the MobileNetV2 cell down to batches of 4 at its own 224 px and
cuts; everything else is a run's own path."""
import pytest
import torch

from chipbench import control, manifest
from chipbench.run import run_cell

CELL = "mobilenetv2-bf16.fused-b128"
SMALL = {"mix": {"clients": 8, "max_batch": 4, "max_queue": 8,
                 "pool_images": 16, "check_batches": 2}}
BENCH = manifest.load()


def _run(seed=7):
    return run_cell(BENCH, CELL, seed=seed, seconds=0.5, trace=False,
                    device="cpu", overrides=SMALL)


def test_the_program_as_it_is_runs_correct():
    out = _run()
    assert out["correct"], out["checks"]
    rows = out["reference"]["rows"]          # whole batches of 4, one at least
    assert rows >= 4 and rows % 4 == 0
    assert list(out["checks"])[-1] == "logit_err"


def test_the_control_fails_the_limit_the_program_meets():
    limit = manifest.config("mobilenetv2-bf16")["limits"]["logit_err"]
    (row,) = control.readings(CELL, [2**31 + 3], 0.5, device="cpu",
                              overrides=SMALL)
    assert row["program_correct"] and row["program_logit_err"] <= limit
    assert not row["control_correct"]
    assert row["control_logit_err"] > limit


def test_the_control_in_the_programs_place_makes_the_run_incorrect():
    out = run_cell(BENCH, CELL, seed=11, seconds=0.5, trace=False,
                   device="cpu", overrides=SMALL,
                   control=getattr(torch, control.CONTROL))
    assert not out["correct"], out["checks"]


def _answer_altered(monkeypatch):
    """The classifier's rows come out of order: an answer altered where
    it is produced."""
    from repro_torch.models import cnn as cnn_lib
    apply_layer = cnn_lib.apply_layer

    def altered(layer, params, x, dtype=None):
        y = apply_layer(layer, params, x, dtype=dtype)
        return y.roll(1, dims=0) if layer.kind == "gap_linear" else y

    monkeypatch.setattr(cnn_lib, "apply_layer", altered)


def _boundary_unquantized(monkeypatch):
    """The first hop ships the bf16 boundary as it is: the int8 exchange
    left out."""
    from repro_torch.runtime import runtime as rt
    encode = rt.encode_boundary
    monkeypatch.setattr(rt, "encode_boundary",
                        lambda arr, wire: encode(arr, "bf16"))


def _hop_merged(monkeypatch):
    """Every send on the link fails, so the runtime folds the stages onto
    one tier: the exchange between tiers left out."""
    from repro_torch.runtime import faults
    from repro_torch.runtime.runtime import ChainRuntime

    def dropped(self, t0, data, timeout_s):
        self.sends += 1
        raise faults.LinkDropped("dropped", timeout_s)

    monkeypatch.setattr(faults.FaultyLink, "send_at", dropped)
    monkeypatch.setattr(ChainRuntime, "_merge_ok",
                        lambda self, tier, start, stop: True)


@pytest.mark.parametrize("fault", [_answer_altered, _boundary_unquantized,
                                   _hop_merged], ids=lambda f: f.__name__)
def test_a_planted_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]


def test_a_cuda_less_machine_gets_no_result(monkeypatch, capsys):
    from chipbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"]) \
        == 2
    assert capsys.readouterr().out == ""
