"""The port's roofline (``repro_torch.analysis.roofline``) on hand-made
dry-run records: each term from the H100's data-sheet constants, the
peak chosen by the record's dtype, the 80 GB budget, the energy from the
card's measured constants (``core/hardware.py``), and the table."""
import pytest

pytest.importorskip("torch")

from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.core import hardware as H  # noqa: E402


def record(**over):
    rec = {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "single16x16",
           "num_devices": 256, "dtype": "bf16",
           "cost": {"flops": 989e12, "bytes accessed": 6.7e12},
           "collective_bytes": {"all-gather": 450e9, "total": 900e9},
           "memory": {"argument_size_in_bytes": 40e9,
                      "output_size_in_bytes": None,
                      "temp_size_in_bytes": None,
                      "alias_size_in_bytes": None},
           "model_flops": 256 * 494.5e12}
    rec.update(over)
    return rec


def test_terms_use_the_h100_constants():
    r = R.from_record(record())
    assert r.compute_s == pytest.approx(1.0)          # 989 TFLOP at bf16
    assert r.memory_s == pytest.approx(2.0)           # 6.7 TB at 3.35 TB/s
    assert r.collective_s == pytest.approx(2.0)       # 900 GB at 450 GB/s
    assert r.bound_s == pytest.approx(2.0)
    assert r.dominant == "memory"
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.bytes_per_device == 40e9 and r.hbm_budget_ok


def test_fp32_takes_the_cuda_core_peak_and_no_energy():
    """fp32 takes the CUDA cores' peak, and its energy the fp32 pJ/FLOP
    (the name is older than ``energy_j``, which the port now has)."""
    r = R.from_record(record(dtype="fp32"))
    assert r.compute_s == pytest.approx(989e12 / 67e12)
    assert r.dominant == "compute"
    assert r.dtype == "fp32"
    assert r.energy_j == pytest.approx(
        (989e12 * H.H100_PJ_PER_FLOP["fp32"]
         + 6.7e12 * H.H100_PJ_PER_HBM_BYTE
         + 900e9 * H.NVLINK_PJ_PER_BYTE_ESTIMATE) * 1e-12, rel=1e-12)


def test_energy_takes_the_dtype_and_leaves_out_uncounted_collectives():
    bf16 = R.from_record(record())
    assert bf16.energy_j == pytest.approx(
        (989e12 * H.H100_PJ_PER_FLOP["bf16"]
         + 6.7e12 * H.H100_PJ_PER_HBM_BYTE
         + 900e9 * H.NVLINK_PJ_PER_BYTE_ESTIMATE) * 1e-12, rel=1e-12)
    none = R.from_record(record(collective_bytes=None))
    assert none.energy_j == pytest.approx(
        (989e12 * H.H100_PJ_PER_FLOP["bf16"]
         + 6.7e12 * H.H100_PJ_PER_HBM_BYTE) * 1e-12, rel=1e-12)
    assert none.energy_j < bf16.energy_j


def test_uncounted_collectives_and_the_budget():
    r = R.from_record(record(collective_bytes=None, memory={
        "argument_size_in_bytes": 81e9, "output_size_in_bytes": None,
        "temp_size_in_bytes": None, "alias_size_in_bytes": None}))
    assert r.collective_s is None
    assert r.bound_s == pytest.approx(2.0)
    assert not r.hbm_budget_ok


def test_format_table():
    rows = [R.from_record(record()),
            R.from_record(record(arch="rwkv6-7b", collective_bytes=None))]
    lines = R.format_table(rows).splitlines()
    assert len(lines) == 4
    assert lines[0].split() == ["arch", "shape", "mesh", "compute_s",
                                "memory_s", "collect_s", "bound", "useful",
                                "GB/dev", "fits", "J/dev"]
    assert set(lines[1]) == {"-"} and len(lines[1]) == len(lines[0])
    assert lines[2].split() == ["qwen3-4b", "train_4k", "single16x16",
                                "1.0000", "2.0000", "2.0000", "memory",
                                "0.50", "37.25", "yes",
                                f"{rows[0].energy_j:.2f}"]
    assert lines[3].split()[5] == "n/c"
    assert lines[3].split()[-1] == f"{rows[1].energy_j:.2f}"
