"""The energy objective on the CPU: the port's roofline ``energy_j``
against JAX's with the reference's constants set in, the card's energy
meter (``repro_torch.analysis.energy``) refusing where it cannot read a
card, and the calibration's arithmetic on synthetic readings."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as JR  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro_torch.analysis import energy as E  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402


# ---------------------------------------------------------------------------
# Roofline parity
# ---------------------------------------------------------------------------
def reference_constants(monkeypatch):
    """The port's roofline on the reference's constants: one peak for
    every dtype, its HBM and link rates, budget and pJ figures."""
    peak = jhw.V5E_PEAK_FLOPS_BF16
    for name, value in (
            ("H100_PEAK_FLOPS", {"bf16": peak, "fp32": peak}),
            ("H100_HBM_BW", jhw.V5E_HBM_BW),
            ("H100_NVLINK_BW", jhw.ICI_LINK_BW),
            ("H100_HBM_BYTES", 16 * 1024**3),
            ("H100_PJ_PER_FLOP", {"bf16": jhw.TPU_PJ_PER_FLOP,
                                  "fp32": jhw.TPU_PJ_PER_FLOP}),
            ("H100_PJ_PER_HBM_BYTE", jhw.TPU_PJ_PER_HBM_BYTE),
            ("NVLINK_PJ_PER_BYTE_ESTIMATE", jhw.TPU_PJ_PER_ICI_BYTE)):
        monkeypatch.setattr(TR, name, value)


def random_record(seed: int, dtype: str) -> dict:
    rng = np.random.default_rng(seed)
    chips = int(rng.choice([1, 8, 256, 512]))
    return {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "multi",
            "num_devices": chips, "dtype": dtype,
            "cost": {"flops": float(rng.uniform(1e12, 1e16)),
                     "bytes accessed": float(rng.uniform(1e9, 1e13))},
            "collective_bytes": {"total": float(rng.uniform(0, 1e11))},
            "memory": {k: int(rng.integers(0, 2**34)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes")} | {"alias_size_in_bytes": 0},
            "model_flops": float(rng.uniform(1e12, 1e16)) * chips}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seed", range(4))
def test_roofline_on_reference_constants_equals_jax(seed, dtype,
                                                    monkeypatch):
    reference_constants(monkeypatch)
    rec = random_record(seed, dtype)
    got, want = TR.from_record(rec), JR.from_record(rec)
    for term in ("compute_s", "memory_s", "collective_s", "energy_j",
                 "bound_s", "useful_ratio", "bytes_per_device"):
        assert getattr(got, term) == pytest.approx(getattr(want, term),
                                                   rel=1e-12, abs=0), term
    assert (got.dominant, got.hbm_budget_ok) == \
        (want.dominant, want.hbm_budget_ok)


# ---------------------------------------------------------------------------
# The meter refuses
# ---------------------------------------------------------------------------
def test_meter_refuses_a_cpu_device():
    with pytest.raises(RuntimeError, match="reads a CUDA card"):
        E.EnergyMeter("cpu")
    with pytest.raises(RuntimeError, match="reads a CUDA card"):
        E.calibrate("cpu")


def test_meter_refuses_without_nvml(monkeypatch):
    def missing():
        raise OSError(f"{E.NVML_LIB}: cannot open shared object file")
    monkeypatch.setattr(E, "_load_nvml", missing)
    with pytest.raises(RuntimeError, match="cannot load NVML"):
        E.EnergyMeter("cuda:0")


class _FailingLib:
    """An NVML whose every call returns an error code."""

    class _Fn:
        def __init__(self, rc):
            self.rc, self.restype, self.argtypes = rc, None, None

        def __call__(self, *args):
            return self.rc

    def __init__(self):
        self.nvmlErrorString = self._Fn(b"Unknown Error")

    def __getattr__(self, name):
        fn = self._Fn(999)
        setattr(self, name, fn)
        return fn


def test_meter_raises_when_nvml_fails(monkeypatch):
    monkeypatch.setattr(E, "_load_nvml", _FailingLib)
    with pytest.raises(RuntimeError, match="NVML nvmlInit_v2 failed: "
                                           "Unknown Error"):
        E.EnergyMeter("cuda:0")


def test_a_counter_that_does_not_advance_raises():
    meter = object.__new__(E.EnergyMeter)
    meter.joules = lambda: 1234.5
    with pytest.raises(RuntimeError, match="did not advance"):
        meter.window(1234.5, 0.0, 1, 2.5)
    w = object.__new__(E.EnergyMeter)
    w.joules = lambda: 1300.0
    assert w.window(1234.5, 0.0, 3, 2.5) == E.Window(65.5, 2.5, 3)


def test_measure_repeats_until_the_window_lasts_min_seconds(monkeypatch):
    """``measure`` calls ``fn`` until ``MIN_SECONDS`` have passed on the
    host clock (0.7 s a call: three calls) and reads the counter around
    the whole window."""
    clock = iter([10.0, 10.7, 11.4, 12.1, 99.0])
    monkeypatch.setattr(E.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(E.torch.cuda, "synchronize", lambda device: None)
    meter = object.__new__(E.EnergyMeter)
    meter.device = torch.device("cuda", 0)
    readings = iter([500.0, 920.0])
    meter.joules = lambda: next(readings)
    calls = []
    w = meter.measure(lambda: calls.append(1))
    assert len(calls) == 3
    assert w == E.Window(420.0, pytest.approx(2.1), 3)


class _FakeNVML:
    """An NVML that succeeds: it records the bus id it is asked for,
    names the card and counts 123456 mJ."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            if name == "nvmlErrorString":
                return b""
            if name == "nvmlDeviceGetName":
                args[1].value = b"NVIDIA H100 80GB HBM3"
            if name == "nvmlDeviceGetTotalEnergyConsumption":
                args[1]._obj.value = 123456
            return 0
        setattr(self, name, fn)
        return fn


def test_meter_finds_the_card_by_its_pci_bus_id(monkeypatch):
    """The handle is looked up by the torch device's PCI bus id, so
    ``CUDA_VISIBLE_DEVICES`` cannot point the meter at another card."""
    class Props:
        pci_domain_id, pci_bus_id, pci_device_id = 0, 0x1A, 0

    nvml = _FakeNVML()
    monkeypatch.setattr(E, "_load_nvml", lambda: nvml)
    monkeypatch.setattr(E.torch.cuda, "get_device_properties",
                        lambda device: Props())
    monkeypatch.setattr(E.torch.cuda, "get_device_name",
                        lambda device: "NVIDIA H100 80GB HBM3")
    meter = E.EnergyMeter("cuda:1")
    assert meter.device == torch.device("cuda", 1)
    assert meter.name == "NVIDIA H100 80GB HBM3"
    assert [a[0] for n, a in nvml.calls
            if n == "nvmlDeviceGetHandleByPciBusId_v2"] == \
        [b"00000000:1a:00.0"]
    assert meter.joules() == 123.456


# ---------------------------------------------------------------------------
# The calibration's arithmetic
# ---------------------------------------------------------------------------
TRUE = {"idle_w": 140.0, "pj_per_flop_fp32": 10.5, "pj_per_flop_bf16": 0.8,
        "pj_per_hbm_byte": 130.0}
LOAD_OF = {"fp32": "pj_per_flop_fp32", "bf16": "pj_per_flop_bf16",
           "copy": "pj_per_hbm_byte"}
WORK = {"fp32": 2.0 * 8192**3, "bf16": 8 * 2.0 * 8192**3,
        "copy": 8 * 2.0 * 4 * 2**30}


def synthetic(load: str, seconds: float, calls: int, idle_w: float,
              const: float) -> E.Window:
    """The window a card with these constants would read."""
    marginal = 0.0 if load == "idle" \
        else const * 1e-12 * WORK[load] * calls
    return E.Window(idle_w * seconds + marginal, seconds, calls)


def test_calibration_recovers_the_constants():
    idle = [139.0, 140.0, 143.0]
    windows = {"idle": [E.Window(w * 2.04, 2.04, 40) for w in idle]}
    for load, name in LOAD_OF.items():
        windows[load] = [synthetic(load, s, c, TRUE["idle_w"], TRUE[name])
                         for s, c in ((2.01, 93), (2.02, 92), (2.0, 94))]
    got = E.calibration_constants(windows, WORK)
    assert got["idle_w"]["median"] == pytest.approx(140.0, rel=1e-12)
    assert got["idle_w"]["spread"] == pytest.approx(4.0 / 140.0, rel=1e-12)
    assert got["idle_w"]["values"] == pytest.approx(idle, rel=1e-12)
    for name in LOAD_OF.values():
        assert got[name]["median"] == pytest.approx(TRUE[name], rel=1e-9)
        assert got[name]["spread"] == pytest.approx(0.0, abs=1e-9)


def test_calibration_subtracts_the_median_idle_floor():
    """A load window read at a warmer floor (110 W) than the median idle
    window (100 W) shows the difference as marginal energy, over its
    work."""
    windows = {"idle": [E.Window(100.0 * 2, 2.0, 1)] * 3}
    for load in LOAD_OF:
        windows[load] = [synthetic(load, 2.0, 10, 110.0, 1.0)] * 3
    got = E.calibration_constants(windows, WORK)
    # 10 W x 2 s over 10 calls of the work, in pJ a unit
    for load, name in LOAD_OF.items():
        assert got[name]["median"] == pytest.approx(
            1.0 + 1e12 * 20.0 / (10 * WORK[load]), rel=1e-9)


@pytest.mark.parametrize("slip", [1e3, 1e-3])
def test_calibration_refuses_a_unit_slip(slip):
    """Joules read 1000x off (mJ as J, or the reverse) leave the
    plausible range and raise."""
    windows = {"idle": [E.Window(140.0 * 2 * slip, 2.0, 1)] * 3}
    for load, name in LOAD_OF.items():
        w = synthetic(load, 2.0, 50, 140.0, TRUE[name])
        windows[load] = [E.Window(w.joules * slip, 2.0, 50)] * 3
    with pytest.raises(ValueError, match="unit slip"):
        E.calibration_constants(windows, WORK)


def test_calibrate_measures_each_load_in_turns(monkeypatch):
    """``calibrate`` on a meter that records which load ran: three
    windows of each, in turns, their work counted from the loads'
    shapes, and the constants of the synthetic card recovered."""
    order = []
    names = ["idle", "fp32", "bf16", "copy"]

    class Fake:
        def __init__(self, device):
            self.device = torch.device("cpu")
            self.name = "fake"

        def measure(self, fn):
            load = names[len(order) % 4]
            order.append(load)
            fn()
            const = TRUE.get(LOAD_OF.get(load), 0.0)
            work = {"fp32": 2.0 * 256**3, "bf16": 8 * 2.0 * 256**3,
                    "copy": 8 * 2.0 * 2**20}
            marginal = 0.0 if load == "idle" else \
                const * 1e-12 * work[load] * 5
            return E.Window(TRUE["idle_w"] * 2.0 + marginal, 2.0, 5)

        def power_limit_w(self):
            return 700.0

    monkeypatch.setattr(E, "EnergyMeter", Fake)
    monkeypatch.setattr(E, "GEMM_N", 256)
    monkeypatch.setattr(E, "COPY_BYTES", 2**20)
    monkeypatch.setattr(E.time, "sleep", lambda s: None)
    out = E.calibrate("cuda")
    assert order == names * E.WINDOWS == names * 3
    assert out["work"] == {"fp32": 2.0 * 256**3, "bf16": 8 * 2.0 * 256**3,
                           "copy": 8 * 2.0 * 2**20}
    assert {k: len(v) for k, v in out["windows"].items()} == \
        dict.fromkeys(names, 3)
    for name, value in TRUE.items():
        assert out["constants"][name]["median"] == pytest.approx(
            value, rel=1e-9)
    assert (out["card"], out["power_limit_w"]) == ("fake", 700.0)
