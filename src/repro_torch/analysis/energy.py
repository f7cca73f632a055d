"""The card's energy meter and the calibration of the H100's energy
constants (``core/hardware.py``: ``H100_PJ_PER_FLOP``,
``H100_PJ_PER_HBM_BYTE``, ``H100_IDLE_W``).

The meter reads NVML's total-energy counter (mJ since the driver loaded)
through ``ctypes`` on ``libnvidia-ml.so.1``, on the NVML device whose PCI
bus id is the torch device's: ``CUDA_VISIBLE_DEVICES`` can make NVML's
index 0 another card than ``cuda:0``.  The counter updates slowly, so a
window lasts at least ``MIN_SECONDS``.  There is no fallback: on a
CPU device, without the library, or when a call fails, the meter raises.

``calibrate`` takes ``WINDOWS`` windows of four loads in turns -- the
idle floor (a context up, no work), an fp32 GEMM under
``device.strict_fp32`` (the CUDA cores), a bf16 GEMM (the tensor cores)
and a device-to-device copy -- and ``calibration_constants`` turns them
into marginal energies above the idle floor: ``(E - P_idle * t) /
work``.  ``torch.matmul`` and ``copy_`` are only loads to measure here."""
from __future__ import annotations

import ctypes
import dataclasses
import statistics
import time

import torch

NVML_LIB = "libnvidia-ml.so.1"
MIN_SECONDS = 2.0
WINDOWS = 3
GEMM_N = 8192
COPY_BYTES = 4 * 2**30
# A constant outside its range is a unit slip (mJ read as J, a missed
# 1e12), not a finding: the calibration raises.  Wide on purpose.
PLAUSIBLE = {"idle_w": (10.0, 400.0), "pj_per_flop_fp32": (0.3, 100.0),
             "pj_per_flop_bf16": (0.01, 20.0),
             "pj_per_hbm_byte": (1.0, 1000.0)}


def _load_nvml():
    return ctypes.CDLL(NVML_LIB)


def idle() -> None:
    """The idle load: a context up and no work."""
    time.sleep(0.05)


@dataclasses.dataclass(frozen=True)
class Window:
    """One reading: joules the card took over ``seconds`` of wall time,
    in which ``fn`` ran ``calls`` times (each call synchronised)."""

    joules: float
    seconds: float
    calls: int

    @property
    def watts(self) -> float:
        return self.joules / self.seconds

    def above(self, idle_w: float) -> float:
        """Joules above the idle floor."""
        return self.joules - idle_w * self.seconds


class EnergyMeter:
    """NVML's energy counter of the card behind a CUDA torch device."""

    def __init__(self, device: str | torch.device = "cuda"):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise RuntimeError(f"the energy meter reads a CUDA card, not "
                               f"{str(dev)!r}")
        self.device = torch.device("cuda", dev.index if dev.index is not None
                                   else torch.cuda.current_device())
        try:
            lib = _load_nvml()
        except OSError as e:
            raise RuntimeError(f"cannot load NVML ({NVML_LIB}): {e}") from e
        self._lib = lib
        lib.nvmlErrorString.restype = ctypes.c_char_p
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        for name, args in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetName",
                 [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        self._call("nvmlInit_v2")
        self._handle = self._find_handle()
        name = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetName", self._handle, name, 96)
        self.name = name.value.decode()
        if self.name != torch.cuda.get_device_name(self.device):
            raise RuntimeError(
                f"NVML's card {self.name!r} is not torch's "
                f"{torch.cuda.get_device_name(self.device)!r}")

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"NVML {name} failed: "
                               f"{self._lib.nvmlErrorString(rc).decode()}")

    def _find_handle(self) -> ctypes.c_void_p:
        props = torch.cuda.get_device_properties(self.device)
        handle = ctypes.c_void_p()
        bus = (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
        self._call("nvmlDeviceGetHandleByPciBusId_v2", bus.encode(),
                   ctypes.byref(handle))
        return handle

    def joules(self) -> float:
        """The counter now, in joules."""
        mj = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self._handle,
                   ctypes.byref(mj))
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", self._handle,
                   ctypes.byref(mw))
        return mw.value / 1e3

    def measure(self, fn) -> Window:
        """Run ``fn`` (synchronised after each call) until the window
        lasts ``MIN_SECONDS``; the joules and seconds of the window."""
        torch.cuda.synchronize(self.device)
        e0, t0 = self.joules(), time.perf_counter()
        calls = 0
        while True:
            fn()
            calls += 1
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            if t1 - t0 >= MIN_SECONDS:
                break
        return self.window(e0, t0, calls, t1)

    def window(self, e0: float, t0: float, calls: int,
               t1: float) -> Window:
        """The window from a reading (``e0`` J at ``t0``) to a loop's end
        at ``t1``, synchronised; the counter must have advanced."""
        e1 = self.joules()
        if e1 <= e0:
            raise RuntimeError(f"the energy counter did not advance over "
                               f"{t1 - t0:.3f} s ({e0} -> {e1} J)")
        return Window(e1 - e0, t1 - t0, calls)


def summary(values: list[float]) -> dict:
    med = statistics.median(values)
    spread = (max(values) - min(values)) / med if med else float("inf")
    return dict(median=med, min=min(values), max=max(values),
                spread=spread, values=values)


def calibration_constants(windows: dict[str, list[Window]],
                          work: dict[str, float]) -> dict:
    """The energy constants from calibration windows: ``idle_w`` (W) is
    the median idle window's mean power; each other constant is a
    window's joules above that floor over its work, in pJ a unit
    (``work[k]``: FLOPs or bytes moved a call of load ``k``).  Each
    constant is summarised over its windows (median, min, max, spread =
    (max - min) / median); one outside ``PLAUSIBLE`` raises."""
    idle = [w.watts for w in windows["idle"]]
    idle_w = statistics.median(idle)
    out = {"idle_w": summary(idle)}
    for load, name in (("fp32", "pj_per_flop_fp32"),
                       ("bf16", "pj_per_flop_bf16"),
                       ("copy", "pj_per_hbm_byte")):
        out[name] = summary([1e12 * w.above(idle_w) / (work[load] * w.calls)
                             for w in windows[load]])
    for name, (lo, hi) in PLAUSIBLE.items():
        med = out[name]["median"]
        if not lo <= med <= hi:
            raise ValueError(f"calibrated {name} = {med:.4g} lies outside "
                             f"[{lo}, {hi}]: a unit slip")
    return out


def calibrate(device: str | torch.device = "cuda") -> dict:
    """``WINDOWS`` windows of each load, in turns (idle, fp32 GEMM, bf16
    GEMM, copy): an fp32 and a bf16 ``GEMM_N``-cubed matmul, and a copy
    of ``COPY_BYTES`` (2 bytes moved a byte copied).  Returns the
    constants (``calibration_constants``), the windows, the card's name
    and its enforced power limit."""
    from repro_torch.device import strict_fp32

    meter = EnergyMeter(device)
    dev = meter.device
    strict_fp32()
    gen = torch.Generator(device=dev).manual_seed(0)
    n = GEMM_N
    mats = {}
    for load, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        a = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        b = torch.randn(n, n, generator=gen, device=dev).to(dtype)
        mats[load] = (a, b, torch.empty(n, n, device=dev, dtype=dtype))
    src = torch.empty(COPY_BYTES // 4, device=dev, dtype=torch.float32)
    src.normal_(generator=gen)
    dst = torch.empty_like(src)
    reps = {"fp32": 1, "bf16": 8, "copy": 8}

    def gemm(load):
        a, b, c = mats[load]

        def run():
            for _ in range(reps[load]):
                torch.matmul(a, b, out=c)
        return run

    def copy():
        for _ in range(reps["copy"]):
            dst.copy_(src)

    loads = {"idle": idle, "fp32": gemm("fp32"),
             "bf16": gemm("bf16"), "copy": copy}
    work = {"fp32": reps["fp32"] * 2.0 * n ** 3,
            "bf16": reps["bf16"] * 2.0 * n ** 3,
            "copy": reps["copy"] * 2.0 * src.numel() * src.element_size()}
    for load in ("fp32", "bf16", "copy"):     # cuBLAS handles, first clocks
        loads[load]()
    taken = {k: [] for k in loads}
    for _ in range(WINDOWS):
        for load, fn in loads.items():
            taken[load].append(meter.measure(fn))
    del mats, src, dst
    torch.cuda.empty_cache()
    return dict(constants=calibration_constants(taken, work),
                windows={k: [dataclasses.asdict(w) for w in v]
                         for k, v in taken.items()},
                work=work, card=meter.name,
                power_limit_w=meter.power_limit_w())
