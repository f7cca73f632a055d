"""The card's total-energy counter (NVML, through ``ctypes``).

NVML counts the millijoules the card has taken since its driver loaded.
The card is found by the PCI bus id of the torch device, so a reordering
of ``CUDA_VISIBLE_DEVICES`` cannot make it read another card.  There is
no fallback: without NVML, or when a call fails, the meter raises."""
from __future__ import annotations

import ctypes

import torch

NVML_LIB = "libnvidia-ml.so.1"


class Meter:
    def __init__(self, device: torch.device):
        self._lib = lib = ctypes.CDLL(NVML_LIB)
        lib.nvmlErrorString.restype = ctypes.c_char_p
        for name, args in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        self._call("nvmlInit_v2")
        props = torch.cuda.get_device_properties(device)
        bus = (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
               f"{props.pci_device_id:02x}.0")
        self._handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByPciBusId_v2", bus.encode(),
                   ctypes.byref(self._handle))

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"NVML {name} failed: "
                               f"{self._lib.nvmlErrorString(rc).decode()}")

    def joules(self) -> float:
        mj = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self._handle,
                   ctypes.byref(mj))
        return mj.value / 1e3
