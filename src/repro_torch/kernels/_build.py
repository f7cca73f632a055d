"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source in ``repro_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries land in ``kernels/_build/`` (git-ignored) under a
name keyed by the hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads as it is.  ``build_all`` starts one
``nvcc`` per source at once; ``library(name)`` builds on first use.

Nothing here runs at import: the CPU tests import every module."""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("conv2d", "quant", "flash_attention", "rwkv6_wkv", "mamba2_ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def tool_path(tool: str = "nvcc") -> str:
    """A CUDA toolkit program (nvcc, cuobjdump), on PATH or under
    CUDA_HOME."""
    found = shutil.which(tool)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / tool
    if not path.exists():
        raise RuntimeError(
            f"{tool} not found on PATH or under CUDA_HOME: the CUDA kernels "
            f"build only where the CUDA toolkit is installed")
    return str(path)


def nvcc_path() -> str:
    return tool_path("nvcc")


def includes(path: Path) -> list[Path]:
    """The ``#include "..."`` files of a source under ``csrc/``, and
    theirs, each once, in order of first inclusion."""
    found: list[Path] = []
    todo = [path]
    while todo:
        text = todo.pop(0).read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            dep = (CSRC / inc).resolve()
            if dep not in found:
                found.append(dep)
                todo.append(dep)
    return found


def _target(name: str) -> Path:
    """The library's path, named by the hash of the source, every header
    it includes and the flags: editing any of them rebuilds."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in includes(src):
        h.update(dep.name.encode() + b"\0" + dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc`` runs
    at once.  Returns each build's compiler output (``-Xptxas -v``
    register and shared-memory report), kept beside the library so a
    library built earlier returns its own; raises on a failed build."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        logs = {}
        errors = []
        for name, job in jobs.items():
            if job is None:
                kept = _target(name).with_suffix(".log")
                logs[name] = kept.read_text() if kept.exists() else "cached"
                continue
            proc, tmp, out = job
            text, _ = proc.communicate()
            logs[name] = text
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{text}")
                continue
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def kernel_label(mangled: str) -> str:
    """``conv2d_dense_kernel<fp32,64>`` for a mangled kernel name of this
    package: its name, in or out of a (length-prefixed) namespace, then
    the dtype and the integer template arguments; else the name as it
    is."""
    m = re.match(r"_ZN?(\d+)", mangled)
    if not m:
        return mangled
    pos, names = m.start(1), []
    while True:
        n = re.match(r"\d+", mangled[pos:])
        if not n:
            break
        start = pos + len(n.group())
        names.append(mangled[start:start + int(n.group())])
        pos = start + int(n.group())
    name = names[-1]
    args = re.match(r"I(f|13__nv_bfloat16)((?:Li\d+E)*)", mangled[pos:])
    if not args:
        return name
    return "{}<{}>".format(name, ",".join(
        ["fp32" if args.group(1) == "f" else "bf16",
         *re.findall(r"Li(\d+)E", args.group(2))]))


def ptxas_report(log: str) -> dict[str, dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: registers, stack frame
    and spill bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def sass_report(lib: Path) -> dict[str, dict]:
    """Per kernel of a built library (``cuobjdump -sass``): its SASS
    instructions and how many are tensor-core products, ``HGMMA``
    (wgmma) and ``HMMA`` (mma.sync)."""
    text = subprocess.run([tool_path("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)),
                                 dict(instructions=0, hgmma=0, hmma=0))
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            cur["instructions"] += 1
            cur["hgmma"] += "HGMMA" in line
            cur["hmma"] += bool(re.search(r"\bHMMA\b", line))
    return out


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with
    ``signatures`` (``{function: (argtypes, restype)}``) declared on its
    entry points when it is first loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)))
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = lib.kernels_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
# the storage dtypes every kernel takes, as the C entry points' dtype code
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(name: str, tensors: dict, dtypes=tuple(DTYPE_CODE)) -> None:
    """One dtype among ``dtypes``, one device, contiguous: what the
    sequence kernels read."""
    first = next(iter(tensors.values()))
    for n, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {n} must be a tensor")
        if t.dtype not in dtypes or t.dtype != first.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}; the inputs must "
                            f"share one dtype of {dtypes}")
        if t.device != first.device:
            raise ValueError(f"{name}: {n} on {t.device}, others on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")


def check_aligned(name: str, tensors: dict, align: int) -> None:
    """Raise ``ValueError`` where a tensor's first element is not
    ``align``-byte aligned: the kernels' vector copies assume it (a view
    with a storage offset can break it), and take no other path."""
    for n, t in tensors.items():
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {n} starts at an address that is not "
                             f"{align}-byte aligned (a view with an offset?"
                             f"); the kernel's {align}-byte copies need it")


def ptr(t) -> VOIDP:
    return VOIDP(t.data_ptr())


def stream_of(t) -> VOIDP:
    return VOIDP(torch.cuda.current_stream(t.device).cuda_stream)
