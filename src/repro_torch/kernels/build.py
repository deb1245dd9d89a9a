"""Build, load and launch the hand-written CUDA kernels.

The sources live in ``repro_torch/csrc/*.cu`` with a plain ``extern "C"``
interface.  At first use they are compiled for Hopper (``sm_90a``) with
one ``nvcc`` per source, all started together, and linked into one
shared library under ``<repo>/build/kernels-<hash>/``; the hash covers
the sources and the flags, so an edited source rebuilds and an unchanged
one is loaded as it is.  ``-Xptxas -v`` output (registers, spills) is
kept beside the library (:func:`ptxas_report`).

Binding is ``ctypes``: pointers and the stream go in as ``c_void_p``;
every C entry point returns ``cudaGetLastError()`` after its launch and
:class:`Kernel` raises if it is not 0.  Nothing here runs at import, and
nothing is built for CPU tensors: the kernel wrappers run their plain
torch versions for those.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "libsecurestreams_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LIB_DIR: Optional[Path] = None
#: seconds the last build took in this process (None: loaded a cached one)
build_seconds: Optional[float] = None


class BuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin) — the CUDA "
                     "kernels are built from repro_torch/csrc at first use")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out.parent / f".{out.name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for src in _sources():              # one nvcc per source, in parallel
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    (tmp / "ptxas.log").write_text(log)
    if failed:
        raise BuildError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp / LIB_NAME), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise BuildError(f"link failed:\n{link.stdout}{link.stderr}")
    try:
        tmp.rename(out)                 # atomic publish
    except OSError:                     # a concurrent build won the race
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc`` on first use."""
    global _LIB, _LIB_DIR
    if _LIB is None:
        out = BUILD_ROOT / f"kernels-{_digest()}"
        if not (out / LIB_NAME).exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            _build(out)
        try:
            lib = ctypes.CDLL(str(out / LIB_NAME))
        except OSError as e:
            raise BuildError(f"cannot load {out / LIB_NAME}: {e}") from e
        lib.ss_error_string.argtypes = [ctypes.c_int]
        lib.ss_error_string.restype = ctypes.c_char_p
        _LIB, _LIB_DIR = lib, out
    return _LIB


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the build that :func:`library` loaded."""
    library()
    return (_LIB_DIR / "ptxas.log").read_text()


def ptxas_kernels(report: str) -> List[Dict]:
    """Per entry function: name, registers, spill stores/loads (bytes)."""
    out: List[Dict] = []
    cur: Optional[Dict] = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            cur = {"name": line.split("'")[1], "registers": None,
                   "spill_stores": None, "spill_loads": None, "lines": []}
            out.append(cur)
        elif cur is not None and ("spill stores" in line
                                  or "Used " in line):
            cur["lines"].append(line.strip())
            if "spill stores" in line:
                parts = [p.strip() for p in line.split(",")]
                cur["spill_stores"] = int(parts[1].split()[0])
                cur["spill_loads"] = int(parts[2].split()[0])
            else:
                cur["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def sass_report() -> str:
    """``cuobjdump -sass`` of the library that :func:`library` loaded."""
    library()
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(_LIB_DIR / LIB_NAME)],
                          capture_output=True, text=True, check=True).stdout


#: SASS opcodes by the SM pipe that executes them on Hopper; an opcode not
#: listed here is an integer/logic op of the ALU pipe (INT32 lanes)
_FMA_PIPE = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2",
             "HADD2", "DFMA", "DMUL", "DADD")
_MEM = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LD", "ST", "LDC",
        "ATOM", "ATOMS", "ATOMG", "RED", "LDSM")
_CONTROL = ("EXIT", "BRA", "BSSY", "BSYNC", "BAR", "RET", "CALL", "S2R",
            "S2UR", "CS2R", "WARPSYNC", "YIELD", "DEPBAR", "MEMBAR", "BMOV",
            "NANOSLEEP", "ERRBAR", "CCTL")


def sass_mix(report: str) -> List[Dict]:
    """Per kernel function of a ``cuobjdump -sass`` listing: the static
    count of its instructions (NOP padding left out) by pipe — ``alu``
    (integer and logic ops on the INT32 lanes), ``fma`` (``IMAD`` and the
    float multiply-adds on the FP32 lanes), ``uniform`` (the per-warp
    ``U*`` datapath), ``mem`` and ``control`` — its opcode histogram, and
    whether it branches backwards (then its dynamic count is not its
    static count)."""
    out: List[Dict] = []
    cur: Optional[Dict] = None
    labels: Dict[str, int] = {}
    branches: List = []
    pending: List[str] = []

    def close():
        if cur is not None:
            cur["loops"] = any(labels.get(t, at + 1) < at or
                               (t.startswith("0x") and int(t, 16) < at)
                               for at, t in branches)

    for line in report.splitlines():
        text = line.strip()
        if "Function :" in text:
            close()
            cur = {"name": text.split("Function :")[1].strip(),
                   "alu": 0, "fma": 0, "uniform": 0, "mem": 0,
                   "control": 0, "ops": {}, "loops": False}
            labels, branches, pending = {}, [], []
            out.append(cur)
            continue
        if cur is None:
            continue
        if text.endswith(":") and text.startswith("."):
            pending.append(text[:-1])
            continue
        if not text.startswith("/*") or ";" not in text:
            continue
        head, _, body = text[2:].partition("*/")
        try:
            at = int(head, 16)
        except ValueError:
            continue
        for lab in pending:
            labels[lab] = at
        pending = []
        toks = body.split(";")[0].split()
        if toks and toks[0].startswith("@"):
            toks = toks[1:]
        if not toks or toks[0] == "NOP":
            continue
        op = toks[0].split(".")[0]
        cur["ops"][toks[0]] = cur["ops"].get(toks[0], 0) + 1
        if op == "BRA":
            branches.append((at, toks[-1].strip("`()")))
        if op in _FMA_PIPE:
            cur["fma"] += 1
        elif op in _MEM:
            cur["mem"] += 1
        elif op in _CONTROL:
            cur["control"] += 1
        elif op.startswith("U"):
            cur["uniform"] += 1
        else:
            cur["alu"] += 1
    close()
    return out


#: every Kernel ever constructed, by name (launch accounting)
KERNELS: Dict[str, "Kernel"] = {}


class Kernel:
    """One ``extern "C"`` launcher of the library plus its launch count.

    ``launches`` goes up by one each time the kernel is launched, and
    nowhere else: a run can show that it went through the kernel."""

    def __init__(self, symbol: str, argtypes: List):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().ss_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"cudaError {err} ({msg})")
        self.launches += 1


def launch_counts() -> Dict[str, int]:
    """{kernel symbol: launches since the last reset}."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
U32 = ctypes.c_uint32


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_words(what: str, t, shapes, device, *, align16: bool = False
                ) -> None:
    """Validate one kernel operand: int32-carried words, one of the
    accepted ``shapes`` (ints or None for any extent), on ``device``,
    contiguous, and 16-byte aligned where the kernel loads ``uint4``."""
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32-carried u32 words, "
                         f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    ok = any(len(s) == t.dim() and all(e is None or e == d
                                       for e, d in zip(s, t.shape))
             for s in shapes)
    if not ok:
        raise ValueError(f"{what}: shape {tuple(t.shape)} not one of "
                         f"{shapes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")


def require_cuda(t) -> None:
    """Wrappers run the plain version for CPU tensors only; anything
    else that is not a CUDA tensor is refused, never moved."""
    if t.device.type != "cuda":
        raise ValueError(f"kernels take CUDA tensors (or CPU tensors for "
                         f"the plain versions), got {t.device}")
