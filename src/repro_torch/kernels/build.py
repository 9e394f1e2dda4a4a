"""Build the port's CUDA sources at first use and bind them with ctypes.

Each library is one ``csrc/*.cu`` source compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes); ``wavefront.cu`` gives
three, its hard-min half, the same under ``-DREPRO_BF16`` (bf16-K1) and,
under ``-DREPRO_SOFT``, its soft-min half; ``family_wavefront.cu`` (K7)
gives two, hard-min and ``-DREPRO_SOFT``, from one kernel template;
both sources include ``csrc/ring.cuh``, and ``csrc/softmin.cuh`` serves
the soft builds.  Every
library is compiled by its own ``nvcc``
process, all started together.  Libraries go to ``build/repro_torch/``
at the repository root, named by a hash of the source, the headers, the
flags and ``nvcc --version``, so neither an edited source nor another
compiler is ever served by a stale library; ptxas's report (registers and
spills, ``-Xptxas -v``) is kept beside each as ``.ptxas``.  A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v", "-lineinfo"]
# library name -> (source, extra flags).  -fmad=false: the hard-min
# wavefronts (K1/K3/K4, bf16-K1, K7) must round (q - r) * (q - r) +
# min(...) exactly as the plain version does (no fused multiply-add); the
# soft-min sweeps are held to a tolerance and keep the default
# contraction.
TARGETS = {"wavefront": ("wavefront.cu", ["-fmad=false"]),
           "wavefront_bf16": ("wavefront.cu",
                              ["-fmad=false", "-DREPRO_BF16"]),
           "soft_wavefront": ("wavefront.cu", ["-DREPRO_SOFT"]),
           "family_wavefront": ("family_wavefront.cu", ["-fmad=false"]),
           "soft_family_wavefront": ("family_wavefront.cu",
                                     ["-DREPRO_SOFT"]),
           "normalizer": ("normalizer.cu", [])}

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts a wrapper's kernel launches (one per launch, nowhere else),
    so a run can show that its path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_variant: dict[str, int] = {}

    def add(self, variant: str | None = None) -> None:
        self.count += 1
        if variant is not None:
            self.by_variant[variant] = self.by_variant.get(variant, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_variant = {}


def on_card(x) -> bool:
    """A wrapper's dispatch rule: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (take the plain version)."""
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return kind == "cuda"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built at first use")
    return found


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout


def _target(name: str, extra: tuple = ()) -> tuple[Path, Path, list[str]]:
    source, flags0 = TARGETS[name]
    src = CSRC / source
    flags = ARCH + COMMON + flags0 + list(extra)
    # the headers a source may include (csrc/*.cuh) are hashed too
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()
                            + _nvcc_version().encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so", src, flags


def _report(out: Path) -> Path:
    return out.with_suffix(".ptxas")


def _compile(jobs: dict) -> dict[str, str]:
    """Compile every job (key -> (out, src, flags)) whose library or
    ptxas report does not exist yet, one ``nvcc`` each, all in parallel.
    Returns key -> ptxas report of every job, built now or before;
    raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for key, (out, src, flags) in jobs.items():
        if out.exists() and _report(out).exists():
            logs[key] = _report(out).read_text()
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for key, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[key] = text
        if proc.returncode != 0:
            failed.append(f"--- {key} (nvcc exit {proc.returncode})\n"
                          f"{text}")
            continue
        tmp.with_suffix(".ptxas").write_text(text)
        os.replace(tmp.with_suffix(".ptxas"), _report(out))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def build_all() -> dict[str, str]:
    """Compile every library of :data:`TARGETS` that has no current
    build, one ``nvcc`` each, all in parallel.  Returns name -> ptxas
    report of every library.  Raises with nvcc's output if any build
    fails."""
    return _compile({name: _target(name) for name in TARGETS})


def library(name: str, extra: tuple = ()) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`TARGETS`), built on
    first use; ``extra``: more nvcc flags, for a variant built to be
    measured beside it."""
    with _lock:
        key = (name, tuple(extra))
        lib = _libs.get(key)
        if lib is None:
            out, src, flags = _target(name, tuple(extra))
            if not (out.exists() and _report(out).exists()):
                if extra:
                    _compile({name: (out, src, flags)})
                else:
                    build_all()
            lib = _libs[key] = ctypes.CDLL(str(out))
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C entry point (each
    library exports ``error_string``, CUDA's text for the code)."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        text = lib.error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
