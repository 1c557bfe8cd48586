"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels have a plain C interface, so no PyTorch headers are compiled
and the build is short: one ``nvcc -c`` per source, all started together,
then one ``nvcc -shared`` links the objects into a library that ``ctypes``
loads. The library lands in ``build/repro_torch/`` at the root of the
checkout, named by a hash of every file under ``csrc/`` and of the compile
and link flags, at the first launch of any kernel (never at import: hosts
without ``nvcc`` import every module). Ranks spawned as processes build
at once: one of them compiles under an exclusive ``flock`` on
``build/repro_torch/.build.lock`` while the others wait on it, and the
library appears under its final name only by an atomic rename, so no
process ever loads a half-written one. The attention kernel's TMA tensor
maps are encoded through the entry point that the CUDA runtime hands out
(``cudaGetDriverEntryPoint``), so the library links no ``libcuda``.

Flags are fixed: ``-gencode arch=compute_90a,code=sm_90a -O3`` (``wgmma``
and ``setmaxnreg`` exist only for ``sm_90a``) and ``-Xptxas -v``, whose
report of each kernel's registers, shared memory and spills is kept beside
the library (:func:`ptxas_report`). Never ``--use_fast_math``: the int8
quantize kernels depend on IEEE division, and so does the attention
kernel's ``1 / (l + 1e-30)``; its bf16 body takes its exponentials as
``ex2.approx.ftz`` of log2-scaled logits, written out in the source, and
its fp32 body IEEE ``expf``. The reduction kernels flush subnormals
themselves, where the reference does, so no ``-ftz`` either.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "ckpt_kernels.cu", CSRC / "flash_attention.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: compile flags of every source
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of the link step
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_N = ctypes.c_int64
#: C entry point -> argtypes (pointers and the stream as void*, lengths i64)
SIGNATURES = {
    "ckpt_checksum_u32": (_P, _N, _P, _P),
    # x, n_words, seg_words, out
    "ckpt_checksum_u32_segments": (_P, _N, _N, _P, _P),
    "ckpt_xor_checksum_u32": (_P, _P, _P, _N, _P, _P),
    # a, b, out, n_words, seg_words, part
    "ckpt_xor_checksum_u32_segments": (_P, _P, _P, _N, _N, _P, _P),
    "ckpt_xor_fold_checksum_u32": (_P, _P, _P, _N, _P, _P),
    "ckpt_delta_xor": (_P, _P, _P, _N, _P),
    "ckpt_quantize_checksum_int8": (_P, _N, _P, _P, _P),
    "ckpt_dequantize_checksum_int8": (_P, _N, _P, _P, _P),
    # x, valid_bytes, row_start (host i64[n_segs + 1]), n_segs, out, dig /
    # in, row_start, n_segs, out, dig
    "ckpt_quantize_checksum_int8_segments": (_P, _N, _P, _N, _P, _P, _P),
    "ckpt_dequantize_checksum_int8_segments": (_P, _P, _N, _P, _P, _P),
    # x, n_rows, q, scales / q, scales, n_rows, out
    "ckpt_quantize_int8": (_P, _N, _P, _P, _P),
    "ckpt_dequantize_int8": (_P, _P, _N, _P, _P),
    "ckpt_downcast_bf16": (_P, _N, _P, _P),
    "ckpt_delta_f32": (_P, _P, _P, _N, _P),
    # q, k, v, out, m, l (the row stats, or both null); B, S, T, H, KV, hd,
    # is_bf16, kind, window, chunk, n_prefix
    "ckpt_flash_attention_fwd": (_P,) * 6 + (_N,) * 11 + (_P,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built on this host")


def library_path() -> Path:
    """Named by a hash of every file under ``csrc/`` (sources and headers)
    and of the compile and link flags."""
    h = hashlib.sha256()
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(src.relative_to(CSRC).as_posix().encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(LINK_FLAGS).encode())
    return BUILD_DIR / f"libckpt_kernels_{h.hexdigest()[:16]}.so"


def ptxas_report(lib: Path) -> Path:
    """Where :func:`build` keeps the compiler's ``-Xptxas -v`` report."""
    return lib.with_suffix(".ptxas.txt")


@contextlib.contextmanager
def build_lock(directory: Path) -> Iterator[None]:
    """An exclusive ``flock`` on ``directory/.build.lock``, held across
    processes; the kernel releases it if its holder dies."""
    directory.mkdir(parents=True, exist_ok=True)
    fd = os.open(directory / ".build.lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def build() -> Path:
    """Compile the sources unless the hashed library already exists. The
    compile runs under :func:`build_lock`, so of processes that build at
    once one compiles and the others find its library."""
    out = library_path()
    if out.exists():
        return out
    with build_lock(out.parent):
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    objs = [out.with_name(f"{out.stem}.{src.stem}.{tag}.o") for src in SOURCES]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    try:
        results = [(cmd, p.communicate()[0], p.returncode)
                   for cmd, p in zip(jobs, procs)]
        for cmd, text, rc in results:
            if rc != 0:
                raise KernelBuildError(
                    f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        tmp_report = out.with_suffix(f".{tag}.txt")
        tmp_report.write_text("".join(text for _c, text, _r in results))
        os.replace(tmp_report, ptxas_report(out))
        tmp = out.with_suffix(f".{tag}.so")
        _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


#: every kernel of this process, by its C symbol (each kernel module
#: registers its kernels when it is imported)
KERNELS: Dict[str, "CudaKernel"] = {}


def launch_counts() -> Dict[str, int]:
    """Each registered kernel's launches in this process, by symbol."""
    return {s: k.launches for s, k in KERNELS.items()}


def zero_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


class CudaKernel:
    """One kernel of the library, reached through its C entry point
    ``symbol`` (or another ``entry`` of the same kernel), with its launch
    count.

    ``launches`` rises by one per successful launch and nowhere else, so a
    run can show that its path went through the kernel."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self._count_lock = threading.Lock()
        KERNELS[symbol] = self

    def launch(self, *args, entry: Optional[str] = None) -> None:
        import torch

        symbol = entry or self.symbol
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(library(), symbol)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
        with self._count_lock:
            self.launches += 1
