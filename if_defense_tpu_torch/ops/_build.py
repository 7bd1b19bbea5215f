"""Build and load the port's CUDA kernels (`csrc/*.cu`).

On first use each `csrc/*.cu` is compiled by its own `nvcc` process, all
started together, into a shared library with a plain C interface, and the
libraries are loaded with `ctypes`. The build lands in
`if_defense_tpu_torch/_build/<hash>/`, keyed on a hash of every file under
`csrc/` and the flags, so a changed source rebuilds and an unchanged one
loads in milliseconds. `torch.utils.cpp_extension.load` would include
PyTorch's headers and take minutes per build instead of seconds.

Needs the CUDA toolkit (`nvcc` on PATH, or under `$CUDA_HOME` or
`/usr/local/cuda`) and a Hopper card: the code is built for `sm_90a` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}
_count_lock = threading.Lock()
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in sources:
        log = open(out_dir / f"{src.stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(out_dir / f"lib{src.stem}.so"), str(src)]
        procs.append((src, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def libraries() -> dict[str, ctypes.CDLL]:
    """{source stem: loaded library}, building first where needed. Safe
    under threads: the first caller builds and loads every library under
    a lock, and the dict is published only when it is whole."""
    global _libs
    if _libs:
        return _libs
    with _load_lock:
        if not _libs:
            _libs = _load()
    return _libs


def _load() -> dict[str, ctypes.CDLL]:
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD / _digest()
    t0 = time.perf_counter()
    cached = (out / "done").exists()
    if not cached:
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(dir=BUILD, prefix="tmp-"))
        try:
            _compile(sources, tmp)
            (tmp / "done").write_text("ok\n")
            try:
                os.replace(tmp, out)
            except OSError:          # another process finished first
                if not (out / "done").exists():
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    libs = {src.stem: ctypes.CDLL(str(out / f"lib{src.stem}.so"))
            for src in sources}
    build_info.update(
        dir=str(out), cached=cached,
        seconds=time.perf_counter() - t0,
        logs={s.stem: (out / f"{s.stem}.log").read_text() for s in sources})
    return libs


def bind(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """One C function of a kernel library, with its argument types set
    (every pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(libraries()[lib], name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib: str, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err:
        text = libraries()[lib].ifdef_error_string
        text.argtypes = [ctypes.c_int]
        text.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({text(err).decode()})")


def launch(lib: str, what: str, fn, args, t: torch.Tensor, launches: dict,
           key: str) -> None:
    """Call a kernel's C entry point `fn(*args, stream)` on the card that
    holds `t`, count the launch in `launches[key]` and raise on a CUDA
    error. The C side launches, and sets its kernels' shared-memory limits,
    on the thread's current device: `torch.cuda.device` makes that `t`'s
    card, and the stream is that card's current stream. The count is taken
    under a lock, so it stays exact when threads launch at once. `fn`'s
    argument types, where set (`bind` sets them), must name the stream as
    well: ctypes would pass an argument past them as a 32-bit C int and
    cut the stream's handle."""
    argtypes = getattr(fn, "argtypes", None)
    if argtypes is not None and len(argtypes) != len(args) + 1:
        raise TypeError(f"{what}: {len(argtypes)} argument types for "
                        f"{len(args)} arguments and the stream")
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    with _count_lock:
        launches[key] += 1
    check(lib, err, what)
