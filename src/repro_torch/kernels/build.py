"""Build and load the port's hand-written CUDA kernels, and count launches.

Every kernel lives in ``repro_torch/csrc/<name>.cu`` behind a plain C
interface.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``repro_torch/_build/`` (listed
in ``.gitignore``) and loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds.  The library's file name carries a hash of the
source and the flags, so an edited source is never served a stale build.

Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc`` or a card.

Wrappers dispatch by the device of the tensors they are given
(:func:`dispatch`): CPU tensors take the plain version, CUDA tensors the
kernel, and any other device raises.

``LAUNCHES`` counts, per kernel, how many times its wrapper launched it
on the card.  Wrappers call :func:`count_launch` right where they launch
and nowhere else, so a run can show that a path went through its kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], Callable] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _COUNT_LOCK:              # socket sites and server launch from threads
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source unless its library is already built;
    returns ``(process or None, temp path, final path)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources, one ``nvcc`` each, all started together.
    Raises with the compiler's output if any build fails.  Processes that
    build at once are safe: each compiles to a file of its own and renames
    it into place."""
    started = {n: _start_build(n) for n in names}
    errors = []
    for name, (proc, tmp, out) in started.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out for n, (_, _, out) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


def prepare(device, names: Iterable[str]) -> float:
    """Build and load ``names`` before a run's first timed round, so no
    round pays for them: the seconds it took (0.0 on the CPU, where no
    kernel runs)."""
    if torch.device(device).type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    names = list(names)
    build(names)
    for name in names:
        load(name)
    return time.perf_counter() - t0


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, with its
    argument types declared and an ``int`` (CUDA error) result."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def launch(name: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call one kernel's entry point (which launches on the stream passed
    in ``args``), raise if the launch was refused, and count it."""
    err = entry(name, symbol, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(name)


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer a kernel launches on."""
    return torch.cuda.current_stream().cuda_stream


def require_cuda(fn: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{fn}: tensors must be on CUDA, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: tensors must be contiguous")


def require_aligned(fn: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    that copy their inputs 16 bytes at a time)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn}: tensors must start on a 16-byte boundary")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd will ask for the gradient of a call on
    ``tensors``: grad mode on and one of them requires grad, or one of them
    inside a ``torch.func`` transform (vmap, grad)."""
    return ((torch.is_grad_enabled() and any(t.requires_grad for t in tensors))
            or any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors))


def refuse_backward(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`~repro_torch.NotPorted` (seam ``<kernel>_bwd``) where
    autograd would differentiate a call on ``tensors`` (:func:`needs_grad`).
    The CUDA wrapper of a kernel that has no backward kernel calls it: the
    kernel's output has no ``grad_fn``, so training through it would get
    zero gradients without a word.  On the CPU the plain version is
    differentiable PyTorch and its wrapper does not ask."""
    if needs_grad(*tensors):
        from repro_torch import NotPorted
        raise NotPorted(f"{kernel}_bwd", f"a gradient through the CUDA {kernel} kernel",
                        "training through its plain version on the CPU")


def dispatch(fn: str, device: torch.device, plain: Callable, kernel: Callable, *args):
    """``plain(*args)`` for a CPU tensor, ``kernel(*args)`` for a CUDA one."""
    if device.type == "cpu":
        return plain(*args)
    if device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"{fn}: no kernel for device {device}")
