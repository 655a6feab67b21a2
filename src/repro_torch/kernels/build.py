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
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

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


def fold(info, in_dims: Sequence[Optional[int]], tensors):
    """For a ``torch.autograd.Function``'s ``vmap`` rule: the tensors of a
    vmapped call with the mapped dimension moved to the front (broadcast
    where unmapped) and folded into the batch dimension B."""
    n = info.batch_size
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(n * t.shape[1], *t.shape[2:]).contiguous())
    return out


def unfold(info, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`fold` for one output: B split back into the
    mapped dimension (in front) and the batch."""
    return t.reshape(info.batch_size, t.shape[0] // info.batch_size, *t.shape[1:])


def vmap_shared(fn: Callable, info, in_dims: Sequence[Optional[int]], args, shared: int,
                name: str):
    """A ``vmap`` rule for a Function whose ``args[shared]`` is a parameter
    every batch row shares (the scans' u and log_a): every other tensor is
    folded into B and ``fn`` called once.  A mapped shared parameter (a
    model an example) raises :class:`~repro_torch.NotPorted`: per-example
    DP-SGD, the port's only vmap, maps the batch and not the parameters.
    Returns (outputs, out_dims)."""
    if in_dims[shared] is not None:
        from repro_torch import NotPorted
        raise NotPorted(name, "a vmap over the shared parameter",
                        "a vmap over the batch, the parameter shared")
    rest = [i for i in range(len(args)) if i != shared]
    folded = list(args)
    for i, t in zip(rest, fold(info, [in_dims[i] for i in rest], [args[i] for i in rest])):
        folded[i] = t
    outs = tuple(unfold(info, t) for t in fn(*folded))
    return outs, (0,) * len(outs)


def scan_functions(cls_name: str, name: str, fwd: Callable, bwd: Callable, shared: int):
    """The two ``torch.autograd.Function``s that carry a scan kernel and
    its backward kernel (the WKV-6 and selective scans).

    ``cls_name`` is the forward Function's (the backward's adds
    ``Backward``) and ``name`` the kernel's.  ``fwd(*inputs)`` returns
    ``(out, state, ckpt)``: the output, the final state and the states the
    backward starts its stages from (not differentiable).  ``bwd(*inputs, ckpt, dout, dstate)`` returns the
    inputs' gradients with that of ``inputs[shared]``, a parameter every
    batch row shares, per batch row; the forward Function sums the rows,
    so that a vmapped call (per-example DP-SGD) gives each example its
    own.  Both carry a ``vmap`` rule (:func:`vmap_shared`); the backward
    has no derivative of its own, and as a Function a vmapped backward
    folds into one launch."""

    def fwd_setup_context(ctx, inputs, output):
        ckpt = output[2]
        ctx.mark_non_differentiable(ckpt)
        ctx.save_for_backward(*inputs, ckpt)

    def fwd_backward(ctx, dout, dstate, _dckpt):
        saved = ctx.saved_tensors
        grads = list(backward_fn.apply(*saved, dout, dstate))
        grads[shared] = grads[shared].sum(0).to(saved[shared].dtype)
        return tuple(grads)

    def bwd_backward(ctx, *grads):
        raise NotImplementedError(f"{name}: no second derivative")

    def fwd_vmap(info, in_dims, *inputs):
        return vmap_shared(forward_fn.apply, info, in_dims, inputs, shared, name)

    def bwd_vmap(info, in_dims, *args):
        return vmap_shared(backward_fn.apply, info, in_dims, args, shared, name)

    backward_fn = type(f"{cls_name}Backward", (torch.autograd.Function,), {
        "__doc__": f"The backward kernel of {name} as a Function.",
        "forward": staticmethod(bwd),
        "setup_context": staticmethod(lambda ctx, inputs, output: None),
        "backward": staticmethod(bwd_backward),
        "vmap": staticmethod(bwd_vmap)})
    forward_fn = type(cls_name, (torch.autograd.Function,), {
        "__doc__": f"(out, state, ckpt) of {name}; out's and state's gradients "
                   f"come from its backward kernel.",
        "forward": staticmethod(fwd),
        "setup_context": staticmethod(fwd_setup_context),
        "backward": staticmethod(fwd_backward),
        "vmap": staticmethod(fwd_vmap)})
    return forward_fn, backward_fn


def dispatch(fn: str, device: torch.device, plain: Callable, kernel: Callable, *args):
    """``plain(*args)`` for a CPU tensor, ``kernel(*args)`` for a CUDA one."""
    if device.type == "cpu":
        return plain(*args)
    if device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"{fn}: no kernel for device {device}")
