"""PyTorch/CUDA port of the FedKBP+ federated-learning system.

A package beside the JAX reference (``repro``), with the same module
paths.  It imports neither JAX nor the reference.  Its entry points run
on CUDA unless the caller asks for the CPU.
"""


class NotPorted(NotImplementedError):
    """A seam of the reference that the port does not implement yet.

    Raised instead of running something else; ``seam`` names it."""

    def __init__(self, seam: str, got: str = "", supported: str = ""):
        self.seam = seam
        msg = f"seam {seam!r} is not ported to repro_torch yet"
        if got:
            msg += f": got {got}"
        if supported:
            msg += f" (ported: {supported})"
        super().__init__(msg)
