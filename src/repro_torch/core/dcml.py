"""Regional Deep Contrastive Mutual Learning (paper Eq. 3, GCML's core),
ported from ``repro/core/dcml.py``.

The contrastive KL divergence D_CKL aligns two models' predictive
distributions where a *reference* model classifies correctly and pushes
them apart where it is wrong:

    D_CKL(P_a || P_b) = mean_{region ok} KL(P_b || P_a)
                      - beta * mean_{region wrong} KL(P_b || P_a)

where the region masks come from the reference model's argmax against
the label, and P_b (the target) is gradient-stopped: model ``a`` learns
from ``b`` without ``b`` being dragged through ``a``'s loss.  "Region"
is a voxel of SA-Net's output.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.tree import tree_map


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(q || p) per position (the target q is the teacher; fp32)."""
    p = torch.log_softmax(p_logits.float(), dim=-1)
    q = torch.log_softmax(q_logits.float(), dim=-1)
    return torch.sum(torch.exp(q) * (q - p), dim=-1)


def contrastive_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                   labels: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """D_CKL(P_student || P_teacher) with the *teacher* as reference.

    student/teacher logits: [..., V]; labels: [...] int.  Returns a 0-d
    tensor.  The teacher's logits are detached, so no gradient reaches
    the teacher through this term."""
    teacher_logits = teacher_logits.detach()
    correct = torch.argmax(teacher_logits, dim=-1) == labels
    kl = _kl(student_logits, teacher_logits)
    ok = correct.float()
    align = torch.sum(kl * ok) / (torch.sum(ok) + 1e-6)
    wrong = 1.0 - ok
    diverge = torch.sum(kl * wrong) / (torch.sum(wrong) + 1e-6)
    return align - beta * diverge


def dcml_losses(forward_fn: Callable, params_r, params_s, batch, lam: float,
                beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two Eq. 3 objectives, evaluated on the receiver's local batch.

    F^_r = (1-lam) F_r(w_r) + lam D_CKL(P_r || P_s)
    F^_s = (1-lam) F_r(w_s) + lam D_CKL(P_s || P_r)

    ``forward_fn(params, batch) -> (loss, logits, labels)`` abstracts the
    task: one forward a model gives its base loss and its logits, where the
    reference's ``dcml_losses`` takes a ``logits_fn`` and a base loss
    function and runs the network apart for each (the same values, half
    the graphs held).
    """
    f_r, logits_r, labels = forward_fn(params_r, batch)
    f_s, logits_s, _ = forward_fn(params_s, batch)
    l_r = (1 - lam) * f_r + lam * contrastive_kl(logits_r, logits_s, labels, beta)
    l_s = (1 - lam) * f_s + lam * contrastive_kl(logits_s, logits_r, labels, beta)
    return l_r, l_s


def merge_by_validation(params_r, params_s, v_r, v_s):
    """w_r^{t+1} = (v_r w_r + v_s w_s) / (v_r + v_s)   (Eq. 3, last line).

    Lower validation loss should mean HIGHER weight, so (as in the GCML
    reference implementation) the weights are inverted validation
    losses: each model is weighted by the other's loss share.  Takes
    trees or flat ``[N]`` rows."""
    tot = v_r + v_s + 1e-12
    a, b = v_s / tot, v_r / tot          # inverse weighting
    return tree_map(lambda x, y: (a * x.float() + b * y.float()).to(x.dtype),
                    params_r, params_s)
