"""The numbers that decide ``correct``, each held to its limit.

The program's probability rows against the reference's logits, per video:

- ``prob_kl``: the Kullback-Leibler divergence of the program's distribution
  from the reference's, ``sum p_ref (log p_ref - log p)`` in nats;
- ``logit_rel_err``: the relative L2 distance of the program's centred
  log-probabilities from the reference's centred logits.

Each is taken over the videos of the sample as the mean and as the worst
video; ``limits/<cell>.json`` says which of them a cell holds to a limit
(PERF.md gives the readings each limit was set from), and every run prints
the rest beside them.
"""

from __future__ import annotations

import torch


def logit_rel_err(probs: torch.Tensor, ref_logits: torch.Tensor) -> torch.Tensor:
    """Per video: the program's centred log-probabilities against the
    reference's centred logits, relative L2."""
    lp = torch.log(probs.double())
    lp = lp - lp.mean(dim=-1, keepdim=True)
    z = ref_logits.double()
    z = z - z.mean(dim=-1, keepdim=True)
    return (lp - z).norm(dim=-1) / z.norm(dim=-1)


def prob_kl(probs: torch.Tensor, ref_logits: torch.Tensor) -> torch.Tensor:
    """Per video: KL(reference || program) in nats, the program's row
    renormalised (its probabilities are rounded)."""
    q = probs.double()
    log_q = torch.log(q) - torch.log(q.sum(dim=-1, keepdim=True))
    log_p = torch.log_softmax(ref_logits.double(), dim=-1)
    return (log_p.exp() * (log_p - log_q)).sum(dim=-1)


def numbers(rows) -> dict:
    """Every number of the check, from (program probabilities, reference
    logits) pairs, one pair a request."""
    kl = torch.cat([prob_kl(p, z) for p, z in rows])
    rel = torch.cat([logit_rel_err(p, z) for p, z in rows])
    return {"prob_kl": float(kl.mean()), "prob_kl_worst": float(kl.max()),
            "logit_rel_err": float(rel.mean()), "logit_rel_err_worst": float(rel.max())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """``correct`` and one line per number: its value beside its limit."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    return ok, lines
