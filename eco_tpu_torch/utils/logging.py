"""Minimal structured logging (glog-style prefixes, rank-aware).

Twin of ``eco_tpu/utils/logging.py``.  The reference silences non-rank-0
logs (common.cpp:70-73); ``log`` does the same by default, with the rank of
the ``torch.distributed`` process group (0 when there is none).
"""

from __future__ import annotations

import sys
import time

import torch


def rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def log(msg: str, *, all_ranks: bool = False) -> None:
    if not all_ranks and rank() != 0:
        return
    ts = time.strftime("%m%d %H:%M:%S")
    print(f"I{ts} {msg}", file=sys.stderr, flush=True)
