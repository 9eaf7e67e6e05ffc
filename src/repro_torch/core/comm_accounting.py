"""Communication accounting — Table IV, as executable closed forms plus a
runtime ledger the simulator feeds; tests assert ledger == closed form.
The counterpart of ``repro/core/comm_accounting.py``: the same integers.

Notation (paper §IV): X = model capacity (bytes), T_cyc / T_res = rounds
in P1 / P2, K_P1 / K_P2 = clients per round in P1 / P2.

Closed forms (Table IV):
    FedAvg/FedProx/Moon  w/o cyclic : 2·K_P2·T_tot·X
    SCAFFOLD             w/o cyclic : 4·K_P2·T_tot·X
    FedAvg/FedProx/Moon  w/ cyclic  : 2·[K_P1·T_cyc + K_P2·T_res]·X
    SCAFFOLD             w/ cyclic  : 2·[K_P1·T_cyc + 2·K_P2·T_res]·X

P1 is a relay: each participating client downloads the model and uploads
it once ⇒ 2·K_P1·X per round, same per-round cost shape as FedAvg but
with K_P1 clients.  SCAFFOLD doubles P2 payload (control variates ride
along both directions).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.utils import tree_math as tm

Pytree = Any

_PER_ROUND_FACTOR = {"fedavg": 2, "fedprox": 2, "moon": 2, "scaffold": 4}

# secure-aggregation key-agreement payload: one shared seed per ordered
# client pair per round (Bonawitz-style pairwise masking; the masks
# themselves are derived locally and add zero wire bytes)
SEED_BYTES = 32


def model_bytes(params: Pytree) -> int:
    """X — the model capacity in bytes."""
    return tm.size_bytes(params)


def secure_agg_mask_bytes(k: int) -> int:
    """Per-round secure-agg overhead: each of the K clients exchanges a
    SEED_BYTES seed with each of the other K−1 — the model payload is
    unchanged (masks are the same shape as the upload they hide in)."""
    return k * (k - 1) * SEED_BYTES


def overhead_without_cyclic(algorithm: str, k_p2: int, t_tot: int, x_bytes: int) -> int:
    return _PER_ROUND_FACTOR[algorithm] * k_p2 * t_tot * x_bytes


def overhead_with_cyclic(algorithm: str, k_p1: int, t_cyc: int,
                         k_p2: int, t_res: int, x_bytes: int) -> int:
    p2_factor = _PER_ROUND_FACTOR[algorithm]
    return 2 * k_p1 * t_cyc * x_bytes + p2_factor * k_p2 * t_res * x_bytes


def compressed_round_bytes(algorithm: str, k_p2: int, x_bytes: int,
                           payload_bytes: int) -> int:
    """One compressed P2 round: each of the K clients downloads the full
    model (X) and uploads the compressed payload, once per leg pair —
    the closed form ``table4_comm.py``'s compression column checks the
    ledger against."""
    legs = _PER_ROUND_FACTOR[algorithm] // 2
    return k_p2 * legs * (x_bytes + payload_bytes)


def rounds_budget_equivalent(algorithm: str, k_p1: int, t_cyc: int,
                             k_p2: int, x_bytes: int) -> float:
    """How many P2 rounds the P1 phase costs — converts the paper's
    convergence-speedup (rounds-to-accuracy) into a comm-fair comparison."""
    p1 = 2 * k_p1 * t_cyc * x_bytes
    per_p2_round = _PER_ROUND_FACTOR[algorithm] * k_p2 * x_bytes
    return p1 / per_p2_round


@dataclasses.dataclass
class CommLedger:
    """Runtime byte counter incremented by the P1/P2 drivers.

    Capacity is recomputed PER RECORD (or taken from the explicit
    ``x_bytes`` override the engine passes) — P1 relay and compressed P2
    payloads legitimately differ, so nothing may latch the first call's
    bytes forever.  ``model_bytes`` in :meth:`summary` reports the
    first-seen capacity separately, as the X the closed forms use.

    Compressed communication (repro.fl.compression) threads
    ``payload_bytes`` — the wire bytes of ONE client's compressed
    upload — into :meth:`record_round`: the download legs still ship the
    full model (clients need exact params to train on), so a round costs
    ``K · legs · (X + payload)`` with ``legs = factor/2`` up/down leg
    pairs per client (SCAFFOLD's control variates double both
    directions).  ``payload_ratio`` in the summary is the UPLOAD-side
    reduction — full upload bytes over actual — which is the axis
    compression acts on (1.0 when nothing was compressed).
    """
    p1_bytes: int = 0
    p2_bytes: int = 0
    p1_rounds: int = 0
    p2_rounds: int = 0
    mask_bytes: int = 0         # secure-agg pairwise seed exchanges
    p2_upload_bytes: int = 0        # actual up-leg bytes
    p2_upload_full_bytes: int = 0   # up-leg bytes had nothing compressed
    _x_bytes: Optional[int] = None  # first-seen capacity (reporting only)

    @property
    def total_bytes(self) -> int:
        return self.p1_bytes + self.p2_bytes + self.mask_bytes

    @property
    def payload_ratio(self) -> float:
        """Upload-side compression factor: full / actual up-leg bytes."""
        if not self.p2_upload_bytes:
            return 1.0
        return self.p2_upload_full_bytes / self.p2_upload_bytes

    def record_cyclic_round(self, k_p1: int, params: Pytree, *,
                            x_bytes: Optional[int] = None) -> None:
        x = self._capacity(params, x_bytes)
        self.p1_bytes += 2 * k_p1 * x       # download + upload per client
        self.p1_rounds += 1

    def record_round(self, algorithm: str, k_p2: int, params: Pytree, *,
                     secure_agg: bool = False,
                     x_bytes: Optional[int] = None,
                     payload_bytes: Optional[int] = None) -> None:
        x = self._capacity(params, x_bytes)
        legs = _PER_ROUND_FACTOR[algorithm] // 2    # down/up pairs
        up = x if payload_bytes is None else int(payload_bytes)
        self.p2_bytes += k_p2 * legs * (x + up)
        self.p2_upload_bytes += k_p2 * legs * up
        self.p2_upload_full_bytes += k_p2 * legs * x
        self.p2_rounds += 1
        if secure_agg:
            self.mask_bytes += secure_agg_mask_bytes(k_p2)

    def _capacity(self, params: Pytree,
                  x_bytes: Optional[int] = None) -> int:
        x = int(x_bytes) if x_bytes is not None else model_bytes(params)
        if self._x_bytes is None:
            self._x_bytes = x           # first-seen, for reporting only
        return x

    def summary(self) -> Dict[str, float]:
        return {
            "p1_rounds": self.p1_rounds, "p2_rounds": self.p2_rounds,
            "p1_bytes": self.p1_bytes, "p2_bytes": self.p2_bytes,
            "mask_bytes": self.mask_bytes,
            "total_bytes": self.total_bytes,
            "model_bytes": self._x_bytes or 0,
            "p2_upload_bytes": self.p2_upload_bytes,
            "payload_ratio": self.payload_ratio,
        }
