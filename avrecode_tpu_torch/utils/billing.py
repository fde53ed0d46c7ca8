"""Per-syntax-class bit accounting as a table: counterpart of
avrecode_tpu/utils/billing.py over the port's host.Stats."""
from __future__ import annotations

from ..host import Stats


def format_bill(stats: Stats) -> str:
    """Human-readable side-by-side of our cost vs the original CABAC's."""
    rows = []
    header = f"{'class':<14}{'count':>12}{'ours(B)':>12}{'cabac(B)':>12}{'win(B)':>10}"
    rows.append(header)
    rows.append("-" * len(header))
    tot_ours = tot_cabac = 0.0
    for name, b in stats.bill.items():
        ours = b.get("bytes", 0.0)
        cabac = b.get("cabac_bytes", 0.0)
        tot_ours += ours
        tot_cabac += cabac
        rows.append(f"{name:<14}{b.get('count', 0):>12}{ours:>12.0f}{cabac:>12.0f}"
                    f"{cabac - ours:>+10.0f}")
    rows.append("-" * len(header))
    rows.append(f"{'TOTAL':<14}{'':>12}{tot_ours:>12.0f}{tot_cabac:>12.0f}"
                f"{tot_cabac - tot_ours:>+10.0f}")
    return "\n".join(rows)
