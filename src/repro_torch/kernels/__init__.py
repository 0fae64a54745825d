"""repro_torch.kernels"""

from __future__ import annotations


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel (``flash``,
    ``decode``, ``paged``, ``ssd_scan``) and, for the flash kernel, also by
    body (``flash/wgmma``, ...).  A wrapper counts where it launches its
    kernel; under a CUDA-graph capture that is where the launch is
    recorded, so a graph's replays count nowhere and whoever replays one
    counts them (``RealExecutor.replayed_launches``)."""
    from repro_torch.kernels.decode_attention import decode_attention as k2
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention as k3
    from repro_torch.kernels.flash_attention import flash_attention as k1
    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    counts = {"flash": k1.LAUNCHES, "decode": k2.LAUNCHES,
              "paged": k3.LAUNCHES, "ssd_scan": k4.LAUNCHES}
    counts.update({f"flash/{body}": n
                   for body, n in k1.LAUNCHES_BY_BODY.items()})
    return counts
