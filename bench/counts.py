"""The benchmark's yardstick: the chip's published peaks, the operations and
bytes of each kernel's work and of a whole request, computed from shapes,
and the roofline and idle-share arithmetic.

Each count is of the operation's work, whatever implements it: every input
byte read once, every output byte written once, products at the
configuration's dtype (bf16) on the bf16 tensor-core peak.  Nothing here
imports the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity.
BF16_FLOPS = 989e12
HBM_BPS = 3.35e12


def expect_kernels(found: list, calls: int, pattern: str) -> None:
    """A roofline's count of traced kernels against the calls the traced
    steps make: another count (a kernel renamed, split or doubled, or a
    lost record) would put the time of other work under the bound, so it
    fails the run."""
    if len(found) != calls:
        raise RuntimeError(f"the trace holds {len(found)} kernels matching "
                           f"{pattern!r} where the traced steps make "
                           f"{calls} calls")


def least_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """Least seconds for ``flops`` at ``peak`` and ``nbytes`` at HBM speed:
    the larger of the two bounds."""
    return max(flops / peak, nbytes / HBM_BPS)


# ---------------------------------------------------------------------------
# Kernels: (flops, bytes) of one call
# ---------------------------------------------------------------------------
def flash_prefill(B: int, T: int, H: int, KV: int, hd: int,
                  itemsize: int = 2) -> tuple:
    """Causal self-attention over T positions: Q Kᵀ and P V over the
    T (T + 1) / 2 causal pairs of each head; q, k, v read, o written."""
    pairs = T * (T + 1) // 2
    flops = 4 * B * H * hd * pairs
    nbytes = itemsize * B * T * hd * (2 * H + 2 * KV)
    return flops, nbytes


def decode_attention(B: int, H: int, KV: int, hd: int, pos: int,
                     itemsize: int = 2) -> tuple:
    """One query per sequence against the cache on [0, pos]: the keys and
    values of pos + 1 positions read once, q read, o written."""
    n = pos + 1
    flops = 4 * B * H * hd * n
    nbytes = itemsize * (2 * B * KV * n * hd + 2 * B * H * hd)
    return flops, nbytes


def ssd_scan(B: int, T: int, H: int, P: int, N: int, chunk: int,
             x_itemsize: int = 2, bc_itemsize: int = 2) -> tuple:
    """Mamba2's chunked SSD scan from a zero state (arXiv:2405.21060, §6):
    C Bᵀ over each chunk's causal pairs (shared by the heads), the masked
    product with x·dt, each chunk's state (Bᵀ x·dt), and the output of the
    state entering every chunk but the first.  Reads x, dt (float32), A
    and B, C; writes y and the final state in float32."""
    nc = T // chunk
    pairs = nc * chunk * (chunk + 1) // 2
    flops = (2 * B * pairs * N                      # C Bᵀ
             + 2 * B * H * pairs * P                # (L ∘ C Bᵀ) x·dt
             + 2 * B * H * T * P * N                # chunk states
             + 2 * B * H * (T - chunk) * P * N)     # states -> outputs
    nbytes = (x_itemsize * B * T * H * P + 4 * B * T * H + 4 * H
              + 2 * bc_itemsize * B * T * N
              + 4 * B * T * H * P + 4 * B * H * P * N)
    return flops, nbytes


# ---------------------------------------------------------------------------
# A whole request: each family's ``request_flops(conf, T, steps)`` lies
# beside its reference (``bench/reference/<family>.py``)
# ---------------------------------------------------------------------------
def vocab(conf: dict) -> int:
    """The served vocabulary: ``vocab_size`` padded up to
    ``pad_vocab_size_multiple`` where the configuration pads it."""
    c = conf["config"]
    m = c.get("pad_vocab_size_multiple", 1)
    return -(-c["vocab_size"] // m) * m


def request_flops(conf: dict, T: int, steps: int) -> int:
    """Model FLOPs of one request of T prompt tokens and ``steps`` decode
    steps, by the configuration's family."""
    from bench import reference
    return reference.module(conf).request_flops(conf, T, steps)


# ---------------------------------------------------------------------------
# Device timeline arithmetic (from chip_smoke.py's _profile_in / _bound)
# ---------------------------------------------------------------------------
def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of each stretch of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
