"""K4 (``csrc/lcp_lags.cu``): two launches per batch at levels 6-9, the
content-sorted keys at lag 1 and the hash-sorted payloads at lags 1-2.
Each reads every slot's words up to its first difference from its
neighbours and writes one word per slot and lag. How deep the first
difference lies depends on the data; this counts the floor that every
input needs, one word per slot, so the bound can only be low (at 64 x
131,072 on the benchmark text a slot needs 3.09 words at lag 1: 137,120,696
bytes by the repository's kernel table, against this floor's 67,108,864)."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    slots = s["rows"] * s["npad"]
    return [(4 * slots * (1 + lags), 0) for lags in (1, 2)]
