"""The share of blocks the device decoded in the traced run, over its
profiled span and the whole window that follows it
(``ParDecompress.fallback_stats``: device / (device + native)), in
percent. A change that sends blocks to the host codec shows here."""


def read(s: dict) -> float | None:
    fb = s.get("fallback")
    if s.get("direction") != "decompress" or not fb or not sum(fb.values()):
        return None
    return 100 * fb["device"] / (fb["device"] + fb["native"])
