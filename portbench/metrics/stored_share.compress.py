"""The share of blocks the write path rewrote stored in the traced span, in
percent: ``stored_stats`` of ``gzp_tpu_torch.parallel.compress``, the
blocks ``ParCompress`` emitted and those ``_maybe_fallback`` replaced by a
stored Deflate block or member or an uncompressed Snappy chunk. The program counts
only while a torch profiler records, so the counts cover exactly the traced
span. None where the program keeps no such counter or saw no block."""


def read(s: dict) -> float | None:
    if s.get("direction") != "compress":
        return None
    try:
        from gzp_tpu_torch.parallel import compress
    except ImportError:
        return None
    stats = getattr(compress, "stored_stats", None)
    if not stats or not stats.get("blocks"):
        return None
    return 100 * stats["stored"] / stats["blocks"]
