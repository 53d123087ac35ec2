"""The share of the slots the write path's matcher took that were
dictionary in the traced span, in percent: ``halo_stats`` of
``gzp_tpu_torch.parallel.compress``, 100 x ``dict_bytes`` / (``dict_bytes``
+ ``block_bytes``) over the rows dispatched with data in a stream whose
blocks carry the 32 KiB before them. The program counts only while a torch
profiler records, so the counts cover exactly the traced span. None where
the program keeps no such counter or counted nothing."""


def read(s: dict) -> float | None:
    if s.get("direction") != "compress":
        return None
    try:
        from gzp_tpu_torch.parallel import compress
    except ImportError:
        return None
    stats = getattr(compress, "halo_stats", None)
    if not stats:
        return None
    slots = stats.get("dict_bytes", 0) + stats.get("block_bytes", 0)
    if not slots:
        return None
    return 100 * stats["dict_bytes"] / slots
