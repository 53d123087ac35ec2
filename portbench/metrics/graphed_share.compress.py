"""The share of the write path's encoder calls in the traced span that
replayed a CUDA graph, in percent: ``graph_stats`` of
``gzp_tpu_torch.ops.graphs``, 100 x ``replayed`` / (``replayed`` +
``eager``). The program counts only while a torch profiler records, so the
counts cover exactly the traced span. None where the program keeps no such
counter or made no encoder call."""


def read(s: dict) -> float | None:
    if s.get("direction") != "compress":
        return None
    try:
        from gzp_tpu_torch.ops import graphs
    except ImportError:
        return None
    stats = getattr(graphs, "graph_stats", None)
    if not stats:
        return None
    calls = stats.get("replayed", 0) + stats.get("eager", 0)
    if not calls:
        return None
    return 100 * stats["replayed"] / calls
