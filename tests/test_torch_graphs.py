"""What the CUDA graphs of ``ops/graphs.py`` need from the stages, checked
on the CPU: each constant a stage used to upload from a Python list per
call, now a per-device cached table, equals that list; the strided slice
that ends the sub-blocks in ``parse_stage`` zeroes exactly the positions
of the list index it replaces, and the parse is unchanged; ``get_encoder``
and ``get_snappy_encoder`` return one function per equal config (the
graphs' key); and on the CPU ``graphs.run`` calls the encoder eagerly,
counting ``eager`` only while a profiler records."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gzp_tpu_torch.constants import SNAPPY_STREAM_IDENTIFIER
from gzp_tpu_torch.formats import ALL_FORMATS
from gzp_tpu_torch.ops import deflate_kernel as dk
from gzp_tpu_torch.ops import graphs, huffman, tables
from gzp_tpu_torch.ops import snappy_kernel as sk
from gzp_tpu_torch.parallel.mesh import MeshEncoder

CPU = torch.device("cpu")
I64 = torch.int64
CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    graphs.reset_graph_stats()
    yield
    graphs.reset_graph_stats()


# ---- the hoisted constants: each table against the list it replaces


@pytest.mark.parametrize("table,want", [
    (huffman.cl_order, CL_ORDER),
    (huffman.constant_cl_lens, [4 if s <= 15 else 0 for s in CL_ORDER]),
    (huffman.header_counts, [huffman.NLIT - 257, huffman.NDIST - 1, 19 - 4]),
    (huffman.header_widths, [3, 5, 5, 4] + [3] * 19),
], ids=["cl_order", "constant_cl_lens", "header_counts", "header_widths"])
def test_huffman_header_constants_equal_their_lists(table, want):
    got = tables.on_device(table, (), CPU, I64)
    assert got.dtype == torch.as_tensor(want).dtype == I64
    assert got.tolist() == want
    assert tables.on_device(table, (), CPU, I64) is got  # built once per device


@pytest.mark.parametrize("level", range(10))
@pytest.mark.parametrize("mode", ["mgzip", "bgzf"])
def test_member_header_table_equals_the_formats_header(mode, level):
    got = tables.on_device(dk.member_header_bytes, (mode, level), CPU, torch.uint8)
    assert got.dtype == torch.uint8
    assert got.tolist() == list(ALL_FORMATS[mode].member_header(level))
    assert len(got) == dk.DeflateEncodeConfig(block_len=4096, mode=mode,
                                              checksum="none").header_len


def test_snappy_stream_identifier_table_equals_the_constant():
    got = tables.on_device(sk.stream_identifier, (), CPU, torch.uint8)
    assert got.dtype == torch.uint8
    assert got.tolist() == list(SNAPPY_STREAM_IDENTIFIER)


# ---- parse_stage's sub-block ends as a strided slice


def _old_subblock_ends(cfg):
    ns = cfg.block_len // cfg.subblocks
    return [cfg.dict_size + (s + 1) * ns - 1 for s in range(cfg.subblocks - 1)]


CONFIGS = [
    dict(block_len=131072, mode="mgzip", checksum="none", level=6),
    dict(block_len=262144, mode="mgzip", checksum="none", level=9),
    dict(block_len=131072, mode="stream", checksum="crc32", level=6, dict_size=32768),
    dict(block_len=262144, mode="stream", checksum="adler32", level=7, dict_size=32768),
    dict(block_len=65280, mode="bgzf", checksum="none", level=6),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"{kw['mode']}-{kw['block_len']}")
def test_subblock_slice_zeroes_the_old_lists_positions(kw):
    cfg = dk.DeflateEncodeConfig.for_level(**kw)
    x = torch.zeros(cfg.dict_size + cfg.block_len, dtype=torch.int32)
    x[dk.subblock_last_positions(cfg)] = 1
    assert torch.nonzero(x).flatten().tolist() == _old_subblock_ends(cfg)


def test_parse_stage_matches_the_list_index():
    cfg = dk.DeflateEncodeConfig(block_len=4096, mode="stream", checksum="none", level=6,
                                 subblocks=4, dict_size=512)
    g = torch.Generator().manual_seed(5)
    b, m = 3, cfg.dict_size + cfg.block_len
    ml = torch.randint(0, 20, (b, m), generator=g, dtype=torch.int32)
    ml[:, : cfg.dict_size] = 0
    lengths = torch.tensor([cfg.block_len, cfg.block_len - 77, 1000], dtype=torch.int32)
    given = ml.clone()
    old = ml.clone()
    old[:, _old_subblock_ends(cfg)] = 0
    want = dk.lz.parse_marks_scan(old, lengths, min_emit=3, base=cfg.dict_size)
    got = dk.parse_stage(cfg, ml, lengths)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(ml, given)  # the caller's match field is left as it was


# ---- one encoder function per equal config


def test_get_encoder_one_function_per_equal_config():
    def cfg(level):
        return dk.DeflateEncodeConfig.for_level(65536, "stream", "crc32", level, 32768)

    assert dk.get_encoder(cfg(3)) is dk.get_encoder(cfg(3))
    assert dk.get_encoder(cfg(3)) is not dk.get_encoder(cfg(6))
    fmt = ALL_FORMATS["mgzip"]
    assert fmt.encoder(131072, 3, True)[0] is fmt.encoder(131072, 3, True)[0]


def test_get_snappy_encoder_one_function_per_equal_config():
    a = sk.get_snappy_encoder(sk.SnappyEncodeConfig(block_len=65536))
    assert a is sk.get_snappy_encoder(sk.SnappyEncodeConfig(block_len=65536))
    assert a is not sk.get_snappy_encoder(sk.SnappyEncodeConfig(block_len=32768))


# ---- graphs.run on the CPU


def _batch(rows=2, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"the quick brown fox jumps over the lazy dog ", np.uint8)
    data = words[rng.integers(0, len(words), rows * n)].reshape(rows, n).copy()
    lengths = np.array([n] + [n - 100] * (rows - 1), np.int32)
    return data, lengths, np.zeros(rows, bool)


def test_run_on_the_cpu_is_eager_and_counts_only_while_recording():
    encode = dk.get_encoder(dk.DeflateEncodeConfig.for_level(4096, "mgzip", "none", 3))
    inputs = [torch.from_numpy(a) for a in _batch()]
    want = encode(*inputs)
    got = graphs.run(encode, *inputs)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert graphs.graph_stats == {"captured": 0, "replayed": 0, "eager": 0}
    with profile(activities=[ProfilerActivity.CPU]):
        graphs.run(encode, *inputs)
        graphs.run(encode, *inputs)
    assert graphs.graph_stats == {"captured": 0, "replayed": 0, "eager": 2}
    assert not any(key[1].type == "cpu" for key in graphs._graphs)  # nothing cached


def test_mesh_runs_each_share_through_graphs_run():
    encode = sk.get_snappy_encoder(sk.SnappyEncodeConfig(block_len=4096))
    arrays = _batch(rows=4)
    with profile(activities=[ProfilerActivity.CPU]):
        res = MeshEncoder(encode, ["cpu", "cpu"])(*arrays)
    assert graphs.graph_stats["eager"] == 2
    one = encode(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(torch.cat([r["out"] for r in res]), one["out"])
