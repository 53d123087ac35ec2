"""The trace reduction, each per-layer reader and each work file, on a
small hand-built profile."""

import json
from pathlib import Path

import pytest

from portbench import harness, peaks, trace

BENCH = json.loads(harness.BENCHMARK.read_text())


def _events():
    """A span of 1,000 us on thread 1: two writes; device work 100-300 and
    250-400 (one package kernel, one PyTorch kernel) and 700-800 (a copy);
    the thread waits in a synchronise from 600 to 800."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "write", "ts": 0, "dur": 500, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "finish", "ts": 500, "dur": 480, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void build_keys_kernel<3>(int)", "ts": 100,
         "dur": 200, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "at::elementwise_kernel", "ts": 250, "dur": 150,
         "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 700, "dur": 100, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 600,
         "dur": 200, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 600,
         "dur": 200, "tid": 2},  # another thread's wait is not the span's
    ]
    return ev


def test_summarize():
    s = trace.summarize(_events(), ["build_keys", "neighbor"], batches=2)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)  # [100, 400] and [700, 800]
    assert s["wait_s"] == pytest.approx(200e-6)
    assert s["device_ops"] == 3
    assert s["kernels"]["build_keys"] == {"launches": 1, "device_s": pytest.approx(200e-6)}
    assert s["kernels"]["neighbor"]["launches"] == 0
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 100e-6])
    # 400-700 (its middle in finish, in no runtime call), 800-1000, 0-100
    assert [g[0] for g in gaps] == ["finish/host", "finish/host", "write/host"]
    assert s["breakdown"]["device_ops"][0] == ["build_keys_kernel<3>(int)",
                                               pytest.approx(200e-6)]


def _summary(direction="compress"):
    s = trace.summarize(_events(), ["build_keys"], batches=2)
    s["direction"] = direction
    shape = harness.shapes({"rows": 64, "block_bytes": 131072, "level": 3}, 0)
    harness.kernel_bounds(s, shape)
    return s


def reader(name):
    return harness.plugin("metrics", name)


def test_compress_readers():
    s = _summary()
    assert reader("host_ms_per_batch.compress").read(s) == pytest.approx((1e-3 - 200e-6) / 2 * 1e3)
    assert reader("launches_per_batch.compress").read(s) == 1.5
    assert reader("idle_share.compress").read(s) == pytest.approx(60.0)
    bound = peaks.bound_s(142_606_336)
    assert reader("kernel_roofline.compress").read(s) == pytest.approx(100 * bound / 200e-6)
    for name in ("kernel_roofline.decompress", "idle_share.decompress",
                 "device_blocks.decompress"):
        assert reader(name).read(s) is None


def test_decompress_readers():
    s = _summary("decompress")
    s["fallback"] = {"device": 3, "native": 1}
    assert reader("device_blocks.decompress").read(s) == 75.0
    assert reader("idle_share.decompress").read(s) == pytest.approx(60.0)
    assert reader("host_ms_per_batch.compress").read(s) is None


def test_kernel_without_work_file_adds_time_and_no_bound(tmp_path):
    s = trace.summarize(_events(), ["build_keys"], batches=2)
    s["direction"] = "compress"
    (tmp_path / "work").mkdir()
    harness.kernel_bounds(s, {}, tmp_path)
    assert s["unbounded"] == ["build_keys"]
    assert reader("kernel_roofline.compress").read(s) == 0.0


def test_every_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert callable(reader(m["name"]).read)


# the kernel table of PERF.md (bytes and operations per launch at 64 x 131,072)
TABLE = {
    ("build_keys", 3): [(142_606_336, 0)],
    ("build_keys", 6): [(276_824_064, 0)],
    ("neighbor", 3): [(234_881_280, 0)],
    ("match_tail", 3): [(109_052_416, 754_974_720)],
    ("pack_prescan", 3): [(134_916_352, 0)],
    ("build_suffix_keys", 6): [(276_824_064, 0)],
    ("suffix_merge", 6): [(100_663_552, 0)],
    ("hash_merge", 6): [(201_326_848, 0)],
    ("match_tail2", 6): [(142_606_848, 1_174_405_120)],
    # K4: the floor of one word a slot (the table's data-dependent counts
    # are 137,120,696 and 143,976,220 on bench text)
    ("lcp_lags", 6): [(67_108_864, 0), (100_663_296, 0)],
}


@pytest.mark.parametrize("kernel,level", sorted(TABLE))
def test_work_files_match_the_kernel_table(kernel, level):
    shape = harness.shapes({"rows": 64, "block_bytes": 131072, "level": level}, 0)
    assert harness.plugin("work", kernel).per_batch(shape) == TABLE[kernel, level]


def test_inflate_work_counts_its_bytes():
    shape = {"rows": 64, "inflate_in_bytes": 1_095_193}
    assert harness.plugin("work", "inflate").per_batch(shape) == [
        (1_095_193 + 13 * 64 + 64 * 65536, 0)]


@pytest.mark.parametrize("level", range(0, 10))
@pytest.mark.parametrize("block", [65280, 131072, 262144])
def test_shapes_take_the_ports_knobs_for_the_level(level, block):
    from gzp_tpu_torch.ops.deflate_kernel import DeflateEncodeConfig

    s = harness.shapes({"rows": 64, "block_bytes": block, "level": level}, 0)
    k = DeflateEncodeConfig.for_level(block, "mgzip", "crc32", level)
    assert (s["payload_words"], s["lags"], s["suffix_keys"], s["subblocks"], s["matcher"]) == (
        k.payload_words, k.lags, k.suffix_keys, k.subblocks, k.matcher)


def test_stream_rows_carry_the_halo():
    from portbench.formats import gzip

    s = harness.shapes({"rows": 64, "block_bytes": 131072, "level": 3}, gzip.HALO)
    assert (s["row"], s["npad"]) == (163840, 163840)
    b = harness.shapes({"rows": 64, "block_bytes": 65280, "level": 6}, 0)
    assert (b["npad"], b["subblocks"]) == (65536, 1)
    assert harness.shapes({"rows": 64, "block_bytes": 131072, "level": 6}, 0)["subblocks"] == 2


def test_every_package_kernel_has_a_work_file():
    from gzp_tpu_torch.runtime import cuda_lib
    from gzp_tpu_torch.ops import inflate_kernel, lz_cuda, pack_cuda  # noqa: F401

    names = {k.name for k in cuda_lib.registered()}
    assert names == {p.stem for p in (harness.HERE / "work").glob("*.py")}
    assert names  # the registry was filled
    assert Path(harness.HERE / "work").is_dir()
