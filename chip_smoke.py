#!/usr/bin/env python3
"""Smoke run of gzp_tpu_torch on one CUDA card: build, hold, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line then):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — every kernel from ``gzp_tpu_torch/csrc`` with nvcc for
             sm_90a, printing registers, shared memory and spills;
3. kernels — at the main path's shapes (64 blocks of 128 KiB: text, one
             all-zero block, one random block), each kernel held against
             its plain PyTorch version on the card (exact equality on
             every output) and timed with CUDA events beside its bound;
4. path    — 256 MiB of text through ``ZBuilder(Mgzip)`` at level 3 on
             the card; gzip must restore it, every kernel must have been
             launched, and the first blocks must equal a CPU run's bytes;
5. result  — one ``kernels`` JSON line, then the last line
             ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import io
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Hopper issues 64 INT32 lanes per SM per clock, half its 128 FP32 lanes:
# half the data sheet's 67 TFLOP/s float32 rate outside the tensor cores
INT32_OPS_PER_S = 33.5e12
B, N = 64, 131072
PATH_BYTES = 256 << 20


def make_corpus(nbytes: int) -> bytes:
    """Deterministic shakespeare-like English text (bench.py's generator)."""
    rng = np.random.default_rng(1234)
    vocab = (
        "the quick brown fox jumps over lazy dog and all that glitters is not gold "
        "to be or not to be that is the question whether tis nobler in the mind to "
        "suffer the slings and arrows of outrageous fortune or to take arms against "
        "a sea of troubles and by opposing end them to die to sleep no more and by a "
        "sleep to say we end the heartache and the thousand natural shocks that flesh "
        "is heir to tis a consummation devoutly to be wished to die to sleep"
    ).split()
    words = [w.encode() for w in vocab]
    picks = rng.integers(0, len(words), size=nbytes // 3)
    parts = []
    total = 0
    line = 0
    for p in picks:
        w = words[p]
        parts.append(w)
        total += len(w) + 1
        line += len(w) + 1
        if line > 70:
            parts.append(b"\n")
            line = 0
        else:
            parts.append(b" ")
        if total >= nbytes:
            break
    return b"".join(parts)[:nbytes]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(got, want) -> int:
    """Largest difference over every output of a kernel and its plain version."""
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def hold(name, kernel, plain, args, kwargs, nbytes, nops, source, replaces):
    """Compare kernel and plain version on the same card inputs, time both."""
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms = time_ms(lambda: kernel(*args, **kwargs))
    plain_ms = time_ms(lambda: plain(*args, **kwargs), iters=3, warmup=1)
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / INT32_OPS_PER_S else "operations",
        "library_ms": None,
    }
    print(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']})", flush=True)
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}")
    return got, row


def members(blob: bytes) -> list[bytes]:
    """Split an Mgzip stream into members by their BLEN fields."""
    out, pos = [], 0
    while pos < len(blob):
        blen = int.from_bytes(blob[pos + 16: pos + 20], "little")
        out.append(blob[pos: pos + blen])
        pos += blen
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gzp_tpu_torch import Mgzip, ZBuilder
    from gzp_tpu_torch.ops import deflate_kernel as dk
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda
    from gzp_tpu_torch.ops.lz import _pos_bits
    from gzp_tpu_torch.runtime import cuda_lib

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = cuda_lib.build(force=True, ptxas_verbose=True)
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")
    sys.stdout.flush()

    # ---- 3. kernels at the main path's shapes
    dev = torch.device("cuda", 0)
    text = np.frombuffer(make_corpus(B * N), np.uint8).reshape(B, N).copy()
    text[1] = 0
    text[2] = np.random.default_rng(7).integers(0, 256, N, dtype=np.uint8)
    data = torch.from_numpy(text).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    pw, lags, pos_bits = cfg.payload_words, cfg.lags, _pos_bits(N)
    npad = lz_cuda.padded_len(N)
    src = "gzp_tpu_torch/csrc/"
    rows = []

    (key, pays), row = hold(
        "K1 build_keys", lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, (data,),
        dict(pos_bits=pos_bits, payload_words=pw),
        nbytes=B * N + (1 + pw) * B * npad * 4, nops=B * npad * (7 * pw + 4),
        source=src + "build_keys.cu", replaces="gzp_tpu/ops/lz_pallas.py:121",
    )
    rows.append(row)
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(pw, -1, -1))
    nb_k2 = B * npad * (8 + 4 * pw) + 4 * B + 2 * B * npad * 4
    (sp, packed), row = hold(
        "K2 neighbor", lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain, (sk, spays, halo),
        dict(pos_bits=pos_bits, lags=lags, max_dist=32768),
        nbytes=nb_k2, nops=B * npad * lags * (10 + 4 * pw),
        source=src + "neighbor.cu", replaces="gzp_tpu/ops/lz_pallas.py:194",
    )
    rows.append(row)
    # K3's function: the same kernel at lags = 4 (not on the level-3 path)
    _, k3 = hold(
        "K3 neighbor lags=4", lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain,
        (sk, spays, halo), dict(pos_bits=pos_bits, lags=4, max_dist=32768),
        nbytes=nb_k2, nops=B * npad * 4 * (10 + 4 * pw),
        source=src + "neighbor.cu", replaces="gzp_tpu/ops/lz_pallas.py:256",
    )
    packed_pos = torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)
    (ml, md), row = hold(
        "K6 match_tail", lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
        (data, packed_pos, lengths, halo),
        dict(base=0, payload_bytes=4 * pw, max_match=258, min_emit=3, lazy=True),
        nbytes=B * N + B * npad * 4 + 8 * B + 2 * B * N * 4, nops=B * npad * 90,
        source=src + "match_tail.cu", replaces="gzp_tpu/ops/lz_pallas.py:472",
    )
    rows.append(row)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    all_bits, all_n = dk.block_entries(cfg, data, marked, ln, md)
    e = all_bits.shape[1]
    ep = pack_cuda.prescan_len(e)
    _, row = hold(
        "K10 pack_prescan", pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain,
        (all_bits, all_n, 8 * cfg.header_len), {},
        nbytes=2 * B * e * 4 + 2 * B * ep * 4 + 4 * B, nops=B * ep * 50,
        source=src + "pack_prescan.cu", replaces="gzp_tpu/ops/pack_pallas.py:65",
    )
    rows.append(row)
    print(json.dumps({"k3_check": k3}), flush=True)

    # where one batch's device time goes, stage by stage (CUDA events)
    words_args = (all_bits, all_n, 8 * cfg.header_len, cfg.out_words)
    encode = dk.get_encoder(cfg, compact=True)
    stages = {
        "match": time_ms(lambda: dk.match_stage(cfg, data, lengths), iters=5),
        "parse": time_ms(lambda: dk.parse_stage(cfg, ml, lengths), iters=5),
        "entries": time_ms(lambda: dk.block_entries(cfg, data, marked, ln, md), iters=5),
        "pack": time_ms(lambda: pack_cuda.pack_entries_sortscan_cuda(*words_args), iters=5),
        "crc32": time_ms(lambda: dk.crc32_device(data, lengths), iters=5),
        "encode": time_ms(lambda: encode(data, lengths), iters=5),
    }
    print("stages ms per 64x128KiB batch: " + json.dumps(stages), flush=True)

    # ---- 4. the main path: ZBuilder(Mgzip) at level 3 on the card
    t0 = time.perf_counter()
    corpus = make_corpus(PATH_BYTES)
    print(f"path: {len(corpus)} bytes of corpus made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def compress(blob: bytes, threads: int = B, device=None) -> bytes:
        buf = io.BytesIO()
        w = (ZBuilder(Mgzip).num_threads(threads).compression_level(3).device(device)
             .from_writer(buf))
        w.write(blob)
        w.finish()
        return buf.getvalue()

    compress(corpus[: B * N])  # warm-up: allocator, pinned buffers, cuBLAS
    torch.cuda.synchronize()
    kernels = [lz_cuda.BUILD_KEYS, lz_cuda.NEIGHBOR, lz_cuda.MATCH_TAIL, pack_cuda.PACK_PRESCAN]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = compress(corpus)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    for row, n_launch in zip(rows, launches):
        row["launches"] = n_launch
    print(f"path: launches {dict(zip([r['name'] for r in rows], launches))}")
    if min(launches) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if gzip.decompress(out) != corpus:
        raise AssertionError("gzip.decompress does not restore the input")
    card = members(out)
    cpu = members(compress(corpus[: 4 * N], threads=4, device="cpu"))
    if card[:4] != cpu:
        raise AssertionError("card members differ from the CPU run's on the first 4 blocks")
    zsize = sum(len(zlib.compress(corpus[i: i + N], 3)) for i in range(0, len(corpus), N))
    gbps = len(corpus) / secs / 1e9
    print(f"path: {len(corpus)} B -> {len(out)} B, ratio {len(corpus) / len(out):.4f}, "
          f"size vs zlib-3 per 128 KiB block {len(out) / zsize:.4f}; first 4 members "
          f"equal the CPU run's; {secs:.3f} s = {gbps:.4f} GB/s end to end on {smi}",
          flush=True)

    # ---- 5. result
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
