#!/usr/bin/env python3
"""Smoke run of gzp_tpu_torch on one CUDA card: build, hold, drive.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line then):

1. device  — the card's name and power limit (nvidia-smi), the host's CPU
             model and core count;
2. build   — every kernel from ``gzp_tpu_torch/csrc`` with nvcc for
             sm_90a, printing registers, shared memory and spills;
3. kernels — at the main paths' shapes (64 blocks of 128 KiB: text, one
             all-zero block, one random block), each kernel held against
             its plain PyTorch version on the card (exact equality on
             every output) and timed beside its bound (CUDA events call
             by call, and device time from CUDA-graph replay beside it):
             K1, K2 (and K3's function, at lags 4), K6 and K10 at level
             3's config, then K7, K4, K8, K1, K5 and K9 at level 6's (K8
             also at level 9's 24 lags, its operations counted from the
             candidate tests these inputs need under its exit rule,
             ``lz_cuda.suffix_merge_work``), with a stage split per level;
             K8 also on rows built for its ties, early ends and tile edges
             (``suffix_merge_edge_batch``, lags 1, 16, 24 and 127), held
             but not timed;
             K2 also on rows built for its lags halo
             (``neighbor_edge_batch``, lags 1, 2, 4 and 127), K6 also at
             level 1's 8 context bytes (its widest window), and K6 and
             K9 on rows built for their tile and window edges
             (``tail_edge_batch``), held but not timed; K10 also on rows
             built for its look-back (``pack_edge_batch``), held but not
             timed; K2's, K10's and K4's tile, grid, halo or scratch, and
             shared memory; then, held but not timed, every kernel of
             levels 3 and 6 at the stream shape ([halo, data] rows of
             32 + 128 KiB, base 32768, halos as the writer builds them;
             level 3 also with a ragged last row) and K1, K2, K6, K10 at
             Snappy's ([64, 65536], max_dist 65535, max_match 256, min_emit
             4, 144 header bits), with a stage split of a Gzip level-3
             stream batch;
4. paths   — 256 MiB of text through ``ZBuilder(Mgzip)`` on the card at
             level 3, then at level 6; for each, gzip must restore it,
             every kernel of the path must have been launched, the first
             blocks must equal a CPU run's bytes, and the size is compared
             with zlib's at the same level per 128 KiB block (level 6 must
             not exceed it); the mesh path: the same 256 MiB through
             ``ZBuilder(Mgzip).num_threads(64).mesh(devs)`` at levels 3 and
             6, ``devs`` two cards where there are two, else ``[cuda:0,
             cuda:0]`` (counts set to 0 just before, read just after), each
             stream's sha256 equal to the one-device stream's of its level,
             every kernel of the level's path launched, GB/s and the number
             of sub-batches printed; then ``ZBuilder(Gzip)`` at level 3 (256 MiB
             with one ``flush()`` after 100 MiB + 12,345 B) and level 6
             (256 MiB), ``ZBuilder(Zlib)`` and ``ZBuilder(RawDeflate)`` at
             level 3 and ``ZBuilder(Snap)`` (64 MiB each): each restored by
             its decoder, every kernel of its path launched, the first 8
             blocks and a 1,000-byte tail at 4 threads equal to the CPU
             run's bytes, the size against one zlib stream (or Snappy's
             ratio) and GB/s printed; the multi-host path: the 64 MiB as a
             file, two processes of ``python -m
             gzp_tpu_torch.parallel.multihost`` (Gzip, level 3, 64
             threads, a gloo group on a free local port, each on the card)
             whose shards the parent stitches: the stream must restore the
             input and equal a one-process card run byte for byte, each
             worker must report K1, K2, K6 and K10 launched, and a worker
             that fails or outlasts its timeout fails the run; wall time
             with and without process start; ``dryrun_multichip(2)`` on
             the card; then the read side: 256 MiB of text
             through ``ZBuilder(Bgzf)`` at level 6 on the card; the inflate
             K11 held against its plain version (``inflate_case_batch``,
             16 BGZF blocks, and 64 blocks, timed beside its bound and its
             floor, the longest row's symbols at one table-lookup step
             each, the step timed on the card by tools/probe_table_step.cu) and,
             with the device CRC, against the host codec on every block;
             that stream and the Mgzip level-3 path's read by the native
             ``ParDecompress`` at 1, 2, 4, 8, 16 and the core count's
             threads, through read(-1) and 1 MiB reads (the thread curve,
             GB/s); the BGZF stream through ``backend='device'`` (K11's
             main path: counts set to 0 just before, read just after; no
             block may go to the host codec; then one 64-block batch of it
             split into the steps ``_DeviceBatch`` takes, each timed to a
             synchronize) and the Mgzip stream through
             it (every 128 KiB block over the caps: all to the host
             codec); the Gzip level-3 path's stream through
             ``MultiGzDecoder`` and the Snappy path's through
             ``SnappyFrameDecoder``, each restoring its input; then the
             shell entry points, over 64 MiB of the text in a file, each
             in a process of its own (a timeout each): ``examples/
             pigz_clone_torch.py`` at Gzip level 3, BGZF level 6 and
             Snappy (64 threads), each output byte-equal by sha256 to an
             in-process ``ZBuilder`` card run of the same format, level
             and threads with 1 MiB writes, and restored by its decoder;
             ``block_decompress_torch.py`` on the BGZF output with
             ``--backend device`` and with the native default, and
             ``snap_decode_torch.py`` on the Snappy output, each writing
             the input; a fresh interpreter's import of the package, and
             that with a CUDA context, timed; each example's
             ``main(argv)`` also called in this process on 8 MiB (counts
             set to 0 just before, read just after), where the
             compressors must launch their path's kernels, the device
             decode K11, and the host decodes none;
5. result  — one ``kernels`` JSON line, then the last line
             ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib.util
import io
import json
import os
import platform
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Hopper's integer ALU pipe: 64 INT32 lanes per SM per clock (half its 128
# FP32 lanes), 132 SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K8's ALU-pipe instructions per candidate test, from its lag loop's SASS
# (nvcc 12.9, sm_90a; tools/sass_loops.py --kernels suffix_merge): the body
# of 8 lags x 4 slots x 2 directions = 64 tests holds 193 (128 FMNMX, 64
# FSETP, 1 PLOP3) beside 133 on the FMA pipe (128 FADD). Its bound counts
# them per test the inputs need under the exit rule
# (lz_cuda.suffix_merge_work). The parent's kernel, one thread per slot,
# took 81 integer-ALU instructions per 4 lags x 2 directions.
K8_ALU_OPS_PER_TEST = 193 / 64
K8_PARENT_ALU_OPS_PER_TEST = 81 / 8
B, N = 64, 131072
D = 32768  # the stream halo: the 32 KiB dictionary carried from the block before
SNAPPY_N = 65536  # Snappy's block: one frame chunk
PATH_BYTES = 256 << 20
STREAM_PATH_BYTES = 64 << 20  # the Zlib, raw Deflate and Snappy paths
SRC = "gzp_tpu_torch/csrc/"
PALLAS = "gzp_tpu/ops/lz_pallas.py:"
BUILD_LOGS: dict[str, str] = {}  # kernel library -> nvcc output (phase 2)


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


def graph_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    launch overhead between calls does not count (``time_ms`` counts it
    where the host is slower than the card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def max_abs_err(got, want) -> int:
    """Largest difference over every output of a kernel and its plain version."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def hold(name, kernel, plain, args, kwargs, nbytes, nops, source, replaces):
    """Compare kernel and plain version on the same card inputs, time both
    call by call with CUDA events (``ms``, ``plain_ms``), and the kernel
    also by CUDA-graph replay (``graph_ms``)."""
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms = time_ms(lambda: kernel(*args, **kwargs))
    replay_ms = graph_ms(lambda: kernel(*args, **kwargs))
    plain_ms = time_ms(lambda: plain(*args, **kwargs), iters=3, warmup=1)
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / INT32_OPS_PER_S else "operations",
        "library_ms": None, "graph_ms": replay_ms,
    }
    print(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms (graph {replay_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; {nbytes} bytes, "
          f"{nops} ops)", flush=True)
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}")
    return got, row


def check(name, kernel, plain, args, kwargs):
    """Compare kernel and plain version on the same card inputs, untimed;
    returns the kernel's result."""
    got = kernel(*args, **kwargs)
    err = max_abs_err(got, plain(*args, **kwargs))
    print(f"check {name}: max_abs_err {err}", flush=True)
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}")
    return got


def window(fields, payload_bytes, max_match=258, n=N):
    """The tile, window and shared memory of K6 (1 field) or K9 (2)."""
    from gzp_tpu_torch.ops import lz_cuda

    t, e, r = lz_cuda.tail_window(payload_bytes, max_match)
    npad = lz_cuda.padded_len(n)
    print(f"  window: T {t}, E {e}, R {r}; grid ({-(-npad // t)}, {B}); dynamic shared "
          f"memory {lz_cuda.tail_smem_bytes(fields, t, e, r)} B per CTA", flush=True)


def tail_edges(dev):
    """K6 at 8, 12 and 28 context bytes and K9 at 28 on the edge rows, at
    an n that is not a multiple of the tile."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.utils.testing import KINDS, tail_edge_batch

    for fields, pb in ((1, 8), (1, 12), (1, 28), (2, 28)):
        x = tail_edge_batch((KINDS * B)[:B], N - 1000, payload_bytes=pb, seed=pb)
        x = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
        planes = [x["packed_hash"], x["packed_suffix"]][:fields]
        kernel, plain = ((lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain) if fields == 1
                         else (lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain))
        check(f"{'K6' if fields == 1 else 'K9'} tile edges pb={pb} n={N - 1000}", kernel, plain,
              (x["data"], *planes, x["lengths"], x["halo_start"]),
              dict(base=0, payload_bytes=pb, max_match=258, min_emit=3, lazy=pb != 8))


def smem_bytes(library: str, function: str) -> int:
    """Static shared memory per CTA of the compiled function whose mangled
    name contains ``function``, from ptxas's report in phase 2."""
    current = None
    for line in BUILD_LOGS[library].splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
        elif current and function in current and "Used" in line:
            return int(line.split("bytes smem")[0].split(",")[-1]) if "smem" in line else 0
    raise AssertionError(f"no ptxas report for {function} in {library}")


def neighbor_edges(dev):
    """K2 on its halo's edge rows at lags 1, 2, 4 and 127, 1-3 context
    words, at Np = N - 1000 (a ragged last tile, 16-byte loads) and at
    5T + 123 (not a multiple of 4: scalar loads)."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.utils.testing import NEIGHBOR_KINDS, neighbor_edge_batch

    t = lz_cuda.NEIGHBOR_TILE
    for lags in (1, 2, 4, 127):
        for npad, pw in ((N - 1000, 3), (5 * t + 123, 1 + lags % 3)):
            x = neighbor_edge_batch(NEIGHBOR_KINDS * 4, npad, tile=t, lags=lags,
                                    payload_words=pw, max_dist=32768, seed=lags)
            check(f"K2 neighbor edge rows lags={lags} Np={npad} pw={pw}", lz_cuda.neighbor_cuda,
                  lz_cuda.neighbor_plain,
                  tuple(torch.from_numpy(x[k]).to(dev) for k in ("sk", "pays", "halo_start")),
                  dict(pos_bits=x["pos_bits"], lags=lags, max_dist=32768))


def suffix_merge_edges(dev):
    """K8 on its edge rows (all-zero, random, period-3, text, halo_start
    > 0, a best candidate exactly ``lags`` across each tile edge) at lags
    1, 16, 24 and 127 and max_dist 32768 and 100, at 3 1/2 tiles (Np =
    7,168; and 7,165, not a multiple of 4: scalar loads and stores); and
    on a text and a ``zeros_halo`` row of 2^22 slots (the longest on fp32
    keys) and of 2^22 + 5,000 (int32 keys) at lags 16."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.utils.testing import SUFFIX_KINDS, suffix_merge_edge_batch

    plan = lz_cuda.suffix_merge_plan()
    n = 3 * plan["tile"] + 1000
    cases = [(SUFFIX_KINDS, n, lags, npad, (32768, 100)) for lags in (1, 16, 24, 127)
             for npad in (None, lz_cuda.padded_len(n) - 3)]
    cases += [(("text", "zeros_halo"), m, 16, m, (32768,))
              for m in (plan["f32_rows"], plan["f32_rows"] + 5000)]
    for kinds, n, lags, npad, dists in cases:
        x = suffix_merge_edge_batch(kinds, n, lags=lags, tile=plan["tile"], npad=npad,
                                    seed=lags)
        args = tuple(torch.from_numpy(x[k]).to(dev) for k in ("sp", "adj", "halo_start"))
        for max_dist in dists:
            check(f"K8 suffix_merge edge rows lags={lags} Np={args[0].shape[1]} "
                  f"max_dist={max_dist}", lz_cuda.suffix_merge_cuda,
                  lz_cuda.suffix_merge_plain, args,
                  dict(lags=lags, max_dist=max_dist, payload_bytes=28))


def pack_edges(dev, base_bits):
    """K10 on the look-back's edge rows at its tile T: E = 5T + 123 (a
    ragged last tile), 4T (the tail entry first in its tile), T - 37."""
    from gzp_tpu_torch.ops import pack_cuda
    from gzp_tpu_torch.utils.testing import PACK_KINDS, pack_edge_batch

    t = pack_cuda.PACK_TILE
    for e in (5 * t + 123, 4 * t, t - 37):
        bits, nbits = pack_edge_batch(PACK_KINDS * 4, e, tile=t, base_bits=base_bits, seed=e)
        check(f"K10 pack_prescan edge rows E={e} base_bits={base_bits}",
              pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain,
              (torch.from_numpy(bits.view(np.int32)).to(dev), torch.from_numpy(nbits).to(dev),
               base_bits), {})


def members(blob: bytes, fmt_name: str = "Mgzip") -> list[bytes]:
    """Split an Mgzip or BGZF stream into members by their size fields."""
    import gzp_tpu_torch

    fmt = getattr(gzp_tpu_torch, fmt_name)
    out, pos = [], 0
    while pos < len(blob):
        size = fmt.get_block_size(blob[pos: pos + fmt.header_size])
        out.append(blob[pos: pos + size])
        pos += size
    return out


def level3_kernels(data, lengths, halo):
    """K1, K2, K3's function, K6 and K10 at level 3's config, and the
    level-3 stage split. Returns {id: row}."""
    from gzp_tpu_torch.ops import deflate_kernel as dk
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda
    from gzp_tpu_torch.ops.lz import _pos_bits

    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    pw, lags, pos_bits = cfg.payload_words, cfg.lags, _pos_bits(N)
    npad = lz_cuda.padded_len(N)
    rows = {}
    (key, pays), rows["K1"] = hold(
        "K1 build_keys", lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, (data,),
        dict(pos_bits=pos_bits, payload_words=pw),
        nbytes=B * N + (1 + pw) * B * npad * 4, nops=B * npad * (7 * pw + 4),
        source=SRC + "build_keys.cu", replaces=PALLAS + "121",
    )
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(pw, -1, -1))
    nb_k2 = B * npad * (8 + 4 * pw) + 4 * B + 2 * B * npad * 4
    (sp, packed), rows["K2"] = hold(
        "K2 neighbor", lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain, (sk, spays, halo),
        dict(pos_bits=pos_bits, lags=lags, max_dist=32768),
        nbytes=nb_k2, nops=B * npad * lags * (10 + 4 * pw),
        source=SRC + "neighbor.cu", replaces=PALLAS + "194",
    )
    # K3's function: the same kernel at lags = 4 (on no path: no level uses
    # lags > 2 with at most 3 context words)
    _, rows["K3"] = hold(
        "K3 neighbor lags=4", lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain,
        (sk, spays, halo), dict(pos_bits=pos_bits, lags=4, max_dist=32768),
        nbytes=nb_k2, nops=B * npad * 4 * (10 + 4 * pw),
        source=SRC + "neighbor.cu", replaces=PALLAS + "256",
    )
    t = lz_cuda.NEIGHBOR_TILE
    for lg in (lags, 4):
        halo_bytes = B * -(-npad // t) * lg * (8 + 4 * pw)
        print(f"  K2 plan at lags {lg}: T {t} slots per CTA of 256 threads ({t // 256} each); grid "
              f"({-(-npad // t)}, {B}); halo {lg} slots per tile, re-read {halo_bytes} B "
              f"({halo_bytes / (B * npad * (8 + 4 * pw)):.4f} of the input, beside the bound); "
              f"dynamic shared memory {lz_cuda.neighbor_smem_bytes(pw, lg)} B per CTA",
              flush=True)
    neighbor_edges(data.device)
    packed_pos = torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)
    (ml, md), rows["K6"] = hold(
        "K6 match_tail", lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
        (data, packed_pos, lengths, halo),
        dict(base=0, payload_bytes=4 * pw, max_match=258, min_emit=3, lazy=True),
        nbytes=B * N + B * npad * 4 + 8 * B + 2 * B * N * 4, nops=B * npad * 90,
        source=SRC + "match_tail.cu", replaces=PALLAS + "472",
    )
    window(1, 4 * pw)
    # K6 at level 1's 8 context bytes: its widest window (E = 505)
    cfg1 = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 1)
    packed1 = lz_cuda.hash_pass(data, halo, payload_words=cfg1.payload_words, lags=cfg1.lags,
                                max_dist=32768)
    check("K6 match_tail pw=2 (level 1)", lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
          (data, packed1, lengths, halo), dict(base=0, payload_bytes=4 * cfg1.payload_words,
                                               max_match=258, min_emit=3, lazy=cfg1.lazy))
    window(1, 4 * cfg1.payload_words)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    all_bits, all_n = dk.block_entries(cfg, data, marked, ln, md)
    e = all_bits.shape[1]
    ep = pack_cuda.prescan_len(e)
    _, rows["K10"] = hold(
        "K10 pack_prescan", pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain,
        (all_bits, all_n, 8 * cfg.header_len), {},
        nbytes=2 * B * e * 4 + 2 * B * ep * 4 + 4 * B, nops=B * ep * 50,
        source=SRC + "pack_prescan.cu", replaces="gzp_tpu/ops/pack_pallas.py:65",
    )
    t = pack_cuda.PACK_TILE
    tiles, words = pack_cuda.prescan_plan(B, e)
    print(f"  plan: E {e}, Ep {ep}; T {t} entries per CTA of {t // 8} threads; grid "
          f"{B * tiles} ({tiles} tiles per row x {B}); scratch {8 * words} B (status words + "
          f"counter, zeroed per call); static shared memory "
          f"{smem_bytes('pack_prescan', 'pack_prescan_kernel')} B per CTA",
          flush=True)
    for base_bits in (0, 144, 160):
        pack_edges(data.device, base_bits)

    # where one batch's device time goes, stage by stage (CUDA events)
    words_args = (all_bits, all_n, 8 * cfg.header_len, cfg.out_words)
    encode = dk.get_encoder(cfg)
    finals = torch.zeros((B,), dtype=torch.bool, device=data.device)  # members ignore it
    stages = {
        "match": time_ms(lambda: dk.match_stage(cfg, data, lengths), iters=5),
        "match.hash_pass": time_ms(lambda: lz_cuda.hash_pass(
            data, halo, payload_words=pw, lags=lags, max_dist=32768), iters=5),
        "match.tail": time_ms(lambda: lz_cuda.match_tail_cuda(
            data, packed_pos, lengths, halo, base=0, payload_bytes=4 * pw, max_match=258,
            min_emit=3, lazy=True), iters=5),
        "parse": time_ms(lambda: dk.parse_stage(cfg, ml, lengths), iters=5),
        "entries": time_ms(lambda: dk.block_entries(cfg, data, marked, ln, md), iters=5),
        "pack": time_ms(lambda: pack_cuda.pack_entries_sortscan_cuda(*words_args), iters=5),
        "crc32": time_ms(lambda: dk.crc32_device(data, lengths), iters=5),
        "encode": time_ms(lambda: encode(data, lengths, finals), iters=5),
    }
    print("stages ms per 64x128KiB batch: " + json.dumps(stages), flush=True)
    return rows


def level6_kernels(data, lengths, halo):
    """K7, K4, K8, K1, K5 and K9 at level 6's config (K8 also at level 9's
    24 lags, K4 + K5 also against K2's plain version at 7 words), and the
    level-6 stage split. Returns {id: row}."""
    from gzp_tpu_torch.ops import deflate_kernel as dk
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda
    from gzp_tpu_torch.ops.lz import _pos_bits

    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 6)
    pw, lags, skw, pos_bits = cfg.payload_words, cfg.lags, cfg.suffix_keys, _pos_bits(N)
    assert (pw, lags, skw, cfg.matcher) == (7, 16, 5, "suffix"), cfg
    npad = lz_cuda.padded_len(N)
    slots = B * npad
    rows = {}
    (keys, pos), rows["K7"] = hold(
        "K7 build_suffix_keys", lz_cuda.build_suffix_keys_cuda,
        lz_cuda.build_suffix_keys_plain, (data,), dict(payload_words=pw),
        nbytes=B * N + (pw + 1) * slots * 4, nops=slots * (8 * pw + 2),
        source=SRC + "build_suffix_keys.cu", replaces=PALLAS + "616",
    )
    order = lz_cuda.suffix_order(keys, pos, skw)
    skeys = torch.gather(keys, 2, order.expand(pw, -1, -1))
    sp = torch.gather(pos, 1, order)

    def lcp_words(lcp):
        """Words each slot compares per lag: up to its first difference."""
        return torch.clamp(lcp.to(torch.int64) // 4 + 1, max=pw)

    def lcp_bytes(lcp):
        """Bytes K4 must move for these inputs, all lags in one launch: each
        slot's words once, up to the deepest first difference from its
        neighbours over the lags, and one output word per lag."""
        return int(4 * (lcp_words(lcp).amax(dim=0).sum() + lcp.numel()))

    def lcp_bytes_per_lag(lcp):
        """The count of one launch per lag: each lag's words up to its first
        difference, read once per lag."""
        return int(4 * (lcp_words(lcp).sum() + lcp.numel()))

    def lcp_ops(lcp):
        """About 8 integer operations per word compared, per lag."""
        return int(8 * lcp_words(lcp).sum())

    def lcp_sector_bytes(lcp):
        """The same in whole 32-byte sectors, the unit device memory moves:
        a plane's sector of 8 slots is read if any of them needs it."""
        depth = lcp_words(lcp).amax(dim=0).view(B, -1, 8).amax(dim=-1)
        return int(32 * depth.sum() + 4 * lcp.numel())

    print(f"  K4 plan: T {lz_cuda.LCP_TILE} slots per CTA of 256 threads (4 each); grid "
          f"({-(-npad // lz_cuda.LCP_TILE)}, {B}); one launch for every lag; scratch 0 B; "
          f"static shared memory {smem_bytes('lcp_lags', f'lcp_lags_kernelILi{pw}ELb1E')} B "
          f"per CTA", flush=True)
    adj_want = lz_cuda.lcp_lags_plain(skeys, 1, big_endian=True)
    print(f"  K4 big-endian lag 1 bytes: {lcp_bytes(adj_want)} needed; "
          f"{lcp_sector_bytes(adj_want)} in whole 32-byte sectors", flush=True)
    adj3, rows["K4"] = hold(
        "K4 lcp_lags big-endian lag 1", lz_cuda.lcp_lags_cuda, lz_cuda.lcp_lags_plain,
        (skeys, 1), dict(big_endian=True),
        nbytes=lcp_bytes(adj_want), nops=lcp_ops(adj_want),
        source=SRC + "lcp_lags.cu", replaces=PALLAS + "315",
    )
    adj = adj3[0]
    merge_bytes = 2 * slots * 4 + 4 * B + slots * 4
    plan = lz_cuda.suffix_merge_plan()
    t = plan["tile"]
    for lg, name in ((lags, "K8 suffix_merge lags=16"), (24, "K8 suffix_merge lags=24 (level 9)")):
        kw = dict(lags=lg, max_dist=32768, payload_bytes=4 * pw)
        tests = int(lz_cuda.suffix_merge_work(sp, adj, halo, **kw).sum())
        print(f"  K8 plan at lags {lg}: T {t} slots per CTA of 256 threads ({t // 1024} runs of 4 "
              f"consecutive slots each); grid ({-(-npad // t)}, {B}); halo {-(-lg // 32) * 32} "
              f"slots on each side; dynamic shared memory {plan['smem_bytes']} B per CTA; "
              f"fp32 keys (rows up to {plan['f32_rows']} slots); {tests} candidate tests needed under the exit rule, "
              f"{tests / (2 * lg * slots):.4f} of 2 x lags per slot", flush=True)
        got, row = hold(name, lz_cuda.suffix_merge_cuda, lz_cuda.suffix_merge_plain,
                        (sp, adj, halo), kw, nbytes=merge_bytes,
                        nops=int(tests * K8_ALU_OPS_PER_TEST),
                        source=SRC + "suffix_merge.cu", replaces=PALLAS + "697")
        row["tests_needed"] = tests
        parent_s = tests * K8_PARENT_ALU_OPS_PER_TEST / INT32_OPS_PER_S
        print(f"  K8 bound at lags {lg}: {tests} tests x {K8_ALU_OPS_PER_TEST:.4f} ALU "
              f"instructions per test (this kernel's SASS) -> {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, the kernel at {row['bound_ms'] / row['ms']:.4f} of it; at the "
              f"parent kernel's {K8_PARENT_ALU_OPS_PER_TEST:.4f} per test "
              f"{max(parent_s, merge_bytes / HBM_BYTES_PER_S) * 1e3:.4f} ms", flush=True)
        if lg == lags:
            packed_s, rows["K8"] = got, row
    suffix_merge_edges(data.device)
    packed_s_pos = lz_cuda.restore_order(sp, packed_s)

    (key, pays), _ = hold(
        "K1 build_keys pw=7", lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, (data,),
        dict(pos_bits=pos_bits, payload_words=pw),
        nbytes=B * N + (1 + pw) * slots * 4, nops=slots * (7 * pw + 4),
        source=SRC + "build_keys.cu", replaces=PALLAS + "121",
    )
    sk, horder = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, horder.expand(pw, -1, -1))
    lcp_le_want = lz_cuda.lcp_lags_plain(spays, 2, big_endian=False)
    print(f"  K4 little-endian lags 1-2 bytes: {lcp_bytes(lcp_le_want)} needed in one launch "
          f"(read once per lag: {lcp_bytes_per_lag(lcp_le_want)}); "
          f"{lcp_sector_bytes(lcp_le_want)} in whole 32-byte sectors", flush=True)
    lcps, _ = hold(
        "K4 lcp_lags little-endian lags 1-2 (one launch)", lz_cuda.lcp_lags_cuda,
        lz_cuda.lcp_lags_plain, (spays, 2), dict(big_endian=False),
        nbytes=lcp_bytes(lcp_le_want), nops=lcp_ops(lcp_le_want),
        source=SRC + "lcp_lags.cu", replaces=PALLAS + "315",
    )
    (sp_h, packed_h), rows["K5"] = hold(
        "K5 hash_merge", lz_cuda.hash_merge_cuda, lz_cuda.hash_merge_plain,
        (sk, lcps, halo), dict(pos_bits=pos_bits, max_dist=32768, payload_bytes=4 * pw),
        nbytes=slots * 8 + 2 * slots * 4 + 4 * B + 2 * slots * 4, nops=slots * 2 * 15,
        source=SRC + "hash_merge.cu", replaces=PALLAS + "334",
    )
    # K4 + K5 (the 7-word route of neighbor_cuda) computes K2's function
    cross = lz_cuda.neighbor_plain(sk, spays, halo, pos_bits=pos_bits, lags=2, max_dist=32768)
    err = max_abs_err((sp_h, packed_h), cross)
    print(f"check K4 + K5 vs neighbor_plain at pw=7: max_abs_err {err}", flush=True)
    if err != 0:
        raise AssertionError("K4 + K5 disagree with K2's plain version at pw=7")
    packed_h_pos = lz_cuda.restore_order(sp_h, packed_h)
    (ml, md), rows["K9"] = hold(
        "K9 match_tail2", lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain,
        (data, packed_h_pos, packed_s_pos, lengths, halo),
        dict(base=0, payload_bytes=4 * pw, max_match=258, min_emit=3, lazy=True),
        nbytes=B * N + 2 * slots * 4 + 8 * B + 2 * B * N * 4, nops=slots * 140,
        source=SRC + "match_tail2.cu", replaces=PALLAS + "797",
    )
    window(2, 4 * pw)

    marked, ln = dk.parse_stage(cfg, ml, lengths)
    all_bits, all_n = dk.block_entries(cfg, data, marked, ln, md)
    words_args = (all_bits, all_n, 8 * cfg.header_len, cfg.out_words)
    encode = dk.get_encoder(cfg)
    finals = torch.zeros((B,), dtype=torch.bool, device=data.device)  # members ignore it
    stages = {
        "match": time_ms(lambda: dk.match_stage(cfg, data, lengths), iters=5),
        "match.suffix_pass": time_ms(lambda: lz_cuda.suffix_pass(
            data, halo, payload_words=pw, lags=lags, suffix_keys=skw, max_dist=32768), iters=5),
        "match.content_sort": time_ms(lambda: lz_cuda.suffix_order(keys, pos, skw), iters=5),
        "match.hash_pass": time_ms(lambda: lz_cuda.hash_pass(
            data, halo, payload_words=pw, lags=2, max_dist=32768), iters=5),
        "match.tail": time_ms(lambda: lz_cuda.match_tail2_cuda(
            data, packed_h_pos, packed_s_pos, lengths, halo, base=0, payload_bytes=4 * pw,
            max_match=258, min_emit=3, lazy=True), iters=5),
        "parse": time_ms(lambda: dk.parse_stage(cfg, ml, lengths), iters=5),
        "entries": time_ms(lambda: dk.block_entries(cfg, data, marked, ln, md), iters=5),
        "pack": time_ms(lambda: pack_cuda.pack_entries_sortscan_cuda(*words_args), iters=5),
        "crc32": time_ms(lambda: dk.crc32_device(data, lengths), iters=5),
        "encode": time_ms(lambda: encode(data, lengths, finals), iters=5),
    }
    print("stages ms per 64x128KiB batch, level 6: " + json.dumps(stages), flush=True)
    return rows


def make_halo(arr, lengths):
    """The halos the writer builds for a batch with no carry
    (``parallel/compress.py``'s ``make_halo``): row i gets the last D bytes
    of row i - 1, right-aligned; row 0 none (so its halo_start is D)."""
    from gzp_tpu_torch.parallel.compress import make_halo as writer_halo

    return writer_halo(arr, lengths, b"", D)


def hash_checks(tag, data, lengths, hs, *, base, pw, lags, max_dist, max_match, min_emit,
                lazy):
    """K1, K2 and K6 of the hash matcher, each held against its plain
    version (untimed); returns K6's (match_len, match_dist)."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.ops.lz import _pos_bits

    pos_bits = _pos_bits(data.shape[1])
    key, pays = check(f"K1 build_keys {tag} (pos_bits {pos_bits})", lz_cuda.build_keys_cuda,
                      lz_cuda.build_keys_plain, (data,), dict(pos_bits=pos_bits, payload_words=pw))
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(pw, -1, -1))
    sp, packed = check(f"K2 neighbor {tag} (max_dist {max_dist})", lz_cuda.neighbor_cuda,
                       lz_cuda.neighbor_plain, (sk, spays, hs),
                       dict(pos_bits=pos_bits, lags=lags, max_dist=max_dist))
    return check(f"K6 match_tail {tag} (base {base}, max_match {max_match}, min_emit {min_emit})",
                 lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
                 (data, lz_cuda.restore_order(sp, packed), lengths, hs),
                 dict(base=base, payload_bytes=4 * pw, max_match=max_match, min_emit=min_emit,
                      lazy=lazy))


def suffix_checks(tag, data, lengths, hs, *, base, pw, lags, skw):
    """K7, K4, K8, K1, K4, K5 and K9 of the suffix matcher, each held
    against its plain version (untimed); returns K9's (match_len,
    match_dist)."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.ops.lz import _pos_bits

    keys, pos = check(f"K7 build_suffix_keys {tag}", lz_cuda.build_suffix_keys_cuda,
                      lz_cuda.build_suffix_keys_plain, (data,), dict(payload_words=pw))
    order = lz_cuda.suffix_order(keys, pos, skw)
    skeys = torch.gather(keys, 2, order.expand(pw, -1, -1))
    sp = torch.gather(pos, 1, order)
    adj = check(f"K4 lcp_lags big-endian lag 1 {tag}", lz_cuda.lcp_lags_cuda,
                lz_cuda.lcp_lags_plain, (skeys, 1), dict(big_endian=True))[0]
    packed_s = check(f"K8 suffix_merge lags={lags} {tag}", lz_cuda.suffix_merge_cuda,
                     lz_cuda.suffix_merge_plain, (sp, adj, hs),
                     dict(lags=lags, max_dist=32768, payload_bytes=4 * pw))
    pos_bits = _pos_bits(data.shape[1])
    key, pays = check(f"K1 build_keys pw={pw} {tag} (pos_bits {pos_bits})",
                      lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, (data,),
                      dict(pos_bits=pos_bits, payload_words=pw))
    sk, horder = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, horder.expand(pw, -1, -1))
    lcps = check(f"K4 lcp_lags little-endian lags 1-2 {tag}", lz_cuda.lcp_lags_cuda,
                 lz_cuda.lcp_lags_plain, (spays, 2), dict(big_endian=False))
    sp_h, packed_h = check(f"K5 hash_merge {tag}", lz_cuda.hash_merge_cuda,
                           lz_cuda.hash_merge_plain, (sk, lcps, hs),
                           dict(pos_bits=pos_bits, max_dist=32768, payload_bytes=4 * pw))
    return check(f"K9 match_tail2 {tag} (base {base})", lz_cuda.match_tail2_cuda,
                 lz_cuda.match_tail2_plain,
                 (data, lz_cuda.restore_order(sp_h, packed_h), lz_cuda.restore_order(sp, packed_s),
                  lengths, hs),
                 dict(base=base, payload_bytes=4 * pw, max_match=258, min_emit=3, lazy=True))


def stream_checks(text, dev):
    """Phase 3 at the stream and Snappy shapes, held but not timed: K1, K2,
    K6 and K10 at Gzip level 3's stream shape ([halo, data] [64, 163840],
    base 32768, halos as the writer builds them; a full batch and one with
    a ragged last row), K7, K4, K8, K1, K5, K9 and K10 at level 6's, K1,
    K2, K6 and K10 at Snappy's ([64, 65536], max_dist 65535, max_match
    256, min_emit 4, 144 header bits); then the Gzip level-3 stream batch's
    stage split."""
    from gzp_tpu_torch.ops import checksum, lz_cuda, pack_cuda
    from gzp_tpu_torch.ops import deflate_kernel as dk
    from gzp_tpu_torch.ops import snappy_kernel as snk

    cfg3 = dk.DeflateEncodeConfig.for_level(N, "stream", "crc32", 3, dict_size=D)
    cfg6 = dk.DeflateEncodeConfig.for_level(N, "stream", "crc32", 6, dict_size=D)
    for ragged in (False, True):
        arr = text.copy()
        lengths = np.full(B, N, np.int32)
        if ragged:
            lengths[-1] = N - 12345
            arr[-1, lengths[-1]:] = 0
        halo, dict_lens = make_halo(arr, lengths)
        data, ln, halo, dict_lens = (torch.from_numpy(x).to(dev)
                                     for x in (arr, lengths, halo, dict_lens))
        ext = torch.cat([halo, data], dim=1)
        hs = (D - dict_lens).to(torch.int32)
        finals = torch.zeros((B,), dtype=torch.bool, device=dev)
        finals[-1] = ragged
        tag = f"stream {'ragged' if ragged else 'full'}"
        ml, md = hash_checks(f"{tag} level 3", ext, ln, hs, base=D, pw=cfg3.payload_words,
                             lags=cfg3.lags, max_dist=32768, max_match=258, min_emit=3,
                             lazy=True)
        marked, l = dk.parse_stage(cfg3, ml, ln)
        bits, nbits = dk.block_entries(cfg3, ext, marked, l, md, finals)
        check(f"K10 pack_prescan {tag} level 3 (E {bits.shape[1]})", pack_cuda.pack_prescan_cuda,
              pack_cuda.pack_prescan_plain, (bits, nbits, 0), {})
        if ragged:
            continue
        ml6, md6 = suffix_checks(f"{tag} level 6", ext, ln, hs, base=D, pw=cfg6.payload_words,
                                 lags=cfg6.lags, skw=cfg6.suffix_keys)
        marked6, l6 = dk.parse_stage(cfg6, ml6, ln)
        bits6, nbits6 = dk.block_entries(cfg6, ext, marked6, l6, md6, finals)
        check(f"K10 pack_prescan {tag} level 6 (E {bits6.shape[1]})",
              pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain, (bits6, nbits6, 0), {})
        window(1, 4 * cfg3.payload_words, n=D + N)
        window(2, 4 * cfg6.payload_words, n=D + N)

        # where one stream batch's device time goes (CUDA events)
        encode = dk.get_encoder(cfg3)
        words_args = (bits, nbits, 0, cfg3.out_words)
        stages = {
            "match": time_ms(lambda: dk.match_stage(cfg3, data, ln, halo, dict_lens), iters=5),
            "parse": time_ms(lambda: dk.parse_stage(cfg3, ml, ln), iters=5),
            "entries": time_ms(lambda: dk.block_entries(cfg3, ext, marked, l, md, finals),
                               iters=5),
            "pack": time_ms(lambda: pack_cuda.pack_entries_sortscan_cuda(*words_args), iters=5),
            "checksum": time_ms(lambda: checksum.crc32_device(data, ln), iters=5),
            "encode": time_ms(lambda: encode(data, ln, finals, halo, dict_lens), iters=5),
        }
        print("stages ms per 64x128KiB stream batch, Gzip level 3 (ext 64x160KiB): "
              + json.dumps(stages), flush=True)

    sn = SNAPPY_N
    arr = text[:, :sn].copy()
    lengths = np.full(B, sn, np.int32)
    lengths[-1] = sn - 999
    arr[-1, lengths[-1]:] = 0
    data, ln = torch.from_numpy(arr).to(dev), torch.from_numpy(lengths).to(dev)
    cfg = snk.SnappyEncodeConfig(block_len=sn)
    hs = torch.zeros((B,), dtype=torch.int32, device=dev)
    ml, md = hash_checks("snappy", data, ln, hs, base=0, pw=cfg.payload_words, lags=cfg.lags,
                         max_dist=sn - 1, max_match=cfg.max_match, min_emit=4, lazy=False)
    bits, nbits = snk.snappy_entries(cfg, data, ln, ml, md)
    check(f"K10 pack_prescan snappy (E {bits.shape[1]}, base_bits {snk.HEADER_BITS})",
          pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain,
          (bits, nbits, snk.HEADER_BITS), {})
    window(1, 4 * cfg.payload_words, max_match=cfg.max_match, n=sn)
    dists = md[ml > 0]
    print(f"  snappy matches: {int((ml > 0).sum())}, longest distance {int(dists.max())}, "
          f"{int((dists > 32768).sum())} beyond 32768", flush=True)


def drive(level, corpus, kernels, smi):
    """The main path at ``level``: every count set to 0 just before, read
    just after. Returns ({kernel name: launches}, the Mgzip stream, its
    seconds)."""
    from gzp_tpu_torch import Mgzip, ZBuilder
    from gzp_tpu_torch.runtime import cuda_lib

    def compress(blob: bytes, threads: int = B, device=None) -> bytes:
        buf = io.BytesIO()
        w = (ZBuilder(Mgzip).num_threads(threads).compression_level(level).device(device)
             .from_writer(buf))
        w.write(blob)
        w.finish()
        return buf.getvalue()

    compress(corpus[: B * N])  # warm-up: allocator, pinned buffers
    torch.cuda.synchronize()
    for k in cuda_lib.counts():
        k.launches = 0
    t0 = time.perf_counter()
    out = compress(corpus)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_lib.counts()}
    print(f"path level {level}: launches {json.dumps(launches)}", flush=True)
    missing = [k.name for k in kernels if launches[k.name] <= 0]
    if missing:
        raise AssertionError(f"level {level}: kernels of the path never launched: {missing}")
    if gzip.decompress(out) != corpus:
        raise AssertionError(f"level {level}: gzip.decompress does not restore the input")
    card = members(out)
    cpu = members(compress(corpus[: 4 * N], threads=4, device="cpu"))
    if card[:4] != cpu:
        raise AssertionError(f"level {level}: card members differ from the CPU run's "
                             "on the first 4 blocks")
    zsize = sum(len(zlib.compress(corpus[i: i + N], level)) for i in range(0, len(corpus), N))
    gbps = len(corpus) / secs / 1e9
    print(f"path level {level}: {len(corpus)} B -> {len(out)} B, ratio "
          f"{len(corpus) / len(out):.4f}, size vs zlib-{level} per 128 KiB block "
          f"{len(out) / zsize:.4f}; sha256 {hashlib.sha256(out).hexdigest()}; first 4 members "
          f"equal the CPU run's; {secs:.3f} s = "
          f"{gbps:.4f} GB/s end to end on {smi}", flush=True)
    if level >= 6 and len(out) > zsize:
        raise AssertionError(f"level {level}: {len(out)} B exceeds zlib's {zsize} B")
    return launches, out, secs


def drive_mesh(level, corpus, kernels, smi, want_sha, one_secs):
    """The mesh path at ``level``: ``ZBuilder(Mgzip).num_threads(64).mesh(
    mesh_devices(2))`` (two cards where the machine has two, else the one
    card twice), every count set to 0 just before, read just after.
    Its stream must be the one-device stream of phase 4 (``want_sha``, its
    sha256) and every kernel of the level's path must have been launched."""
    from gzp_tpu_torch import Mgzip, ZBuilder
    from gzp_tpu_torch.parallel.mesh import mesh_devices
    from gzp_tpu_torch.runtime import cuda_lib

    devs = mesh_devices(2)

    def compress(blob: bytes):
        buf = io.BytesIO()
        w = ZBuilder(Mgzip).num_threads(B).compression_level(level).mesh(devs).from_writer(buf)
        w.write(blob)
        w.finish()
        return buf.getvalue(), w

    compress(corpus[: B * N])  # warm-up: allocator, pinned buffers
    for d in set(devs):
        torch.cuda.synchronize(d)
    for k in cuda_lib.counts():
        k.launches = 0
    t0 = time.perf_counter()
    out, w = compress(corpus)
    for d in set(devs):
        torch.cuda.synchronize(d)
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_lib.counts()}
    print(f"mesh level {level}: launches {json.dumps(launches)}", flush=True)
    missing = [k.name for k in kernels if launches[k.name] <= 0]
    if missing:
        raise AssertionError(f"mesh level {level}: kernels of the path never launched: {missing}")
    if hashlib.sha256(out).hexdigest() != want_sha:
        raise AssertionError(f"mesh level {level}: the stream differs from the one-device "
                             "stream of the same level")
    batches = -(-len(corpus) // (w.batch * w.block_size))
    print(f"mesh level {level} over {', '.join(map(str, devs))}: {len(corpus)} B -> {len(out)} B, "
          f"sha256 equal to the one-device stream; {batches} batches of {w.batch} blocks = "
          f"{batches * len(devs)} sub-batches of {w.batch // len(devs)}; {secs:.3f} s = "
          f"{len(corpus) / secs / 1e9:.4f} GB/s end to end ({one_secs / secs:.4f}x the one-device "
          f"path's {len(corpus) / one_secs / 1e9:.4f} GB/s in this run) on {smi}", flush=True)
    return launches


WORKER_TIMEOUT = 600  # seconds for the two worker processes together


def drive_multihost(data, smi):
    """Two processes of ``python -m gzp_tpu_torch.parallel.multihost``
    (Gzip, level 3, 64 threads, each on ``cuda:<rank mod devices>``) over
    ``data`` in a temporary file; the parent stitches their shards. The
    stitched stream must restore the input and equal a one-process
    ``ZBuilder(Gzip)`` card run byte for byte, and each worker must report
    K1, K2, K6 and K10 launched. A worker that fails or outlasts
    WORKER_TIMEOUT fails the run (both are killed). Returns each worker's
    report."""
    import socket
    import tempfile

    from gzp_tpu_torch import Gzip, ZBuilder
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda
    from gzp_tpu_torch.parallel.multihost import ShardResult, stitch_shards

    want = [k.name for k in (lz_cuda.BUILD_KEYS, lz_cuda.NEIGHBOR, lz_cuda.MATCH_TAIL,
                             pack_cuda.PACK_PRESCAN)]  # K1, K2, K6, K10
    # ``data`` must be a whole number of batches for one process and for each
    # rank: then both streams close with an empty final block (a stream that
    # ends mid-batch marks its last block final instead, in gzp_tpu too)
    if len(data) % (2 * B * N):
        raise ValueError(f"{len(data)} B is not a whole number of batches per rank")
    torch.cuda.empty_cache()  # the workers hold CUDA contexts of their own on the card
    with tempfile.TemporaryDirectory() as tmp:
        inp = Path(tmp) / "input.bin"
        inp.write_bytes(data)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs, outs = [], []
        for rank in range(2):
            outs.append(Path(tmp) / f"shard{rank}.bin")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gzp_tpu_torch.parallel.multihost",
                 "--coordinator", f"localhost:{port}", "--num-processes", "2",
                 "--rank", str(rank), "--format", "gzip", "--level", "3",
                 "--num-threads", str(B), "--input", str(inp), "--output", str(outs[-1])],
                cwd=Path(__file__).resolve().parent,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        try:
            deadline = time.monotonic() + WORKER_TIMEOUT
            results = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                       for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for rank, (p, (out, err)) in enumerate(zip(procs, results)):
            if p.returncode != 0:
                raise AssertionError(f"worker {rank} exited with {p.returncode}:\n{out}\n{err}")
        reports = [json.loads(out.strip().splitlines()[-1]) for out, _ in results]
        for r in reports:
            print(f"multihost worker {r['rank']} on {r['device']}: {r['seconds']:.3f} s, "
                  f"launches {json.dumps(r['launches'])}", flush=True)
            missing = [k for k in want if r["launches"][k] <= 0]
            if missing or not r["device"].startswith("cuda"):
                raise AssertionError(f"worker {r['rank']} on {r['device']}: kernels never "
                                     f"launched: {missing}")
        t1 = time.perf_counter()
        buf = io.BytesIO()
        stitch_shards(Gzip, [ShardResult.from_bytes(o.read_bytes()) for o in outs], buf)
        stitch = time.perf_counter() - t1
    got = buf.getvalue()
    if gzip.decompress(got) != data:
        raise AssertionError("multihost: the stitched stream does not restore the input")
    t1 = time.perf_counter()
    one = io.BytesIO()
    w = ZBuilder(Gzip).num_threads(B).compression_level(3).from_writer(one)
    w.write(data)
    w.finish()
    one_secs = time.perf_counter() - t1
    if got != one.getvalue():
        raise AssertionError("multihost: the stitched stream differs from a one-process run")
    inner = max(r["seconds"] for r in reports) + stitch
    print(f"multihost Gzip level 3, 2 processes: {len(data)} B -> {len(got)} B, restored, equal to "
          f"the one-process stream; {wall + stitch:.3f} s = {len(data) / (wall + stitch) / 1e9:.4f}"
          f" GB/s with process start, {inner:.3f} s = {len(data) / inner / 1e9:.4f} GB/s without "
          f"(the slower worker's compression and the stitch, {stitch:.3f} s); one process "
          f"{one_secs:.3f} s = {len(data) / one_secs / 1e9:.4f} GB/s; on {smi}", flush=True)
    return reports


def drive_stream(name, fmt, level, corpus, kernels, smi, wbits, flush_at=None):
    """A stream path through ``ZBuilder(fmt)`` at ``level`` on the card, 64
    threads: every count set to 0 just before, read just after. Checks that
    the format's decoder restores the input, that every kernel of the path
    was launched, and that the first 8 blocks and a 1,000-byte tail written
    with 4 threads (two batches: the halo crosses a batch boundary) equal
    the CPU run's bytes; prints the size (against one whole zlib stream at
    the same level, or Snappy's ratio) and GB/s. Returns ({kernel name:
    launches}, the stream)."""
    from gzp_tpu_torch import ZBuilder
    from gzp_tpu_torch.runtime import cuda_lib
    from gzp_tpu_torch.utils.snappy_ref import decode_frames

    block = SNAPPY_N if wbits is None else N

    def compress(blob, threads=B, device=None, cut=None):
        buf = io.BytesIO()
        w = ZBuilder(fmt).num_threads(threads).compression_level(level).device(device).from_writer(
            buf)
        if cut is None:
            w.write(blob)
        else:  # a partial block and a sync-flush trailer mid-stream
            w.write(blob[:cut])
            w.flush()
            w.write(blob[cut:])
        w.finish()
        return buf.getvalue()

    compress(corpus[: B * block])  # warm-up: allocator, pinned buffers
    torch.cuda.synchronize()
    for k in cuda_lib.counts():
        k.launches = 0
    t0 = time.perf_counter()
    out = compress(corpus, cut=flush_at)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_lib.counts()}
    print(f"path {name}: launches {json.dumps(launches)}", flush=True)
    missing = [k.name for k in kernels if launches[k.name] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels of the path never launched: {missing}")
    if wbits is None:
        restored = decode_frames(out)
    else:
        d = zlib.decompressobj(wbits)  # 31 gzip, 15 zlib, -15 raw deflate
        restored = d.decompress(out) + d.flush()
        if not d.eof or d.unused_data:
            raise AssertionError(f"{name}: the stream does not end where the output does")
    if restored != corpus:
        raise AssertionError(f"{name}: the decoder does not restore the input")
    head = corpus[: 8 * block + 1000]
    if compress(head, threads=4) != compress(head, threads=4, device="cpu"):
        raise AssertionError(f"{name}: the card's stream differs from the CPU run's on the "
                             "first 8 blocks and the tail")
    if wbits is None:
        size = f"ratio {len(corpus) / len(out):.4f}"
    else:
        z = zlib.compressobj(level, zlib.DEFLATED, wbits)
        zsize = len(z.compress(corpus) + z.flush())
        size = (f"ratio {len(corpus) / len(out):.4f}, size vs one zlib stream at level {level} "
                f"{len(out) / zsize:.4f}")
    cut = f", flush() after {flush_at} B" if flush_at is not None else ""
    print(f"path {name}: {len(corpus)} B -> {len(out)} B{cut}, {size}; sha256 "
          f"{hashlib.sha256(out).hexdigest()}; restored by its decoder; "
          f"first 8 blocks + 1000 B equal the CPU run's; {secs:.3f} s = "
          f"{len(corpus) / secs / 1e9:.4f} GB/s end to end on {smi}", flush=True)
    # the host folds each block's checksum into the stream's (pigz COMB)
    check = fmt.create_check()
    t0 = time.perf_counter()
    for _ in range(20):
        check.combine(fmt.check_cls.from_sum(0x12345678, block))
    per_block = (time.perf_counter() - t0) / 20
    blocks = -(-len(corpus) // block)
    print(f"path {name}: host {fmt.check_cls.__name__}.combine {per_block * 1e3:.4f} ms per "
          f"block, {per_block * blocks:.3f} s for the path's {blocks} blocks", flush=True)
    return launches, out


# K11's function needs, per literal/length symbol of a table-driven decode,
# the peek (shift and mask: 2), the table lookup (1) and the advance (1),
# and for a match its length's extra bits (shift, mask, add: 3), the
# distance code's peek, lookup and advance (4) and its extra bits (3): 14
# operations, counted here for every symbol as if each were a match (the
# plain version counts symbols, not matches), so an upper estimate
K11_OPS_PER_SYMBOL = 14
# K11's floor: each stream is one chain of dependent symbol decodes, so no
# design of its one-stream-per-warp decode beats the longest row's symbols
# times one table-lookup step (a shared-memory load and the shift and mask
# that depend on it). The step is measured on the card in the same run
# (``k11_step``: tools/probe_table_step.cu, a chain of K11_STEPS of them)
K11_STEPS = 1 << 21
CLOCK_HZ = 1.98e9  # the H100's boost clock: tools/time_kernels.py's cycles per symbol
INFLATE_CAP = 65536  # ParDecompress(backend='device')'s IN_CAP and OUT_CAP


def host_line() -> str:
    """The host's CPU (model, vendor, family and model numbers as
    ``/proc/cpuinfo`` gives them, and the machine type) and core count:
    the thread curve is a host number."""
    info: dict[str, str] = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    cpu = ", ".join(f"{k} {info[k]}" for k in ("model name", "vendor_id", "cpu family", "model")
                    if info.get(k))
    return f"{cpu or 'no CPU model in /proc/cpuinfo'} ({platform.machine()}), {os.cpu_count()} cores"


def inflate_batch(blocks, dev):
    """BGZF members as K11's inputs on ``dev`` (``stage_blocks``: payloads
    [n, 65536] u8, in_lens and out_lens [n] int32)."""
    from gzp_tpu_torch import Bgzf
    from gzp_tpu_torch.parallel.decompress import stage_blocks

    *inputs, over = stage_blocks(Bgzf, blocks, INFLATE_CAP, INFLATE_CAP)
    assert not over, f"blocks over the caps: {sorted(over)}"
    return tuple(torch.from_numpy(x).to(dev) for x in inputs)


def k11_plain(cfg, args):
    """One call of K11's plain version on card inputs, timed with CUDA
    events. Returns (result, ms, the symbols its ok rows decoded, the
    symbols of its longest ok row)."""
    from gzp_tpu_torch.ops import inflate_kernel as ik

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = ik.inflate_blocks_plain(cfg, *args)
    stop.record()
    torch.cuda.synchronize()
    symbols = want["symbols"][want["ok"]]
    return (want, start.elapsed_time(stop), int(symbols.sum()),
            int(symbols.max()) if symbols.numel() else 0)


def k11_check(tag, cfg, args, want):
    """K11 on ``args`` against its plain version's result ``want``: ok on
    every row, out and out_count on the rows that are ok (a failed row's
    bytes are not part of the function). Returns the kernel's result."""
    from gzp_tpu_torch.ops import inflate_kernel as ik

    got = ik.inflate_blocks_cuda(cfg, *args)
    ok = want["ok"]
    err = max(max_abs_err(got["ok"], ok),
              max_abs_err((got["out"][ok], got["out_count"][ok]),
                          (want["out"][ok], want["out_count"][ok])))
    print(f"check K11 inflate {tag}: max_abs_err {err}; {int(ok.sum())} of {len(ok)} rows ok",
          flush=True)
    if err != 0:
        raise AssertionError(f"K11 disagrees with its plain version on {tag}")
    return got


def k11_step(dev) -> tuple[float, float]:
    """One table-lookup step of a serial Huffman decode on the card: builds
    ``tools/probe_table_step.cu`` into ``gzp_tpu_torch/_build`` (the package
    never loads it) and walks a chain of ``K11_STEPS`` dependent steps on a
    table of random code lengths 1-10. Returns the ms of one step (CUDA
    events around the launch, after a warm-up) and its cycles (the chain's
    clock64())."""
    import ctypes

    from gzp_tpu_torch.runtime import cuda_lib

    src = Path(__file__).resolve().parent / "tools" / "probe_table_step.cu"
    lib_path = cuda_lib.BUILD_DIR / "probe_table_step.so"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, timeout=300)
    fn = ctypes.CDLL(str(lib_path)).gzp_table_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lens = np.random.default_rng(1234).integers(1, 11, 1024, dtype=np.int64)
    tab = torch.from_numpy(lens.astype(np.int32)).to(dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # the second launch is the one kept
        start.record()
        err = fn(tab.data_ptr(), 0x9E3779B97F4A7C15, K11_STEPS, cycles.data_ptr(),
                 sink.data_ptr(), stream.cuda_stream)
        stop.record()
        if err != 0:
            raise RuntimeError(f"gzp_table_step: CUDA error {err}")
        torch.cuda.synchronize()
    return start.elapsed_time(stop) / K11_STEPS, int(cycles.item()) / K11_STEPS


def k11_row(cfg, args, plain_ms, symbols, longest, dev):
    """K11 timed on a batch of BGZF blocks (CUDA events call by call, and
    CUDA-graph replay) beside its bound, its floor (``longest`` symbols in
    one serial chain, each one table-lookup step as ``k11_step`` measures
    it) and its plain version's one call."""
    from gzp_tpu_torch.ops import inflate_kernel as ik

    streams, in_lens, out_lens = args
    b = streams.shape[0]
    ms = time_ms(lambda: ik.inflate_blocks_cuda(cfg, *args))
    replay_ms = graph_ms(lambda: ik.inflate_blocks_cuda(cfg, *args))
    step_ms, step_cycles = k11_step(dev)
    # each payload byte read once, the lengths, each output row written
    # once (the zero tail too), out_count and ok
    nbytes = int(in_lens.sum()) + 8 * b + b * cfg.out_cap + 5 * b
    nops = symbols * K11_OPS_PER_SYMBOL
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    row = {
        "name": "K11 inflate", "route": "cuda", "source": SRC + "inflate.cu",
        "replaces": "gzp_tpu/ops/inflate_kernel.py:139", "launches": None, "max_abs_err": 0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= nops / INT32_OPS_PER_S else "operations",
        "library_ms": None, "graph_ms": replay_ms, "floor_ms": longest * step_ms,
    }
    clock_hz = step_cycles / (step_ms * 1e-3)
    print(f"kernel K11 inflate: {b} blocks, {int(out_lens.sum())} B out, {symbols} symbols "
          f"({longest} in the longest row): {ms:.4f} ms (graph {replay_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms one call, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
          f"{nbytes} bytes, {nops} ops at {K11_OPS_PER_SYMBOL} per symbol; floor "
          f"{row['floor_ms']:.4f} ms = the longest row's symbols at one table-lookup step, "
          f"measured {step_ms * 1e6:.3f} ns = {step_cycles:.1f} cycles at "
          f"{clock_hz / 1e9:.3f} GHz; {ms * 1e-3 * clock_hz / longest:.1f} cycles per symbol)",
          flush=True)
    return row


def read_split(blocks, cfg, dev, reps: int = 3) -> dict[str, float]:
    """One batch of the device read split into its steps, as
    ``_DeviceBatch`` takes them (``parallel/decompress.py``), each timed on
    the host's clock up to a ``torch.cuda.synchronize()``: the footers and
    ``stage_blocks``, the host-to-device copies, K11, ``crc32_device``, the
    ``.cpu()`` copies, and the per-block check and join. Returns the median
    ms of each over ``reps`` runs after a warm-up."""
    from gzp_tpu_torch import Bgzf
    from gzp_tpu_torch.ops import inflate_kernel as ik
    from gzp_tpu_torch.parallel.decompress import stage_blocks

    want = b"".join(zlib.decompress(blk[18: len(blk) - 8], -15) for blk in blocks)
    runs: list[dict[str, float]] = []
    for _ in range(reps + 1):
        ms: dict[str, float] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ms[name] = (t1 - t0) * 1e3
            t0 = t1

        footers = [Bgzf.get_footer_values(blk) for blk in blocks]
        *inputs, over = stage_blocks(Bgzf, blocks, cfg.in_cap, cfg.out_cap)
        lap("stage_blocks")
        args = tuple(torch.from_numpy(x).to(dev) for x in inputs)
        lap("host_to_device")
        res = ik.inflate_blocks(cfg, *args)
        lap("K11")
        crc = ik.crc32_device(res["out"], args[2])
        lap("crc32_device")
        out, ok, crc = res["out"].cpu().numpy(), res["ok"].cpu().numpy(), crc.cpu().numpy()
        lap("device_to_host")
        pieces = []
        for i, fv in enumerate(footers):
            if i in over or not ok[i] or int(crc[i]) != fv.sum:
                raise AssertionError(f"block {i} of the split batch did not decode on the card")
            pieces.append(out[i, : fv.amount].tobytes())
        joined = b"".join(pieces)
        lap("check_and_join")
        if joined != want:
            raise AssertionError("the split batch does not restore its blocks")
        runs.append(ms)
    return {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[0]}


def read_paths(dev, corpus, mgzip3, gzip3, snappy, small, smi, host):
    """The read side on the card's streams: K11 held against its plain
    version (the case batch, 16 and 64 BGZF blocks) and against the host
    codec on every block of a 256 MiB BGZF level-6 stream written on the
    card; that stream and the Mgzip level-3 path's read by the native
    ParDecompress at 1-N threads (read(-1) and 1 MiB reads: the thread
    curve); the BGZF stream through backend='device' (every count set to 0
    just before, read just after; no block may go to the host codec) and
    the Mgzip stream through it (every 128 KiB block over the caps: all to
    the host codec, as gzp_tpu routes them); the Gzip level-3 path's
    output through MultiGzDecoder and the Snappy path's through
    SnappyFrameDecoder. Returns K11's kernels row."""
    from concurrent.futures import ThreadPoolExecutor

    from gzp_tpu_torch import Bgzf, Mgzip, MultiGzDecoder, ParDecompress, ZBuilder
    from gzp_tpu_torch.formats.snap import SnappyFrameDecoder
    from gzp_tpu_torch.ops import inflate_kernel as ik
    from gzp_tpu_torch.runtime import cuda_lib, get_native
    from gzp_tpu_torch.utils.inflate_cases import inflate_case_batch

    cfg = ik.InflateConfig(INFLATE_CAP, INFLATE_CAP)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    w = ZBuilder(Bgzf).num_threads(B).compression_level(6).device(dev).from_writer(buf)
    w.write(corpus)
    w.finish()
    torch.cuda.synchronize()
    bgzf = buf.getvalue()
    blocks = members(bgzf, "Bgzf")
    print(f"read: BGZF level 6 written on the card, {len(corpus)} B -> {len(bgzf)} B, "
          f"{len(blocks)} blocks, {time.perf_counter() - t0:.1f} s", flush=True)

    c = inflate_case_batch(INFLATE_CAP, INFLATE_CAP, rows=40)
    args = tuple(torch.from_numpy(c[k]).to(dev) for k in ("streams", "in_lens", "out_lens"))
    got = k11_check("case batch", cfg, args, k11_plain(cfg, args)[0])
    if not np.array_equal(got["ok"].cpu().numpy(), c["expect_ok"]):
        raise AssertionError("K11's ok differs from the case batch's expected rules")
    # one plain call on the 64-block batch serves the 16-block check too:
    # its rows are independent, so its first 16 are the plain version's
    # result on the first 16 blocks
    args = inflate_batch(blocks[:B], dev)
    want, plain_ms, symbols, longest = k11_plain(cfg, args)
    print(f"  K11's plain version on {B} BGZF blocks: {symbols} symbols", flush=True)
    k11_check("16 BGZF blocks", cfg, inflate_batch(blocks[:16], dev),
              {k: v[:16] for k, v in want.items()})
    k11_check(f"{B} BGZF blocks", cfg, args, want)
    row = k11_row(cfg, args, plain_ms, symbols, longest, dev)

    # K11 (with the device CRC) against the host codec on every block
    t0 = time.perf_counter()
    native = get_native()
    run = ik.get_inflater(cfg)

    def host_inflate(blk):
        n = int.from_bytes(blk[-4:], "little")
        return native.inflate(blk[18: len(blk) - 8], n) if n else b""

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for s in range(0, len(blocks), 1024):
            part = blocks[s: s + 1024]
            res = run(*inflate_batch(part, dev))
            out, ok, crc = (res[k].cpu().numpy() for k in ("out", "ok", "crc"))
            for i, plain in enumerate(pool.map(host_inflate, part)):
                blk = part[i]
                if not (ok[i] and out[i, : len(plain)].tobytes() == plain
                        and int(crc[i]) == int.from_bytes(blk[-8:-4], "little")):
                    raise AssertionError(f"K11 differs from the host codec on block {s + i}")
    print(f"check K11 against the host codec on all {len(blocks)} BGZF blocks: equal bytes, "
          f"every CRC matches its footer ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the native thread curve (a host number)
    curve = {}
    for name, fmt, blob in (("BGZF level 6", Bgzf, bgzf), ("Mgzip level 3", Mgzip, mgzip3)):
        for nt in sorted({1, 2, 4, 8, 16, os.cpu_count()}):
            t0 = time.perf_counter()
            r = ParDecompress(fmt, io.BytesIO(blob), num_threads=nt)
            whole = r.read()
            r.close()
            t_all = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = ParDecompress(fmt, io.BytesIO(blob), num_threads=nt)
            parts = []
            while piece := r.read(1 << 20):
                parts.append(piece)
            r.close()
            t_1m = time.perf_counter() - t0
            if whole != corpus or b"".join(parts) != corpus:
                raise AssertionError(f"{name} at {nt} threads does not restore the input")
            curve[f"{name}, {nt} threads"] = [len(corpus) / t_all / 1e9, len(corpus) / t_1m / 1e9]
            print(f"read {name} native, {nt} threads: read(-1) {curve[f'{name}, {nt} threads'][0]:.4f}"
                  f" GB/s, 1 MiB reads {curve[f'{name}, {nt} threads'][1]:.4f} GB/s", flush=True)
    print(f"read thread curve (GB/s of output: read(-1), 1 MiB reads) on {host}: "
          + json.dumps(curve), flush=True)

    # the device backend: the main read path of K11
    for k in cuda_lib.counts():
        k.launches = 0
    t0 = time.perf_counter()
    r = ParDecompress(Bgzf, io.BytesIO(bgzf), num_threads=B, backend="device", device=dev)
    whole = r.read()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    row["launches"] = ik.INFLATE.launches
    stats = dict(r.fallback_stats)
    r.close()
    print(f"read BGZF level 6 backend='device', {B} threads: launches "
          f"{json.dumps({k.name: k.launches for k in cuda_lib.counts()})}; fallback_stats "
          f"{json.dumps(stats)}; {secs:.3f} s = {len(corpus) / secs / 1e9:.4f} GB/s on {smi}",
          flush=True)
    if whole != corpus:
        raise AssertionError("backend='device' does not restore the BGZF stream")
    if row["launches"] <= 0 or stats["native"] != 0 or stats["device"] != len(blocks):
        raise AssertionError(f"backend='device' did not decode every block on the card: {stats}")
    split = read_split(blocks[:B], cfg, dev)
    print(f"read BGZF device batch split ({B} blocks, ms, median of 3, host clock to a "
          f"synchronize after each step): {json.dumps(split)}; sum {sum(split.values()):.3f} ms "
          f"against {secs / row['launches'] * 1e3:.3f} ms of the read's wall time per batch",
          flush=True)
    ik.INFLATE.launches = 0
    t0 = time.perf_counter()
    r = ParDecompress(Mgzip, io.BytesIO(mgzip3), num_threads=B, backend="device", device=dev)
    whole = r.read()
    secs = time.perf_counter() - t0
    stats = dict(r.fallback_stats)
    r.close()
    if whole != corpus or stats["device"] != 0 or stats["native"] != len(members(mgzip3)):
        raise AssertionError(f"backend='device' on Mgzip 128 KiB blocks: {stats}")
    if ik.INFLATE.launches:
        raise AssertionError("K11 launched on batches that are wholly over the caps")
    print(f"read Mgzip level 3 backend='device': fallback_stats {json.dumps(stats)} (every 128 "
          f"KiB block over OUT_CAP {INFLATE_CAP}, routed to the host codec as gzp_tpu routes "
          f"it; K11 launches 0); {len(corpus) / secs / 1e9:.4f} GB/s", flush=True)

    t0 = time.perf_counter()
    if MultiGzDecoder(io.BytesIO(gzip3)).read() != corpus:
        raise AssertionError("MultiGzDecoder does not restore the Gzip level-3 path's stream")
    secs = time.perf_counter() - t0
    print(f"read Gzip level 3 (with its flush) through MultiGzDecoder: restored, "
          f"{len(corpus) / secs / 1e9:.4f} GB/s", flush=True)
    t0 = time.perf_counter()
    if SnappyFrameDecoder(io.BytesIO(snappy)).read() != small:
        raise AssertionError("SnappyFrameDecoder does not restore the Snappy path's stream")
    secs = time.perf_counter() - t0
    print(f"read Snappy through SnappyFrameDecoder: restored, {len(small) / secs / 1e9:.4f} GB/s",
          flush=True)
    return row


EXAMPLES = Path(__file__).resolve().parent / "examples"
EXAMPLE_BYTES = 64 << 20  # each example's input through the shell
EXAMPLE_LAUNCH_BYTES = 8 << 20  # each example's in-process call, for its launches
EXAMPLE_TIMEOUT = 300  # seconds for each example process


class _Stdio:
    """A stand-in for sys.stdin / sys.stdout: the examples read and write
    ``.buffer``."""

    def __init__(self, data: bytes = b"") -> None:
        self.buffer = io.BytesIO(data)


def example_in_process(name, argv, data):
    """``examples/<name>.py``'s ``main(argv)`` in this process, reading
    ``data``, with every count set to 0 just before and read just after.
    Returns (what it wrote, {kernel name: launches})."""
    from gzp_tpu_torch.runtime import cuda_lib

    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, saved = _Stdio(), (sys.stdin, sys.stdout)
    torch.cuda.synchronize()
    for k in cuda_lib.counts():
        k.launches = 0
    sys.stdin, sys.stdout = _Stdio(data), out
    try:
        mod.main(argv)
    finally:
        sys.stdin, sys.stdout = saved
    torch.cuda.synchronize()
    return out.buffer.getvalue(), {k.name: k.launches for k in cuda_lib.counts()}


def example_process(name, argv, stdin: Path, stdout: Path) -> float:
    """``examples/<name>.py`` in a process of its own, stdin from and stdout
    to files. A non-zero exit or EXAMPLE_TIMEOUT fails the run (the
    process is killed). Returns the wall seconds, process start included."""
    t0 = time.perf_counter()
    with open(stdin, "rb") as fi, open(stdout, "wb") as fo:
        p = subprocess.Popen([sys.executable, str(EXAMPLES / f"{name}.py"), *argv], stdin=fi,
                             stdout=fo, stderr=subprocess.PIPE, cwd=EXAMPLES.parent)
        try:
            _, err = p.communicate(timeout=EXAMPLE_TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"{name} {' '.join(argv)} exited with {p.returncode}:\n"
                             f"{err.decode(errors='replace')}")
    return secs


def examples_phase(corpus, smi):
    """The shell entry points (module docstring, phase 4's end): each
    compressor's output against an in-process ``ZBuilder`` card run and
    its decoder, each decoder's output against the input, and each
    example's launches from an in-process call on 8 MiB."""
    import tempfile

    from gzp_tpu_torch import Bgzf, Gzip, Snap, ZBuilder
    from gzp_tpu_torch.formats.snap import SnappyFrameDecoder
    from gzp_tpu_torch.ops import inflate_kernel as ik
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda

    def snappy_decode(blob):
        return SnappyFrameDecoder(io.BytesIO(blob)).read()

    def zbuilder_sha(fmt, level, blob):
        buf = io.BytesIO()
        w = ZBuilder(fmt).num_threads(B).compression_level(level).device("cuda:0").from_writer(buf)
        for i in range(0, len(blob), 1 << 20):
            w.write(blob[i: i + (1 << 20)])
        w.finish()
        return hashlib.sha256(buf.getvalue()).hexdigest()

    # what each example's wall time holds before any work: a fresh
    # interpreter importing the package, then also making a CUDA context
    start = {}
    for what, code in (("import", "import gzp_tpu_torch"),
                       ("import + CUDA context", "import gzp_tpu_torch, torch; "
                        "torch.zeros(1, device='cuda:0'); torch.cuda.synchronize()")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=EXAMPLES.parent, check=True,
                       timeout=EXAMPLE_TIMEOUT)
        start[what] = time.perf_counter() - t0
    print(f"example process start: {json.dumps(start)} s", flush=True)

    data, small = corpus[:EXAMPLE_BYTES], corpus[:EXAMPLE_LAUNCH_BYTES]
    hash_path = [lz_cuda.BUILD_KEYS, lz_cuda.NEIGHBOR, lz_cuda.MATCH_TAIL, pack_cuda.PACK_PRESCAN]
    threads = ["--threads", str(B)]
    # (name, pigz_clone_torch's flags, format, level, decoder, kernels of its path)
    compressors = [
        ("gzip", [], Gzip, 3, gzip.decompress, hash_path),
        ("bgzf", ["--format", "bgzf", "--level", "6"], Bgzf, 6, gzip.decompress,
         [lz_cuda.BUILD_SUFFIX_KEYS, lz_cuda.LCP_LAGS, lz_cuda.SUFFIX_MERGE, lz_cuda.BUILD_KEYS,
          lz_cuda.HASH_MERGE, lz_cuda.MATCH_TAIL2, pack_cuda.PACK_PRESCAN]),
        ("snappy", ["--format", "snappy"], Snap, 3, snappy_decode, hash_path),
    ]
    torch.cuda.empty_cache()  # each example process holds a CUDA context of its own
    launched: set[str] = set()
    with tempfile.TemporaryDirectory() as tmp:
        inp = Path(tmp) / "input.bin"
        inp.write_bytes(data)
        outs, smalls = {}, {}
        for name, flags, fmt, level, decode, kernels in compressors:
            argv = [*flags, *threads]
            outs[name] = Path(tmp) / f"out.{name}"
            secs = example_process("pigz_clone_torch", argv, inp, outs[name])
            blob = outs[name].read_bytes()
            if hashlib.sha256(blob).hexdigest() != zbuilder_sha(fmt, level, data):
                raise AssertionError(f"pigz_clone_torch {' '.join(argv)}: its output differs "
                                     "from an in-process ZBuilder run on the card")
            if decode(blob) != data:
                raise AssertionError(f"pigz_clone_torch {' '.join(argv)}: not restored by its "
                                     "decoder")
            smalls[name], launches = example_in_process("pigz_clone_torch", argv, small)
            missing = [k.name for k in kernels if launches[k.name] <= 0]
            if missing or decode(smalls[name]) != small:
                raise AssertionError(f"pigz_clone_torch {' '.join(argv)} in process: kernels "
                                     f"never launched {missing}, or its output not restored")
            launched.update(k for k, n in launches.items() if n > 0)
            print(f"example pigz_clone_torch.py {' '.join(argv)}: {len(data)} B -> {len(blob)} B, "
                  f"sha256 equal to the in-process ZBuilder run, restored; {secs:.3f} s with "
                  f"process start = {len(data) / secs / 1e9:.4f} GB/s of input; launches on "
                  f"{len(small)} B in process {json.dumps(launches)}; on {smi}", flush=True)
        # (example, flags, input, kernels it must launch: none for the host decoders)
        decoders = [
            ("block_decompress_torch", ["--format", "bgzf", *threads, "--backend", "device"],
             "bgzf", [ik.INFLATE]),
            ("block_decompress_torch", ["--format", "bgzf", *threads], "bgzf", []),
            ("snap_decode_torch", [], "snappy", []),
        ]
        for name, argv, src, kernels in decoders:
            cmd = " ".join([f"{name}.py", *argv])
            restored = Path(tmp) / "restored"
            secs = example_process(name, argv, outs[src], restored)
            if restored.read_bytes() != data:
                raise AssertionError(f"{cmd}: does not write the input")
            got, launches = example_in_process(name, argv, smalls[src])
            want = {k.name for k in kernels}
            wrong = {k: n for k, n in launches.items() if (n > 0) != (k in want)}
            if got != small or wrong:
                raise AssertionError(f"{cmd} in process: output restored "
                                     f"{got == small}, launches not as expected {wrong}")
            launched.update(want)
            print(f"example {cmd}: {outs[src].stat().st_size} B -> "
                  f"{len(data)} B, equal to the input; {secs:.3f} s with process start = "
                  f"{len(data) / secs / 1e9:.4f} GB/s of output; launches on the {len(small)} B "
                  f"stream in process {json.dumps(launches)}; on {smi}", flush=True)
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gzp_tpu_torch.ops import inflate_kernel, lz_cuda, pack_cuda  # noqa: F401 (registers K11)
    from gzp_tpu_torch.runtime import cuda_lib

    # ---- 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    host = host_line()
    print(f"host: {host}")
    print(smi, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    logs = cuda_lib.build(force=True, ptxas_verbose=True)
    BUILD_LOGS.update(logs)
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")
    sys.stdout.flush()
    if len(logs) != len(cuda_lib.registered()):
        raise AssertionError(f"built {sorted(logs)}, expected {len(cuda_lib.registered())}")

    # ---- 3. kernels at the main paths' shapes
    dev = torch.device("cuda", 0)
    text = np.frombuffer(make_corpus(B * N), np.uint8).reshape(B, N).copy()
    text[1] = 0
    text[2] = np.random.default_rng(7).integers(0, 256, N, dtype=np.uint8)
    data = torch.from_numpy(text).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows = level3_kernels(data, lengths, halo)
    rows.update(level6_kernels(data, lengths, halo))
    tail_edges(dev)
    stream_checks(text, dev)

    # ---- 4. the main paths: ZBuilder(Mgzip) at levels 3 and 6 on the card
    t0 = time.perf_counter()
    corpus = make_corpus(PATH_BYTES)
    print(f"path: {len(corpus)} bytes of corpus made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    hash_kernels = [lz_cuda.BUILD_KEYS, lz_cuda.NEIGHBOR, lz_cuda.MATCH_TAIL,
                    pack_cuda.PACK_PRESCAN]
    l3, mgzip3, secs3 = drive(3, corpus, hash_kernels, smi)
    suffix_kernels = [lz_cuda.BUILD_KEYS, lz_cuda.LCP_LAGS, lz_cuda.HASH_MERGE,
                      lz_cuda.BUILD_SUFFIX_KEYS, lz_cuda.SUFFIX_MERGE, lz_cuda.MATCH_TAIL2,
                      pack_cuda.PACK_PRESCAN]
    l6, mgzip6, secs6 = drive(6, corpus, suffix_kernels, smi)
    sha6 = hashlib.sha256(mgzip6).hexdigest()
    del mgzip6

    # each row's launches on the path that runs its function: level 3 for
    # K1, K2, K6, K10; level 6 for K4, K5, K7, K8, K9. K3's function is
    # neighbor.cu at lags > 2 (counted apart, and taken off K2's count):
    # both paths' runs, since neither level runs it
    loop = lz_cuda.NEIGHBOR_LOOP.name
    for kid, kernel, path in (
        ("K1", lz_cuda.BUILD_KEYS, l3), ("K6", lz_cuda.MATCH_TAIL, l3),
        ("K10", pack_cuda.PACK_PRESCAN, l3),
        ("K4", lz_cuda.LCP_LAGS, l6), ("K5", lz_cuda.HASH_MERGE, l6),
        ("K7", lz_cuda.BUILD_SUFFIX_KEYS, l6), ("K8", lz_cuda.SUFFIX_MERGE, l6),
        ("K9", lz_cuda.MATCH_TAIL2, l6),
    ):
        rows[kid]["launches"] = path[kernel.name]
    rows["K2"]["launches"] = l3[lz_cuda.NEIGHBOR.name] - l3[loop]
    rows["K3"]["launches"] = l3[loop] + l6[loop]

    # ---- 4, continued: the mesh path, each level's batches split over two
    # devices, against the one-device streams above
    drive_mesh(3, corpus, hash_kernels, smi, hashlib.sha256(mgzip3).hexdigest(), secs3)
    drive_mesh(6, corpus, suffix_kernels, smi, sha6, secs6)

    # ---- 4, continued: the stream paths and Snappy through ZBuilder
    from gzp_tpu_torch import Gzip, RawDeflate, Snap, Zlib

    small = corpus[:STREAM_PATH_BYTES]
    _, gzip3 = drive_stream("Gzip level 3", Gzip, 3, corpus, hash_kernels, smi, 31,
                            flush_at=(100 << 20) + 12345)
    drive_stream("Gzip level 6", Gzip, 6, corpus, suffix_kernels, smi, 31)
    drive_stream("Zlib level 3", Zlib, 3, small, hash_kernels, smi, 15)
    drive_stream("raw Deflate level 3", RawDeflate, 3, small, hash_kernels, smi, -15)
    _, snappy = drive_stream("Snappy", Snap, 0, small, hash_kernels, smi, None)

    # ---- 4, continued: two worker processes, one Gzip stream stitched from
    # their shards; then the multi-device dry run
    drive_multihost(small, smi)
    from gzp_tpu_torch.parallel.mesh import dryrun_multichip

    dryrun_multichip(2)

    # ---- 4, continued: the read paths (K11, the native thread curve, the
    # device backend, MultiGzDecoder, SnappyFrameDecoder)
    t0 = time.perf_counter()
    rows["K11"] = read_paths(dev, corpus, mgzip3, gzip3, snappy, small, smi, host)
    print(f"read paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4, continued: the shell entry points (examples/*_torch.py)
    t0 = time.perf_counter()
    launched = examples_phase(corpus, smi)
    want = {k.name for k in cuda_lib.registered()}
    if want - launched:
        raise AssertionError(f"examples: kernels never launched {sorted(want - launched)}")
    print(f"examples: {time.perf_counter() - t0:.1f} s; all {len(want)} kernel libraries launched "
          "from the shell entry points (K3's function is on no path)", flush=True)

    # ---- 5. result
    order = ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11"]
    print(json.dumps({"kernels": [rows[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
