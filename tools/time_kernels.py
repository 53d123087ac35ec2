#!/usr/bin/env python3
"""Time this package's redesigned kernels of one checkout of gzp_tpu_torch on a card.

    python3 tools/time_kernels.py [--root DIR] [--kernels K2,K3,K6,K9,K10,K4,K2pw7,K8,K11] \
        [--tiles 2048,4096,8192] [--iters 20]

Imports ``gzp_tpu_torch`` from ``--root`` (default: this repository), so
two checkouts can be compared in one call on one card (parent, change,
change, parent). Makes the main paths' inputs at 64 blocks of 128 KiB of
bench text (``chip_smoke.make_corpus``, seed 1234) with that checkout's
own code: level 3's hash-sorted keys and payloads for the sorted-neighbour
kernel K2 at lags 2 and K3's function (the same kernel) at lags 4, its
position-order candidates for the tail K6 and its bit entries for the pack
pre-scan K10; level 6's two candidate fields for the tail K9, its
content-sorted words for K4 big-endian at lag 1 and its hash-sorted
payloads for K4 little-endian at lags 1-2 (one call each), and its
content-sorted positions and adjacent LCPs for the suffix merge K8 at lags
16 (levels 6-8) and 24 (level 9's lags), and at lags 16 as one row of 2^23
slots (past 2^22 slots K8 takes int32 keys, not fp32). ``K2pw7`` times
``csrc/neighbor.cu`` launched directly on level 6's hash-sorted keys and 7
payload words at lags 2 beside the route ``neighbor_cuda`` takes there (K4
+ K5), both held against ``neighbor_plain``. ``K11`` writes 64 BGZF
level-6 blocks of the same text (65,280 B each, about 4 MiB) with that
checkout's ``ZBuilder(Bgzf)`` on the card, stages them with its
``stage_blocks`` (the device read's [64, 65536] batch) and holds the
inflate kernel against ``inflate_blocks_plain`` (``ok`` on every row, all
of them ok; ``out`` and ``out_count`` where ok), then prints the Huffman
symbols the plain version counted (in all, and in the longest row) and
the kernel's cycles per symbol of the longest row at 1.98 GHz.
Holds each kernel against its plain version (exact), then times it: ``ms``
is CUDA events around back-to-back wrapper calls (``chip_smoke.time_ms``,
the ``ms`` of ``chip_smoke.py``'s kernels line), ``graph_ms`` device time
per call from CUDA-graph replay (``chip_smoke.graph_ms``: the host's launch
overhead left out); and reads the device memory one call allocates beyond
its inputs and outputs (peak minus the outputs). With ``--tiles`` it times
K6 and K9 at each tile size ``lz_cuda.TAIL_TILE`` takes in that checkout
(K2's, K10's and K4's tiles are fixed in their sources). ``--ptxas`` prints the
compiler's registers, spills and shared memory per function first.
Prints one JSON line. Exits non-zero without a card or on a mismatch.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
B, N = 64, 131072
TAIL_KW = dict(base=0, max_match=258, min_emit=3, lazy=True)


def smoke_module():
    """This repository's ``chip_smoke`` (corpus and timing helpers), not a
    checkout's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def batch(dev):
    """The main paths' batch: 64 blocks of 128 KiB of bench text, block 1
    all zero, block 2 random -> (data, lengths, halo)."""
    text = np.frombuffer(smoke_module().make_corpus(B * N), np.uint8).reshape(B, N).copy()
    text[1] = 0
    text[2] = np.random.default_rng(7).integers(0, 256, N, dtype=np.uint8)
    data = torch.from_numpy(text).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    return data, lengths, halo


def level3_entries(data, lengths, halo):
    """K10's inputs on level 3's path: (bits, nbits, base_bits), and the
    hash pass's candidates K6 takes."""
    from gzp_tpu_torch.ops import deflate_kernel as dk
    from gzp_tpu_torch.ops import lz_cuda

    packed3 = lz_cuda.hash_pass(data, halo, payload_words=3, lags=2, max_dist=32768)
    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    ml, md = lz_cuda.match_tail_cuda(data, packed3, lengths, halo, payload_bytes=12,
                                     **TAIL_KW)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    bits, nbits = dk.block_entries(cfg, data, marked, ln, md)
    return (bits.to(torch.int32).contiguous(), nbits.to(torch.int32).contiguous(),
            8 * cfg.header_len), packed3


def hash_sorted(data, pos_bits, pw):
    """K1's keys and ``pw`` payload words in hash order, as ``hash_pass``
    makes them -> (sk [B, Np] int64, payloads [pw, B, Np] int32)."""
    from gzp_tpu_torch.ops import lz_cuda

    key, pays = lz_cuda.build_keys_cuda(data, pos_bits=pos_bits, payload_words=pw)
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    return sk, torch.gather(pays, 2, order.expand(pw, -1, -1)).contiguous()


def neighbor_launch(sk, pays, halo_start, *, pos_bits, lags, max_dist):
    """``csrc/neighbor.cu`` at any word count (``neighbor_cuda`` routes more
    than 3 words to K4 + K5): one launch, outputs as ``neighbor_plain``."""
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.runtime.cuda_lib import ptr, stream_of

    b, npad = sk.shape
    sp = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    packed = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    lz_cuda.NEIGHBOR.launch(
        sk.device, ptr(sk.data_ptr()), ptr(pays.data_ptr()), ptr(halo_start.data_ptr()),
        ptr(sp.data_ptr()), ptr(packed.data_ptr()), b, npad, pos_bits, pays.shape[0], lags,
        max_dist, stream_of(sk))
    return sp, packed


K11_BLOCK = 65280  # a full BGZF member's input


def k11_batch(smoke, dev):
    """64 BGZF level-6 blocks of bench text written on the card by this
    checkout's ``ZBuilder(Bgzf)`` and staged by its ``stage_blocks`` ->
    (streams, in_lens, out_lens) on ``dev``."""
    from gzp_tpu_torch import Bgzf, ZBuilder
    from gzp_tpu_torch.parallel.decompress import stage_blocks

    buf = io.BytesIO()
    w = ZBuilder(Bgzf).num_threads(B).compression_level(6).device(dev).from_writer(buf)
    w.write(smoke.make_corpus(B * K11_BLOCK))
    w.finish()
    blocks = smoke.members(buf.getvalue(), "Bgzf")[:B]  # the empty EOF member left out
    *inputs, over = stage_blocks(Bgzf, blocks, 65536, 65536)
    assert not over and len(blocks) == B, (len(blocks), over)
    return tuple(torch.from_numpy(x).to(dev) for x in inputs)


def k11_row(smoke, dev, iters):
    """K11 on the device read's batch: held against its plain version,
    then timed (``ms``, ``graph_ms``) beside the symbols it decodes."""
    from gzp_tpu_torch.ops import inflate_kernel as ik

    args = k11_batch(smoke, dev)
    cfg = ik.InflateConfig(65536, 65536)
    got = ik.inflate_blocks_cuda(cfg, *args)
    want = ik.inflate_blocks_plain(cfg, *args)
    ok = want["ok"]
    if not (bool(ok.all()) and torch.equal(got["ok"], ok) and torch.equal(got["out"], want["out"])
            and torch.equal(got["out_count"], want["out_count"])):
        raise AssertionError("K11 disagrees with its plain version on the BGZF batch")
    symbols = want["symbols"]
    ms = smoke.time_ms(lambda: ik.inflate_blocks_cuda(cfg, *args), iters=iters, warmup=3)
    replay_ms = smoke.graph_ms(lambda: ik.inflate_blocks_cuda(cfg, *args), iters=iters)
    longest = int(symbols.max())
    return {"ms": ms, "graph_ms": replay_ms, "symbols": int(symbols.sum()),
            "symbols_longest_row": longest, "out_bytes": int(args[2].sum()),
            "cycles_per_symbol": ms * 1e-3 * smoke.CLOCK_HZ / longest}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kernels", default="K2,K3,K6,K9,K10,K4")
    ap.add_argument("--tiles", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true",
                    help="rebuild and print registers, spills and shared memory per function")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from gzp_tpu_torch.ops import inflate_kernel, lz_cuda, pack_cuda  # noqa: F401 (registers K11)
    from gzp_tpu_torch.ops.lz import _pos_bits
    from gzp_tpu_torch.runtime import cuda_lib

    if Path(lz_cuda.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {lz_cuda.__file__}, not from {root}")
    smoke = smoke_module()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cuda_lib.build()
    if args.ptxas:
        libs = [k for k in cuda_lib.registered()
                if k.name in ("neighbor", "match_tail", "match_tail2", "pack_prescan",
                              "lcp_lags", "suffix_merge", "inflate")]
        for name, log in cuda_lib.build(libs, force=True, ptxas_verbose=True).items():
            for line in log.splitlines():
                if "Compiling entry" in line or "Used" in line or "spill" in line:
                    print(f"  {name}: {line.strip()[-150:]}", flush=True)
    data, lengths, halo = batch(torch.device("cuda", 0))
    wanted = [k for k in args.kernels.split(",") if k]
    cases = {}  # name: (kernel, plain, args, kwargs, takes lz_cuda.TAIL_TILE)
    pos_bits = _pos_bits(N)
    if {"K2", "K3"} & set(wanted):
        sk, spays = hash_sorted(data, pos_bits, 3)
        for kid, lags in (("K2", 2), ("K3", 4)):
            cases[kid] = (lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain, (sk, spays, halo),
                          dict(pos_bits=pos_bits, lags=lags, max_dist=32768), False)
    if "K2pw7" in wanted:
        sk7, spays7 = hash_sorted(data, pos_bits, 7)
        kw = dict(pos_bits=pos_bits, lags=2, max_dist=32768)
        cases["K2pw7 neighbor.cu"] = (neighbor_launch, lz_cuda.neighbor_plain,
                                      (sk7, spays7, halo), kw, False)
        cases["K2pw7 K4+K5 route"] = (lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain,
                                      (sk7, spays7, halo), kw, False)
    if {"K6", "K10"} & set(wanted):
        pack_args, packed3 = level3_entries(data, lengths, halo)
        cases["K6"] = (lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
                       (data, packed3, lengths, halo), dict(TAIL_KW, payload_bytes=12), True)
        cases["K10"] = (pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain, pack_args,
                        {}, False)
    if "K9" in wanted:
        packed_s = lz_cuda.suffix_pass(data, halo, payload_words=7, lags=16, suffix_keys=5,
                                       max_dist=32768)
        packed_h = lz_cuda.hash_pass(data, halo, payload_words=7, lags=2, max_dist=32768)
        cases["K9"] = (lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain,
                       (data, packed_h, packed_s, lengths, halo), dict(TAIL_KW, payload_bytes=28),
                       True)
    if "K4" in wanted:
        keys, pos = lz_cuda.build_suffix_keys_cuda(data, payload_words=7)
        order = lz_cuda.suffix_order(keys, pos, 5)
        skeys = torch.gather(keys, 2, order.expand(7, -1, -1))
        _, spays = hash_sorted(data, pos_bits, 7)
        cases["K4 be lag 1"] = (lz_cuda.lcp_lags_cuda, lz_cuda.lcp_lags_plain, (skeys, 1),
                                dict(big_endian=True), False)
        cases["K4 le lags 1-2"] = (lz_cuda.lcp_lags_cuda, lz_cuda.lcp_lags_plain, (spays, 2),
                                   dict(big_endian=False), False)
    if "K8" in wanted:
        keys, pos = lz_cuda.build_suffix_keys_cuda(data, payload_words=7)
        order = lz_cuda.suffix_order(keys, pos, 5)
        skeys = torch.gather(keys, 2, order.expand(7, -1, -1))
        adj = lz_cuda.lcp_lags_cuda(skeys, 1, big_endian=True)[0]
        merge_args = (torch.gather(pos, 1, order), adj, halo)
        for lags in (16, 24):
            kw = dict(lags=lags, max_dist=32768, payload_bytes=28)
            cases[f"K8 lags {lags}"] = (lz_cuda.suffix_merge_cuda, lz_cuda.suffix_merge_plain,
                                        merge_args, kw, False)
        # the 64 rows as one: positions stay in their block, distances with them
        one_row = (merge_args[0].reshape(1, -1), adj.reshape(1, -1), halo[:1])
        cases["K8 lags 16, one row of 2^23"] = (
            lz_cuda.suffix_merge_cuda, lz_cuda.suffix_merge_plain, one_row,
            dict(lags=16, max_dist=32768, payload_bytes=28), False)
    tiles = [int(t) for t in args.tiles.split(",") if t]
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi}
    default_tile = getattr(lz_cuda, "TAIL_TILE", None)
    for name, (kernel, plain, kargs, kw, tiled) in cases.items():
        if name.split()[0] not in wanted:
            continue
        sizes = tiles if tiles and tiled and default_tile is not None else [None]
        row = {}
        for tile in sizes:
            if tile is not None:
                lz_cuda.TAIL_TILE = tile
            got = kernel(*kargs, **kw)
            want = plain(*kargs, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} at tile {tile} disagrees with its plain version")
            out_bytes = sum(g.numel() * g.element_size() for g in got)
            del got, want
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernel(*kargs, **kw)
            torch.cuda.synchronize()
            scratch = torch.cuda.max_memory_allocated() - base - out_bytes
            ms = smoke.time_ms(lambda: kernel(*kargs, **kw), iters=args.iters, warmup=3)
            replay_ms = smoke.graph_ms(lambda: kernel(*kargs, **kw), iters=args.iters)
            row[str(tile or "default")] = {"ms": ms, "graph_ms": replay_ms,
                                           "scratch_bytes": scratch}
        if default_tile is not None:
            lz_cuda.TAIL_TILE = default_tile
        out[name] = row
    if "K11" in wanted:
        out["K11"] = k11_row(smoke, torch.device("cuda", 0), args.iters)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
